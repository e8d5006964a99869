"""Shared scheduler math: beta schedules, zero-terminal-SNR rescale, forward
diffusion (``add_noise``), velocity targets and per-timestep SNRs.

Port of ``stable_diffusion_training_tpu/diffusion/common.py`` in PyTorch.
The tables are f32 like the JAX package's; they differ from it by a few ulps
where XLA orders the same arithmetic differently (its CPU ``cumprod`` is a
blocked tree of partial products, and it rewrites ``linspace``'s division as
a multiply by the reciprocal). The tests state the bounds.
"""

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Union

import numpy as np
import torch


def betas_for_alpha_bar(
    num_diffusion_timesteps: int, max_beta: float = 0.999, dtype=torch.float32
) -> torch.Tensor:
    """Glide/squaredcos_cap_v2 cosine beta schedule, computed in float64 on
    the host, then cast."""
    n = num_diffusion_timesteps
    t1 = np.arange(n, dtype=np.float64) / n
    t2 = np.arange(1, n + 1, dtype=np.float64) / n

    def alpha_bar(t):
        return np.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    betas = np.minimum(1.0 - alpha_bar(t2) / alpha_bar(t1), max_beta)
    return torch.tensor(betas, dtype=dtype)


def rescale_zero_terminal_snr(betas: torch.Tensor) -> torch.Tensor:
    """Rescale a beta schedule so the terminal timestep has exactly zero SNR
    (Algorithm 1 of arXiv 2305.08891): shift sqrt(alpha_bar) so its last
    entry is 0, stretch so its first is kept, un-cumprod back to betas."""
    alphas = 1.0 - betas
    alphas_bar_sqrt = torch.cumprod(alphas, dim=0).sqrt()

    first = alphas_bar_sqrt[0].clone()
    last = alphas_bar_sqrt[-1].clone()
    alphas_bar_sqrt = alphas_bar_sqrt - last
    alphas_bar_sqrt = alphas_bar_sqrt * first / (first - last)

    alphas_bar = alphas_bar_sqrt**2
    alphas = alphas_bar[1:] / alphas_bar[:-1]
    alphas = torch.cat([alphas_bar[0:1], alphas])
    return 1.0 - alphas


def make_beta_schedule(
    beta_schedule: str,
    num_train_timesteps: int,
    beta_start: float,
    beta_end: float,
    trained_betas: Optional[Union[Sequence[float], np.ndarray, torch.Tensor]] = None,
    dtype=torch.float32,
) -> torch.Tensor:
    """Betas for ``linear``, ``scaled_linear``, ``zero_snr_scaled_linear`` or
    ``squaredcos_cap_v2``; ``trained_betas`` overrides all."""
    if trained_betas is not None:
        return torch.as_tensor(np.asarray(trained_betas), dtype=dtype)
    if beta_schedule == "linear":
        return torch.linspace(beta_start, beta_end, num_train_timesteps, dtype=dtype)
    if beta_schedule in ("scaled_linear", "zero_snr_scaled_linear"):
        betas = (
            torch.linspace(
                beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=dtype
            )
            ** 2
        )
        if beta_schedule == "zero_snr_scaled_linear":
            betas = rescale_zero_terminal_snr(betas)
        return betas
    if beta_schedule == "squaredcos_cap_v2":
        return betas_for_alpha_bar(num_train_timesteps, dtype=dtype)
    raise NotImplementedError(f"beta_schedule {beta_schedule} is not implemented")


@dataclass
class CommonSchedulerState:
    """Per-run schedule tables shared by the schedulers."""

    alphas: torch.Tensor
    betas: torch.Tensor
    alphas_cumprod: torch.Tensor

    @classmethod
    def create(cls, scheduler, device=None) -> "CommonSchedulerState":
        cfg = scheduler.config
        betas = make_beta_schedule(
            beta_schedule=cfg.beta_schedule,
            num_train_timesteps=cfg.num_train_timesteps,
            beta_start=cfg.beta_start,
            beta_end=cfg.beta_end,
            trained_betas=cfg.trained_betas,
            dtype=scheduler.dtype,
        ).to(device)
        alphas = 1.0 - betas
        return cls(alphas=alphas, betas=betas, alphas_cumprod=torch.cumprod(alphas, dim=0))


def _left_broadcast(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """Append trailing singleton dims so a per-sample vector broadcasts over
    the sample dims."""
    return x.reshape(x.shape + (1,) * (ndim - x.dim()))


def _gather_sqrt_alpha_prod(state: CommonSchedulerState, timesteps, ndim: int):
    ac_t = state.alphas_cumprod[timesteps]
    sqrt_alpha_prod = _left_broadcast((ac_t**0.5).flatten(), ndim)
    sqrt_one_minus = _left_broadcast(((1 - ac_t) ** 0.5).flatten(), ndim)
    return sqrt_alpha_prod, sqrt_one_minus


def add_noise(
    state: CommonSchedulerState,
    original_samples: torch.Tensor,
    noise: torch.Tensor,
    timesteps: torch.Tensor,
) -> torch.Tensor:
    """Forward diffusion: x_t = sqrt(abar_t) x_0 + sqrt(1-abar_t) eps."""
    sqrt_alpha_prod, sqrt_one_minus = _gather_sqrt_alpha_prod(
        state, timesteps, original_samples.dim()
    )
    return sqrt_alpha_prod * original_samples + sqrt_one_minus * noise


def get_velocity(
    state: CommonSchedulerState,
    sample: torch.Tensor,
    noise: torch.Tensor,
    timesteps: torch.Tensor,
) -> torch.Tensor:
    """v-prediction target: v = sqrt(abar_t) eps - sqrt(1-abar_t) x_0."""
    sqrt_alpha_prod, sqrt_one_minus = _gather_sqrt_alpha_prod(state, timesteps, sample.dim())
    return sqrt_alpha_prod * noise - sqrt_one_minus * sample


def compute_snrs(alphas_cumprod: torch.Tensor) -> torch.Tensor:
    """Per-timestep signal-to-noise ratio abar / (1 - abar), the min-SNR-gamma
    loss weight's input."""
    return alphas_cumprod / (1 - alphas_cumprod)
