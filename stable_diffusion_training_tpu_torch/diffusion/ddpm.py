"""DDPM scheduler: the train step's noise schedule (``add_noise``,
``get_velocity``) and the ancestral sampling step.

Port of ``stable_diffusion_training_tpu/diffusion/ddpm.py``: a state holding
the schedule tables, ``create_state``, ``set_timesteps``, the six variance
types and ``step`` with epsilon/sample/v-prediction x0 reconstruction,
sample clipping and variance noise gated off at t == 0. The JAX package
draws that noise from a ``jax.random`` key; the port takes a
``torch.Generator``, or the noise itself through ``noise=`` (the tests feed
the JAX draw).
"""

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from ..utils.configuration import ConfigurableMixin
from . import common
from .common import CommonSchedulerState


@dataclass
class DDPMSchedulerState:
    common: CommonSchedulerState
    init_noise_sigma: torch.Tensor
    timesteps: torch.Tensor
    num_inference_steps: Optional[int] = None

    def replace(self, **changes) -> "DDPMSchedulerState":
        return dataclasses.replace(self, **changes)


@dataclass
class DDPMSchedulerOutput:
    prev_sample: torch.Tensor
    state: DDPMSchedulerState


class DDPMScheduler(ConfigurableMixin):
    """Denoising Diffusion Probabilistic Models scheduler (arXiv 2006.11239)."""

    config_name = "scheduler_config.json"

    def __init__(
        self,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.0001,
        beta_end: float = 0.02,
        beta_schedule: str = "linear",
        trained_betas=None,
        variance_type: str = "fixed_small",
        clip_sample: bool = True,
        prediction_type: str = "epsilon",
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        self.dtype = dtype
        self.device = device
        self._register_config(dict(locals()))

    @classmethod
    def from_pretrained(cls, pretrained_path: str, subfolder: Optional[str] = None, **kw):
        scheduler = cls.from_config(cls.load_config(pretrained_path, subfolder), **kw)
        return scheduler, scheduler.create_state()

    def create_state(self, common_state: Optional[CommonSchedulerState] = None) -> DDPMSchedulerState:
        """Tables on ``self.device`` (the CPU when it is None)."""
        if common_state is None:
            common_state = CommonSchedulerState.create(self, device=self.device)
        return DDPMSchedulerState(
            common=common_state,
            init_noise_sigma=torch.tensor(
                1.0, dtype=self.dtype, device=common_state.alphas_cumprod.device
            ),
            timesteps=torch.arange(self.config.num_train_timesteps).flip(0),
        )

    def scale_model_input(self, state, sample: torch.Tensor, timestep=None) -> torch.Tensor:
        return sample

    def set_timesteps(self, state: DDPMSchedulerState, num_inference_steps: int) -> DDPMSchedulerState:
        step_ratio = self.config.num_train_timesteps // num_inference_steps
        timesteps = (torch.arange(num_inference_steps) * step_ratio).flip(0)
        return state.replace(num_inference_steps=num_inference_steps, timesteps=timesteps)

    def _alpha_prod_prev(self, state: DDPMSchedulerState, t: int) -> torch.Tensor:
        ac = state.common.alphas_cumprod
        return ac[t - 1] if t > 0 else torch.tensor(1.0, dtype=self.dtype, device=ac.device)

    def _get_variance(self, state: DDPMSchedulerState, t: int, predicted_variance=None):
        alpha_prod_t = state.common.alphas_cumprod[t]
        alpha_prod_t_prev = self._alpha_prod_prev(state, t)
        # predicted variance beta-tilde_t, formulas (6)/(7) of arXiv 2006.11239
        variance = (1 - alpha_prod_t_prev) / (1 - alpha_prod_t) * state.common.betas[t]
        variance_type = self.config.variance_type
        if variance_type == "fixed_small":
            return torch.clamp(variance, min=1e-20)
        if variance_type == "fixed_small_log":
            return torch.log(torch.clamp(variance, min=1e-20))
        if variance_type == "fixed_large":
            return state.common.betas[t]
        if variance_type == "fixed_large_log":
            return torch.log(state.common.betas[t])
        if variance_type == "learned":
            return predicted_variance
        if variance_type == "learned_range":
            frac = (predicted_variance + 1) / 2
            return frac * state.common.betas[t] + (1 - frac) * variance
        raise NotImplementedError(f"variance_type {variance_type}")

    def step(
        self,
        state: DDPMSchedulerState,
        model_output: torch.Tensor,
        timestep: int,
        sample: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> DDPMSchedulerOutput:
        """One reverse (ancestral sampling) step x_t -> x_{t-1}. The variance
        noise is ``noise`` if given, else drawn from ``generator``."""
        t = int(timestep)
        if model_output.shape[1] == sample.shape[1] * 2 and self.config.variance_type in (
            "learned",
            "learned_range",
        ):
            # sample.shape[1] sections, as jnp.split has it: whole only for 2 channels
            model_output, predicted_variance = torch.tensor_split(model_output, sample.shape[1], dim=1)
        else:
            predicted_variance = None

        alpha_prod_t = state.common.alphas_cumprod[t]
        alpha_prod_t_prev = self._alpha_prod_prev(state, t)
        beta_prod_t = 1 - alpha_prod_t
        beta_prod_t_prev = 1 - alpha_prod_t_prev

        # "predicted x_0", formula (15) of arXiv 2006.11239
        prediction_type = self.config.prediction_type
        if prediction_type == "epsilon":
            pred_original_sample = (sample - beta_prod_t**0.5 * model_output) / alpha_prod_t**0.5
        elif prediction_type == "sample":
            pred_original_sample = model_output
        elif prediction_type == "v_prediction":
            pred_original_sample = alpha_prod_t**0.5 * sample - beta_prod_t**0.5 * model_output
        else:
            raise ValueError(
                f"prediction_type {prediction_type} must be one of "
                "`epsilon`, `sample`, `v_prediction`"
            )
        if self.config.clip_sample:
            pred_original_sample = pred_original_sample.clamp(-1, 1)

        # mu_t coefficients, formula (7)
        pred_original_sample_coeff = (alpha_prod_t_prev**0.5 * state.common.betas[t]) / beta_prod_t
        current_sample_coeff = state.common.alphas[t] ** 0.5 * beta_prod_t_prev / beta_prod_t
        pred_prev_sample = (
            pred_original_sample_coeff * pred_original_sample + current_sample_coeff * sample
        )

        if t > 0:  # variance noise, gated off at t == 0
            if noise is None:
                noise = torch.randn(
                    model_output.shape, generator=generator, dtype=self.dtype,
                    device=model_output.device,
                )
            variance = self._get_variance(state, t, predicted_variance) ** 0.5
            pred_prev_sample = pred_prev_sample + variance * noise
        return DDPMSchedulerOutput(prev_sample=pred_prev_sample, state=state)

    def add_noise(self, state, original_samples, noise, timesteps):
        return common.add_noise(state.common, original_samples, noise, timesteps)

    def get_velocity(self, state, sample, noise, timesteps):
        return common.get_velocity(state.common, sample, noise, timesteps)

    def __len__(self):
        return self.config.num_train_timesteps
