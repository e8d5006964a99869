"""DDIM scheduler (deterministic / eta-weighted sampling).

Port of ``stable_diffusion_training_tpu/diffusion/ddim.py``: a state holding
the schedule tables and ``final_alpha_cumprod``, ``set_timesteps`` with
``steps_offset``, and ``step`` implementing formulas (12)/(16) of arXiv
2010.02502 for epsilon, sample and v prediction, and ``add_noise`` (the
img2img pipelines noise their start latents with it). As in the JAX
package, ``eta`` only shrinks the direction term; no noise is drawn.
"""

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from ..utils.configuration import ConfigurableMixin
from . import common
from .common import CommonSchedulerState


@dataclass
class DDIMSchedulerState:
    common: CommonSchedulerState
    final_alpha_cumprod: torch.Tensor
    init_noise_sigma: torch.Tensor
    # int32 on the host: the sampling loop reads them as Python ints
    timesteps: torch.Tensor
    num_inference_steps: Optional[int] = None

    def replace(self, **changes) -> "DDIMSchedulerState":
        return dataclasses.replace(self, **changes)


@dataclass
class DDIMSchedulerOutput:
    prev_sample: torch.Tensor
    state: DDIMSchedulerState


class DDIMScheduler(ConfigurableMixin):
    """Denoising Diffusion Implicit Models scheduler (arXiv 2010.02502)."""

    config_name = "scheduler_config.json"

    def __init__(
        self,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.0001,
        beta_end: float = 0.02,
        beta_schedule: str = "linear",
        trained_betas=None,
        set_alpha_to_one: bool = True,
        steps_offset: int = 0,
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

    def create_state(
        self, common_state: Optional[CommonSchedulerState] = None
    ) -> DDIMSchedulerState:
        """Tables on ``self.device`` (the CPU when it is None)."""
        if common_state is None:
            common_state = CommonSchedulerState.create(self, device=self.device)
        ac = common_state.alphas_cumprod
        final_alpha_cumprod = (
            torch.tensor(1.0, dtype=self.dtype, device=ac.device)
            if self.config.set_alpha_to_one
            else ac[0]
        )
        return DDIMSchedulerState(
            common=common_state,
            final_alpha_cumprod=final_alpha_cumprod,
            init_noise_sigma=torch.tensor(1.0, dtype=self.dtype, device=ac.device),
            timesteps=torch.arange(self.config.num_train_timesteps, dtype=torch.int32).flip(0),
        )

    def scale_model_input(self, state, sample: torch.Tensor, timestep=None) -> torch.Tensor:
        return sample

    def set_timesteps(
        self, state: DDIMSchedulerState, num_inference_steps: int
    ) -> DDIMSchedulerState:
        step_ratio = self.config.num_train_timesteps // num_inference_steps
        timesteps = (
            torch.arange(num_inference_steps, dtype=torch.int32) * step_ratio
        ).flip(0) + self.config.steps_offset
        return state.replace(num_inference_steps=num_inference_steps, timesteps=timesteps)

    def _alpha_prod_prev(self, state: DDIMSchedulerState, prev_timestep: int):
        if prev_timestep >= 0:
            return state.common.alphas_cumprod[prev_timestep]
        return state.final_alpha_cumprod

    def _get_variance(self, state: DDIMSchedulerState, timestep: int, prev_timestep: int):
        alpha_prod_t = state.common.alphas_cumprod[timestep]
        alpha_prod_t_prev = self._alpha_prod_prev(state, prev_timestep)
        beta_prod_t = 1 - alpha_prod_t
        beta_prod_t_prev = 1 - alpha_prod_t_prev
        return (beta_prod_t_prev / beta_prod_t) * (1 - alpha_prod_t / alpha_prod_t_prev)

    def step(
        self,
        state: DDIMSchedulerState,
        model_output: torch.Tensor,
        timestep: int,
        sample: torch.Tensor,
        eta: float = 0.0,
    ) -> DDIMSchedulerOutput:
        """One DDIM reverse step x_t -> x_{t-prev} (formulas 12/16)."""
        if state.num_inference_steps is None:
            raise ValueError("Number of inference steps is 'None'; run 'set_timesteps' first")
        timestep = int(timestep)
        prev_timestep = timestep - self.config.num_train_timesteps // state.num_inference_steps

        alpha_prod_t = state.common.alphas_cumprod[timestep]
        alpha_prod_t_prev = self._alpha_prod_prev(state, prev_timestep)
        beta_prod_t = 1 - alpha_prod_t

        prediction_type = self.config.prediction_type
        if prediction_type == "epsilon":
            pred_original_sample = (sample - beta_prod_t**0.5 * model_output) / alpha_prod_t**0.5
            pred_epsilon = model_output
        elif prediction_type == "sample":
            pred_original_sample = model_output
            pred_epsilon = (sample - alpha_prod_t**0.5 * pred_original_sample) / beta_prod_t**0.5
        elif prediction_type == "v_prediction":
            pred_original_sample = alpha_prod_t**0.5 * sample - beta_prod_t**0.5 * model_output
            pred_epsilon = alpha_prod_t**0.5 * model_output + beta_prod_t**0.5 * sample
        else:
            raise ValueError(
                f"prediction_type {prediction_type} must be one of "
                "`epsilon`, `sample`, or `v_prediction`"
            )

        # sigma_t(eta), formula (16)
        variance = self._get_variance(state, timestep, prev_timestep)
        std_dev_t = eta * variance**0.5

        # "direction pointing to x_t", formula (12)
        pred_sample_direction = (1 - alpha_prod_t_prev - std_dev_t**2) ** 0.5 * pred_epsilon
        prev_sample = alpha_prod_t_prev**0.5 * pred_original_sample + pred_sample_direction
        return DDIMSchedulerOutput(prev_sample=prev_sample, state=state)

    def add_noise(
        self,
        state: DDIMSchedulerState,
        original_samples: torch.Tensor,
        noise: torch.Tensor,
        timesteps: torch.Tensor,
    ) -> torch.Tensor:
        """Forward diffusion to ``timesteps`` (the img2img start)."""
        return common.add_noise(state.common, original_samples, noise, timesteps)
