"""Noise schedules, the DDPM scheduler of the train step and the DDIM
sampler, ported from ``stable_diffusion_training_tpu/diffusion``."""

from .common import (
    CommonSchedulerState,
    add_noise,
    betas_for_alpha_bar,
    compute_snrs,
    get_velocity,
    make_beta_schedule,
    rescale_zero_terminal_snr,
)
from .ddim import DDIMScheduler, DDIMSchedulerOutput, DDIMSchedulerState
from .ddpm import DDPMScheduler, DDPMSchedulerOutput, DDPMSchedulerState

__all__ = [
    "CommonSchedulerState",
    "add_noise",
    "betas_for_alpha_bar",
    "compute_snrs",
    "get_velocity",
    "make_beta_schedule",
    "rescale_zero_terminal_snr",
    "DDIMScheduler",
    "DDIMSchedulerOutput",
    "DDIMSchedulerState",
    "DDPMScheduler",
    "DDPMSchedulerOutput",
    "DDPMSchedulerState",
]
