"""Noise schedules and the DDIM sampler, ported from
``stable_diffusion_training_tpu/diffusion``. DDPM comes with training."""

from .common import (
    CommonSchedulerState,
    add_noise,
    betas_for_alpha_bar,
    get_velocity,
    make_beta_schedule,
    rescale_zero_terminal_snr,
)
from .ddim import DDIMScheduler, DDIMSchedulerOutput, DDIMSchedulerState

__all__ = [
    "CommonSchedulerState",
    "add_noise",
    "betas_for_alpha_bar",
    "get_velocity",
    "make_beta_schedule",
    "rescale_zero_terminal_snr",
    "DDIMScheduler",
    "DDIMSchedulerOutput",
    "DDIMSchedulerState",
]
