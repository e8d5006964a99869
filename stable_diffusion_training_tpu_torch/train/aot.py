"""The trainer's per-bucket step table.

Port of ``stable_diffusion_training_tpu/train/aot.py``. The JAX package
compiles one XLA program per aspect-ratio bucket ahead of time and keys them
by the batch's ``pixel_values`` shape (``latent_moments`` on the latent-cache
path); the trainer dispatches each batch through that dict, so a batch of a
shape no bucket has is a ``KeyError``. The port keeps the table and the
dispatch, with an eager ``train_step`` bound to the config's options as each
entry. The config's ``compilation_cache_path``, ``keep_compiled_fn_in_cache``
and ``aot_compile`` set up XLA's compilation cache in the JAX package; the
port accepts them and ignores them.
"""

import functools
from typing import Any, Callable, Dict

import numpy as np

from ..data.buckets import calculate_resolution_array
from ..utils.timing import TimingContextManager
from .config import TrainingConfig
from .train_step import train_step


def all_unique_resolutions(training_config: TrainingConfig) -> np.ndarray:
    """Every bucket resolution of the config's (area, minimum axis) tiers,
    each once."""
    buckets = []
    for area_root, min_axis in zip(training_config.image_area_root, training_config.minimum_axis_length):
        buckets.append(
            calculate_resolution_array(
                max_res_area=area_root**2,
                bucket_lower_bound_res=min_axis,
                rounding=training_config.bucket_rounding,
            )
        )
    # multi-tier configs can repeat shapes across tiers
    return np.unique(np.concatenate(buckets), axis=0)


def batch_dispatch_key(batch: Dict[str, Any]) -> tuple:
    """The key of a batch's step: its ``pixel_values`` shape, or its
    ``latent_moments`` shape on the latent-cache path."""
    if "pixel_values" in batch:
        return tuple(batch["pixel_values"].shape)
    return tuple(batch["latent_moments"].shape)


def bucket_train_steps(training_config: TrainingConfig, frozen_vae: Any) -> Dict[tuple, Callable]:
    """``{batch shape: step}`` for every bucket: ``train_step`` with the
    config's options bound, called as ``step(unet_state, text_encoder_state,
    unet_ema, text_encoder_ema, batch, train_rng, frozen_vae,
    frozen_schedulers)``. The latent-cache keys (``use_latent_cache``) are
    the moments' shapes: twice the VAE's latent channels, each bucket side
    over its downsampling factor (SDXL's 1152x896 bucket: 144x112)."""
    step = functools.partial(
        train_step,
        strip_bos_eos_token=training_config.strip_bos_eos_token,
        offset_noise_magnitude=training_config.offset_noise_magnitude,
        min_snr_gamma_magnitude=training_config.min_snr_gamma_magnitude,
        perturbation_noise_magnitude=training_config.perturbation_noise_magnitude,
        ema_rate=training_config.ema_rate,
        text_context_window=training_config.text_encoder_context_window,
        grad_accumulation_steps=training_config.grad_accumulation_steps,
        train_text_encoder=training_config.train_text_encoder,
        vae_encode_chunk=training_config.vae_encode_chunk,
    )
    vae_config = frozen_vae.call.config
    factor = 2 ** (len(vae_config.block_out_channels) - 1)
    b = training_config.batch_size
    steps = {}
    with TimingContextManager("step table for all buckets"):
        for res0, res1 in all_unique_resolutions(training_config):
            if training_config.use_latent_cache:
                key = (b, 2 * vae_config.latent_channels, int(res0) // factor, int(res1) // factor)
            else:
                key = (b, 3, int(res0), int(res1))
            steps[key] = step
    return steps
