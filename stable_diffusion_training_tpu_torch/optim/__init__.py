"""Optimizers of the train step: 8-bit Lion (and optax's dense Lion), the
masks that pick its leaves, and the optax-style transforms it chains with.
Ported from ``stable_diffusion_training_tpu/optim``."""

from .lion8bit import (
    QuantizedMomentum,
    ScaleByLion8bitState,
    lion,
    lion_8bit,
    scale_by_lion,
    scale_by_lion_8bit,
)
from .masks import create_mask
from .transforms import (
    GradientTransformation,
    add_decayed_weights,
    apply_updates_,
    chain,
    clip_by_global_norm,
    scale_by_learning_rate,
)

__all__ = [
    "GradientTransformation",
    "QuantizedMomentum",
    "ScaleByLion8bitState",
    "add_decayed_weights",
    "apply_updates_",
    "chain",
    "clip_by_global_norm",
    "create_mask",
    "lion",
    "lion_8bit",
    "scale_by_learning_rate",
    "scale_by_lion",
    "scale_by_lion_8bit",
]
