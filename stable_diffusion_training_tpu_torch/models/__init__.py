"""SD1.5 and SDXL models in PyTorch: UNet2DConditionModel (with SDXL's
``text_time`` micro-conditioning), AutoencoderKL, the CLIP text encoder and
SDXL's projected second one, ported from ``stable_diffusion_training_tpu/models``
with diffusers' (and transformers') attribute names, plus weight I/O
(``hf_io``) and seeded random weights (``random_init_``)."""

from . import configs
from .clip import CLIPTextModel, CLIPTextModelWithProjection
from .init import random_init_
from .unet import UNet2DConditionModel
from .vae import AutoencoderKL, DiagonalGaussianDistribution

__all__ = [
    "AutoencoderKL",
    "CLIPTextModel",
    "CLIPTextModelWithProjection",
    "DiagonalGaussianDistribution",
    "UNet2DConditionModel",
    "configs",
    "random_init_",
]
