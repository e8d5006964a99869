"""Inference: the SD1.5 CFG text-to-image pipeline, SDXL text-to-image and
the SDXL refiner (img2img)."""

from .sdxl import StableDiffusionXLPipeline
from .sdxl_refiner import StableDiffusionXLImg2ImgPipeline, prepare_image
from .stable_diffusion import StableDiffusionPipeline

__all__ = [
    "StableDiffusionPipeline",
    "StableDiffusionXLPipeline",
    "StableDiffusionXLImg2ImgPipeline",
    "prepare_image",
]
