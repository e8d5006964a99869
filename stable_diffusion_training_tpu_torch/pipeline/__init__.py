"""Inference: the SD1.5 CFG text-to-image pipeline."""

from .stable_diffusion import StableDiffusionPipeline

__all__ = ["StableDiffusionPipeline"]
