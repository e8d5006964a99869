"""Kernels of the port and the code around them: attention (the plain
PyTorch path and the flash-attention forward and backward CUDA kernels,
``ops.flash_attention``) and the fused 8-bit Lion update
(``ops.lion_kernel``), built from ``csrc/`` by ``ops.cuda_build``."""

from .attention import FLASH_MIN_KEY, attention, dot_product_attention

__all__ = ["FLASH_MIN_KEY", "attention", "dot_product_attention"]
