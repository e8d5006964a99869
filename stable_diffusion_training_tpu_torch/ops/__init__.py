"""Attention for the port: the plain PyTorch path and the hand-written CUDA
flash-attention forward kernel (``ops.flash_attention``, source
``csrc/flash_attention_fwd.cu``)."""

from .attention import FLASH_MIN_KEY, attention, dot_product_attention

__all__ = ["FLASH_MIN_KEY", "attention", "dot_product_attention"]
