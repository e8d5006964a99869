"""PyTorch/CUDA port of ``stable_diffusion_training_tpu`` for NVIDIA Hopper.

The JAX package beside it stays the reference. This package mirrors its
layout (``diffusion/``, ``models/``, ``ops/``, ``pipeline/``, ``utils/``),
imports neither JAX nor the JAX package, and runs the SD1.5 text-to-image
path with a hand-written CUDA flash-attention forward kernel
(``csrc/flash_attention_fwd.cu``). Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""
