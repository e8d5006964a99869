"""PyTorch/CUDA port of ``stable_diffusion_training_tpu`` for NVIDIA Hopper.

The JAX package beside it stays the reference. This package mirrors its
layout (``diffusion/``, ``models/``, ``ops/``, ``optim/``, ``pipeline/``,
``train/``, ``utils/``), imports neither JAX nor the JAX package, and runs
the SD1.5 text-to-image path and the SD1.5 train step with hand-written
CUDA kernels: flash-attention forward and backward
(``csrc/flash_attention_fwd.cu``, ``csrc/flash_attention_bwd.cu``) and the
fused 8-bit Lion update (``csrc/lion8bit_update.cu``). Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""
