"""Attention primitive: plain PyTorch numerics + backend dispatch.

Port of ``stable_diffusion_training_tpu/ops/attention.py``. Two backends:

- ``"xla"`` (the name is kept from the JAX package): ``torch.matmul`` logits
  in f32, f32 softmax, weights cast to the value dtype before the PV product,
  output in the query dtype. ``"xla_remat"`` has the same forward numerics
  (it only changes what the JAX backward saves), so for inference it is this
  path too.
- ``"flash"``: the hand-written CUDA kernel (``ops.flash_attention``).

All tensors are ``(batch, seq, heads, head_dim)``.
"""

from typing import Optional

import torch

from .flash_attention import flash_attention

# keys at or above this length go to the flash kernel under "auto": the
# spatial self-attention at 64x64 latents (4096 tokens) and the VAE
# mid-block; short cross-attention (77 keys) stays on the plain path
FLASH_MIN_KEY = 2048


def dot_product_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Reference attention: softmax(q k^T * scale) v with f32 softmax.

    Shapes: q ``(B, Sq, H, D)``, k/v ``(B, Sk, H, D)``; mask broadcastable to
    ``(B, H, Sq, Sk)`` (additive). Returns ``(B, Sq, H, D)`` in the query
    dtype.
    """
    if scale is None:
        scale = query.shape[-1] ** -0.5
    q = query.permute(0, 2, 1, 3).float()
    k = key.permute(0, 2, 3, 1).float()
    logits = torch.matmul(q, k) * scale
    if mask is not None:
        logits = logits + mask.float()
    weights = torch.softmax(logits, dim=-1)
    out = torch.matmul(weights.to(value.dtype).float(), value.permute(0, 2, 1, 3).float())
    return out.permute(0, 2, 1, 3).to(query.dtype)


def attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    backend: str = "auto",
) -> torch.Tensor:
    """Dispatching attention primitive used by every model.

    ``backend``: ``"auto"`` (flash for CUDA tensors with no mask and at least
    ``FLASH_MIN_KEY`` keys, else the plain path), ``"flash"``, ``"xla"`` or
    ``"xla_remat"``.
    """
    if backend == "auto":
        use_flash = query.is_cuda and mask is None and key.shape[1] >= FLASH_MIN_KEY
        backend = "flash" if use_flash else "xla"
    if backend == "flash" and mask is None:
        return flash_attention(query, key, value, scale=scale)
    if backend in ("flash", "xla", "xla_remat"):
        return dot_product_attention(query, key, value, mask=mask, scale=scale)
    raise ValueError(f"unknown attention backend: {backend!r}")
