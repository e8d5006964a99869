"""Attention primitive: plain PyTorch numerics + backend dispatch.

Port of ``stable_diffusion_training_tpu/ops/attention.py``. Three backends:

- ``"xla"`` (the name is kept from the JAX package): ``torch.matmul`` logits
  in f32, f32 softmax, weights cast to the value dtype before the PV product,
  output in the query dtype.
- ``"xla_remat"``: the same numerics, with the f32 logits and softmax of
  each query chunk of ``QUERY_CHUNK`` rows recomputed in the backward
  (``torch.utils.checkpoint``) instead of saved: the JAX package's
  ``jax.checkpoint`` route for long queries over short keys (caption
  cross-attention at 4096 tokens), where the saved ``(B, H, Sq, Sk)`` f32
  softmax would dominate training memory.
- ``"flash"``: the hand-written CUDA kernels (``ops.flash_attention``),
  forward and backward.

``"auto"`` is the JAX package's policy with CUDA in the TPU's place: flash
for CUDA tensors with no mask and at least ``FLASH_MIN_KEY`` keys, else
``xla_remat`` for queries of at least ``REMAT_MIN_QUERY`` tokens, else
``xla``. At 512x512 that sends the 64x64 latent self-attention to the
kernels, the cross-attention at 64x64 and 32x32 and the 32x32
self-attention to ``xla_remat``.

All tensors are ``(batch, seq, heads, head_dim)``.
"""

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from .flash_attention import flash_attention

# keys at or above this length go to the flash kernels under "auto": the
# spatial self-attention at 64x64 latents (4096 tokens) and the VAE
# mid-block
FLASH_MIN_KEY = 2048
# queries at or above this length take "xla_remat" under "auto"
REMAT_MIN_QUERY = 1024
# rows per rematerialized query chunk: each chunk's f32 logits are
# (B, H, QUERY_CHUNK, Sk), recomputed one chunk at a time in the backward
QUERY_CHUNK = 1024


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


def _remat_attention(query, key, value, mask, scale):
    """``dot_product_attention`` whose f32 logits and softmax are recomputed
    in the backward instead of saved."""
    if not torch.is_grad_enabled():
        return dot_product_attention(query, key, value, mask, scale)
    return checkpoint(dot_product_attention, query, key, value, mask, scale, use_reentrant=False)


def attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    backend: str = "auto",
) -> torch.Tensor:
    """Dispatching attention primitive used by every model.

    ``backend``: ``"auto"`` (the policy in the module docstring),
    ``"flash"``, ``"xla"`` or ``"xla_remat"``. A mask sends ``"flash"`` to
    the plain path, as in the JAX package.
    """
    if backend == "auto":
        if query.is_cuda and mask is None and key.shape[1] >= FLASH_MIN_KEY:
            backend = "flash"
        elif query.shape[1] >= REMAT_MIN_QUERY:
            backend = "xla_remat"
        else:
            backend = "xla"
    if backend == "flash":
        if mask is None:
            return flash_attention(query, key, value, scale=scale)
        backend = "xla"
    if backend == "xla_remat":
        # each query row sees the whole key set, so chunking the queries
        # changes nothing in the forward; chunks keep one recompute small
        sq = query.shape[1]
        if mask is not None or sq <= QUERY_CHUNK or sq % QUERY_CHUNK:
            return _remat_attention(query, key, value, mask, scale)
        return torch.cat(
            [
                _remat_attention(query[:, i : i + QUERY_CHUNK], key, value, None, scale)
                for i in range(0, sq, QUERY_CHUNK)
            ],
            dim=1,
        )
    if backend == "xla":
        return dot_product_attention(query, key, value, mask=mask, scale=scale)
    raise ValueError(f"unknown attention backend: {backend!r}")
