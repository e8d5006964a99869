"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Port of ``stable_diffusion_training_tpu/ops/flash_attention.py`` (the Pallas
``_fwd_kernel`` launched by ``_flash_fwd_impl``). The kernel is
``csrc/flash_attention_fwd.cu``, built with ``nvcc`` at first use and called
through ctypes. It computes O and the per-row logsumexp with f32 logits and
accumulator, P cast to V's dtype before the PV product, and the ``l == 0``
guard. The gradient (the TPU's ``_bwd_dq_kernel``/``_bwd_dkv_kernel``) comes
with training; inference needs none.

Layouts: ``flash_attention`` takes the models' ``(B, S, H, D)``; the kernel
takes heads folded to ``(B*H, S, D)`` with contiguous rows and returns lse as
``(B*H, Sq)``, where the TPU kernel returned ``(B*H, Sq_padded, 1)``.

CPU tensors take the plain version; CUDA tensors take the kernel or raise.
"""

import ctypes
from typing import Optional, Tuple

import torch

from .cuda_build import load_library

MAX_HEAD_DIM = 512
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCES = ("flash_attention_fwd.cu",)


def flash_attention_fwd_reference(
    q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: f32 logits -> lse -> softmax -> PV.

    ``q3`` ``(BH, Sq, D)``, ``k3``/``v3`` ``(BH, Sk, D)``. P is cast to V's
    dtype before the product, accumulated in f32; O comes back in Q's dtype,
    lse ``(BH, Sq)`` in f32.
    """
    logits = torch.matmul(q3.float(), k3.float().transpose(-1, -2)) * scale
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    o = torch.matmul(p.to(v3.dtype).float(), v3.float())
    return o.to(q3.dtype), lse


def _check(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor) -> None:
    for name, t in (("q", q3), ("k", k3), ("v", v3)):
        if t.dim() != 3:
            raise ValueError(f"{name} must be (B*H, S, D), got shape {tuple(t.shape)}")
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name} dtype {t.dtype} not supported (float32, bfloat16)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not (q3.dtype == k3.dtype == v3.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q3.dtype}, {k3.dtype}, {v3.dtype}")
    if not (q3.device == k3.device == v3.device):
        raise ValueError(f"q/k/v devices differ: {q3.device}, {k3.device}, {v3.device}")
    bh, sq, d = q3.shape
    if k3.shape != v3.shape or k3.shape[0] != bh or k3.shape[2] != d:
        raise ValueError(
            f"shape mismatch: q {tuple(q3.shape)}, k {tuple(k3.shape)}, v {tuple(v3.shape)}"
        )
    if not (1 <= d <= MAX_HEAD_DIM) or sq < 1 or k3.shape[1] < 1 or bh > 65535:
        raise ValueError(
            f"unsupported shape q {tuple(q3.shape)}, k {tuple(k3.shape)}: "
            f"need 1 <= D <= {MAX_HEAD_DIM}, S >= 1, B*H <= 65535"
        )


def _library() -> ctypes.CDLL:
    lib = load_library("flash_attention_fwd", _SOURCES)
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_float,
            ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def flash_attention_fwd(
    q3: torch.Tensor,
    k3: torch.Tensor,
    v3: torch.Tensor,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """O ``(BH, Sq, D)`` in Q's dtype and lse ``(BH, Sq)`` f32.

    ``scale`` defaults to ``D**-0.5``. Launches the CUDA kernel on the
    current stream for CUDA tensors (counted in
    ``flash_attention_fwd.launches``); CPU tensors take
    ``flash_attention_fwd_reference``.
    """
    _check(q3, k3, v3)
    if scale is None:
        scale = q3.shape[-1] ** -0.5
    if q3.device.type == "cpu":
        return flash_attention_fwd_reference(q3, k3, v3, scale)
    if q3.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on cuda or cpu, not {q3.device}")

    bh, sq, d = q3.shape
    sk = k3.shape[1]
    o = torch.empty_like(q3)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q3.device)
    with torch.cuda.device(q3.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library().flash_attention_fwd(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o.data_ptr(), lse.data_ptr(),
            bh, sq, sk, d, float(scale), _DTYPE_CODES[q3.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"flash_attention_fwd launch failed: cudaError {rc} "
            f"(q {tuple(q3.shape)}, k {tuple(k3.shape)}, {q3.dtype})"
        )
    flash_attention_fwd.launches += 1
    shape = (bh, sq, sk, d, str(q3.dtype).replace("torch.", ""))
    flash_attention_fwd.launches_by_shape[shape] = (
        flash_attention_fwd.launches_by_shape.get(shape, 0) + 1
    )
    return o, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.launches_by_shape = {}


def reset_launch_counts() -> None:
    flash_attention_fwd.launches = 0
    flash_attention_fwd.launches_by_shape = {}


def _fold_heads(x: torch.Tensor) -> torch.Tensor:
    # (B, S, H, D) -> (B*H, S, D), contiguous
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d).contiguous()


def _unfold_heads(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    bh, s, d = x.shape
    return x.reshape(b, h, s, d).permute(0, 2, 1, 3)


def flash_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention over ``(B, S, H, D)`` tensors; numerics match
    ``ops.attention.dot_product_attention``."""
    b, _, h, _ = query.shape
    o, _ = flash_attention_fwd(
        _fold_heads(query), _fold_heads(key), _fold_heads(value), scale
    )
    return _unfold_heads(o, b, h)
