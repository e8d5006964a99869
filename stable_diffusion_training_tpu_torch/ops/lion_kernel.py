"""Fused 8-bit Lion update: the CUDA kernel's wrappers and its plain version.

Port of ``stable_diffusion_training_tpu/ops/lion_kernel.py``. The TPU has
four layouts of the same update (dense, transposed, narrow, wide), each
shaped by its lane tiling; the card needs none of them. The port keeps one
layout, the reference order of ``lion_quant.py``: codes ``(n_blocks, bs)``
int8 and scales ``(n_blocks,)`` f32 per leaf, over the JAX leaf's flat
element order. One kernel, ``csrc/lion8bit_update.cu``, computes the update
(see its header for the math and the numerics it keeps). It has three
entries:

- ``lion8bit_update_`` (the role of the TPU's ``fused_lion8bit_update_dense``,
  K4): one leaf per launch, for every leaf above the bucket limit;
- ``lion8bit_update_multi_`` (the role of
  ``fused_lion8bit_update_transposed_packed``, K5): many small leaves in one
  launch through a table of pointers;
- ``fused_lion8bit_update`` (the TPU's public single-leaf entry, K6 with
  ``layout="narrow"`` and K7 with ``layout="wide"``): functional, with the
  JAX signature, scales ``(n_blocks, 1)``; both layouts hold the same
  ``(n_blocks, bs)`` bytes, so both launch the one kernel.

The first two update codes and scales in place and return the update sign
in the grad's dtype. CPU tensors take ``lion8bit_update_reference``; CUDA
tensors take the kernel or raise.
"""

import ctypes
from typing import List, Sequence, Tuple

import torch

from .cuda_build import load_library

LIBRARIES = {"lion8bit_update": ("lion8bit_update.cu",)}
# offset ensuring x = 0 round-trips to exactly 0 through the odd-power compander
ZERO_CROSSING_OFFSET = 3.7398995e-09
POW5_C = float(127.0**-5)  # the fast compander's folded (q/127)^5 constant
# block sizes the kernel is built for; 128 on its cooperative variant
BLOCK_SIZES = (1, 2, 4, 8, 16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def fast_compander(compander: str) -> bool:
    """True for the fast compander; raises for an unknown name."""
    if compander not in ("exact", "fast"):
        raise ValueError(f"unknown compander {compander!r}; use 'exact' or 'fast'")
    return compander == "fast"


def quantize(x: torch.Tensor) -> torch.Tensor:
    """int8 codes of block-scaled f32 values: round(sign(x + off) |x + off|^(1/5) 127)."""
    shifted = x + ZERO_CROSSING_OFFSET
    code = torch.pow(shifted.abs(), 0.2) * torch.sign(shifted) * 127
    return torch.round(code).to(torch.int8)


def dequantize(codes: torch.Tensor, scales: torch.Tensor, fast: bool) -> torch.Tensor:
    """f32 momentum of ``(n_blocks, bs)`` codes under ``(n_blocks,)`` scales.

    Exact: ``((q / 127)^5 - off) / scale``, the 5th power as XLA's
    integer_pow computes it, x * ((x x)(x x)). Fast: ``(q^5 127^-5 - off) *
    (1 / scale)``, the same math reassociated."""
    q = codes.float()
    if fast:
        q2 = q * q
        q5 = (q2 * q2) * q
        return (q5 * POW5_C - ZERO_CROSSING_OFFSET) * (1.0 / scales)[:, None]
    # a true division: torch (on CUDA) and XLA (under jit) turn a division by
    # a scalar into a multiply by its reciprocal, which moves 16 of the 256
    # codes' values by an ulp; a tensor divisor keeps the IEEE quotient
    x = q / torch.tensor(127.0, device=q.device)
    x2 = x * x
    return (x * (x2 * x2) - ZERO_CROSSING_OFFSET) / scales[:, None]


def block_quantize(mu: torch.Tensor, bs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Codes ``(n_blocks, bs)`` and inverse-absmax scales ``(n_blocks,)`` of
    f32 values in flat order, with the zero-block guard (scale 1)."""
    blocks = mu.reshape(-1, bs)
    absmax = blocks.abs().amax(dim=1)
    scales = 1.0 / torch.where(absmax <= 0.0, torch.ones_like(absmax), absmax)
    return quantize(blocks * scales[:, None]), scales


def lion8bit_update_reference(
    grad: torch.Tensor,
    codes: torch.Tensor,
    scales: torch.Tensor,
    b1: float = 0.9,
    b2: float = 0.99,
    compander: str = "exact",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: ``(update, new_codes, new_scales)``.

    ``grad`` holds ``codes.numel()`` elements in the JAX leaf's flat order;
    it is upcast to f32 before ``(1 - b1) g``, as in the Pallas kernels, and
    the update sign comes back in its dtype, shaped like it."""
    bs = codes.shape[1]
    g = grad.reshape(-1, bs).float()
    mu = dequantize(codes, scales, fast_compander(compander))
    upd = torch.sign((1.0 - b1) * g + b1 * mu).to(grad.dtype).reshape(grad.shape)
    new_codes, new_scales = block_quantize((1.0 - b2) * g + b2 * mu, bs)
    return upd, new_codes, new_scales


def _check_leaf(grad: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor) -> None:
    if codes.dim() != 2 or codes.dtype != torch.int8 or not codes.is_contiguous():
        raise ValueError(f"codes must be contiguous int8 (n_blocks, bs), got {tuple(codes.shape)} {codes.dtype}")
    nb, bs = codes.shape
    if scales.shape != (nb,) or scales.dtype != torch.float32 or not scales.is_contiguous():
        raise ValueError(f"scales must be contiguous float32 ({nb},), got {tuple(scales.shape)} {scales.dtype}")
    if grad.numel() != nb * bs or not grad.is_contiguous():
        raise ValueError(f"grad must be contiguous with {nb * bs} elements, got {tuple(grad.shape)}")
    if grad.dtype not in _DTYPE_CODES:
        raise TypeError(f"grad dtype {grad.dtype} not supported (float32, bfloat16)")
    if not (grad.device == codes.device == scales.device):
        raise ValueError("grad, codes and scales must be on one device")


def _on_cuda(t: torch.Tensor, bs: int) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"the Lion kernel runs on cuda or cpu, not {t.device}")
    if bs not in BLOCK_SIZES:
        raise ValueError(f"the Lion kernel takes block sizes {BLOCK_SIZES}, not {bs}")
    return True


def _coefs(b1: float, b2: float) -> List[ctypes.c_float]:
    # each constant rounded to f32 from the double, as JAX's weak typing does
    return [ctypes.c_float(x) for x in (1.0 - b1, b1, 1.0 - b2, b2)]


def _function(name: str, argtypes):
    fn = getattr(load_library("lion8bit_update", LIBRARIES["lion8bit_update"]), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_COMMON_ARGS = [ctypes.c_int] + [ctypes.c_float] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _launch_single(grad, codes, scales, b1, b2, fast) -> torch.Tensor:
    """One launch over one checked CUDA leaf; returns the update sign.
    Counting is the calling entry's."""
    nb, bs = codes.shape
    for name, t in (("grad", grad), ("codes", codes), ("scales", scales)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the Lion kernel's vector loads")
    upd = torch.empty_like(grad)
    fn = _function(
        "lion8bit_update", [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + _COMMON_ARGS
    )
    with torch.cuda.device(grad.device):
        rc = fn(
            grad.data_ptr(), codes.data_ptr(), scales.data_ptr(), upd.data_ptr(), nb, bs,
            *_coefs(b1, b2), int(fast), _DTYPE_CODES[grad.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"lion8bit_update launch failed: cudaError {rc} ({nb} blocks of {bs})")
    return upd


def lion8bit_update_(
    grad: torch.Tensor,
    codes: torch.Tensor,
    scales: torch.Tensor,
    b1: float = 0.9,
    b2: float = 0.99,
    compander: str = "exact",
) -> torch.Tensor:
    """Update one leaf: codes and scales in place; returns the update sign,
    shaped and typed like ``grad`` (JAX flat order). The kernel (counted in
    ``lion8bit_update_.launches``) for CUDA tensors, the plain version for
    CPU tensors."""
    _check_leaf(grad, codes, scales)
    fast = fast_compander(compander)
    nb, bs = codes.shape
    if not _on_cuda(grad, bs):
        upd, new_codes, new_scales = lion8bit_update_reference(grad, codes, scales, b1, b2, compander)
        codes.copy_(new_codes)
        scales.copy_(new_scales)
        return upd
    upd = _launch_single(grad, codes, scales, b1, b2, fast)
    _count(lion8bit_update_, (nb, bs, grad.dtype))
    return upd


def lion8bit_update_multi_(
    grads: Sequence[torch.Tensor],
    codes: Sequence[torch.Tensor],
    scales: Sequence[torch.Tensor],
    b1: float = 0.9,
    b2: float = 0.99,
    compander: str = "exact",
) -> List[torch.Tensor]:
    """Update many leaves of one block size and grad dtype in one launch
    (counted in ``lion8bit_update_multi_.launches``); per leaf as
    ``lion8bit_update_``. CPU tensors take the plain version leaf by leaf."""
    if not grads or not (len(grads) == len(codes) == len(scales)):
        raise ValueError("need one or more leaves, each with grad, codes and scales")
    for g, c, s in zip(grads, codes, scales):
        _check_leaf(g, c, s)
    bs = codes[0].shape[1]
    if any(c.shape[1] != bs for c in codes) or any(g.dtype != grads[0].dtype for g in grads):
        raise ValueError("all leaves of one launch share the block size and the grad dtype")
    if not _on_cuda(grads[0], bs):
        return [
            lion8bit_update_(g, c, s, b1, b2, compander) for g, c, s in zip(grads, codes, scales)
        ]
    if any(g.device != grads[0].device for g in grads):
        raise ValueError("all leaves of one launch are on one device")
    fast = fast_compander(compander)
    updates = [torch.empty_like(g) for g in grads]
    offsets = [0]
    for c in codes:
        offsets.append(offsets[-1] + c.shape[0])
    device = grads[0].device
    # the leaf table (4 pointers per leaf, then the block offsets) goes over
    # from pinned memory without waiting: a copy from pageable memory would
    # first wait for all the work queued on the device
    host = torch.tensor(
        [t.data_ptr() for leaf in zip(grads, codes, scales, updates) for t in leaf] + offsets,
        dtype=torch.int64,
    ).pin_memory()
    table = host.to(device, non_blocking=True)
    fn = _function(
        "lion8bit_update_multi",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong] + _COMMON_ARGS,
    )
    with torch.cuda.device(device):
        rc = fn(
            table.data_ptr(), table[4 * len(grads):].data_ptr(), len(grads), offsets[-1], bs,
            *_coefs(b1, b2), int(fast), _DTYPE_CODES[grads[0].dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"lion8bit_update_multi launch failed: cudaError {rc} ({len(grads)} leaves)")
    _count(lion8bit_update_multi_, (len(grads), offsets[-1], bs, grads[0].dtype))
    return updates


def fused_lion8bit_update(
    grad: torch.Tensor,
    codes: torch.Tensor,
    scales: torch.Tensor,
    b1: float = 0.9,
    b2: float = 0.99,
    mu_scale_dtype: torch.dtype = torch.float32,
    rows_per_tile: int = 1024,
    layout: str = "narrow",
    compander: str = "exact",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused update for one quantized leaf, the JAX package's
    ``fused_lion8bit_update`` (``layout="narrow"``: K6; ``"wide"``: K7).

    ``grad``: any shape with ``grad.numel() == codes.numel()``, in the JAX
    leaf's flat order; ``codes`` ``(n_blocks, bs)`` int8; ``scales``
    ``(n_blocks, 1)``. Returns ``(update_sign, new_codes, new_scales)``: the
    sign shaped and typed like ``grad``, new codes ``(n_blocks, bs)`` and new
    scales ``(n_blocks, 1)`` in ``mu_scale_dtype``. Functional: the inputs
    are not changed. Scales in another dtype are upcast to f32 going in and
    the new ones cast coming out, exactly as the TPU kernel divides in f32.

    ``layout="wide"`` takes the TPU entry's checks: a block size below 128
    that divides 128, and the exact compander only. The two layouts differ
    only in how the TPU's 128 lanes hold the blocks; the card computes both
    with the one kernel over the same bytes. ``rows_per_tile`` is the TPU's
    tile height and has no effect on the card. CUDA tensors launch the kernel
    (block sizes ``BLOCK_SIZES``; others raise) and are counted in
    ``fused_lion8bit_update.launches``, by ``(layout, n_blocks, bs, grad
    dtype)``; CPU tensors take ``lion8bit_update_reference``.
    """
    if layout not in ("narrow", "wide"):
        raise ValueError(f"unknown layout {layout!r}; use 'narrow' or 'wide'")
    nb, bs = codes.shape
    fast = fast_compander(compander)
    if layout == "wide":
        if bs >= 128 or 128 % bs:
            raise ValueError(f"layout='wide' requires block_size < 128 dividing 128, got {bs}")
        if fast:
            raise ValueError("compander='fast' is not implemented for the retired 'wide' layout")
    if tuple(scales.shape) != (nb, 1):
        raise ValueError(f"scales must be ({nb}, 1), got {tuple(scales.shape)}")
    new_codes = codes.clone(memory_format=torch.contiguous_format)
    new_scales = scales.reshape(nb).to(torch.float32, copy=True)
    flat = grad.reshape(-1)
    if flat.data_ptr() % 16:  # a view at an odd offset: the kernel loads 16-byte vectors
        flat = flat.clone()
    _check_leaf(flat, new_codes, new_scales)
    if _on_cuda(flat, bs):
        upd = _launch_single(flat, new_codes, new_scales, b1, b2, fast)
        _count(fused_lion8bit_update, (layout, nb, bs, grad.dtype))
    else:
        upd, new_codes, new_scales = lion8bit_update_reference(flat, codes, new_scales, b1, b2, compander)
    return upd.reshape(grad.shape), new_codes, new_scales.reshape(nb, 1).to(mu_scale_dtype)


def _count(wrapper, shape) -> None:
    """One launch of ``wrapper``: in total and by shape (single leaf: blocks,
    block size, grad dtype; many leaves: leaves, blocks, block size, dtype;
    the functional entry: layout, blocks, block size, dtype)."""
    wrapper.launches += 1
    key = shape[:-1] + (str(shape[-1]).replace("torch.", ""),)
    wrapper.launches_by_shape[key] = wrapper.launches_by_shape.get(key, 0) + 1


def reset_launch_counts() -> None:
    for wrapper in (lion8bit_update_, lion8bit_update_multi_, fused_lion8bit_update):
        wrapper.launches = 0
        wrapper.launches_by_shape = {}


reset_launch_counts()
