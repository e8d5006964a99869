"""Flash attention: the CUDA kernels' wrappers, their plain versions, and
the autograd Function that joins them.

Port of ``stable_diffusion_training_tpu/ops/flash_attention.py``:

- the forward (the Pallas ``_fwd_kernel`` launched by ``_flash_fwd_impl``)
  is ``csrc/flash_attention_fwd.cu``: O and the per-row logsumexp with f32
  logits and accumulator, P cast to V's dtype before the PV product, and the
  ``l == 0`` guard. Six routes (``forward_route``): bf16 with D % 8 == 0
  and 16-byte aligned tensors takes a tensor-core kernel, narrow (D <= 64),
  mid (64 < D <= 128: SD1.5's 640-channel level has heads of 80) or wide;
  f32 with D % 4 == 0 and 16-byte aligned tensors takes an f32
  CUDA-core kernel, narrow or wide (route ``f32``) or mid (64 < D <= 128,
  route ``f32_mid``) (exact f32 products, fixed order: O and lse repeat
  bitwise; ``flash_attention_fwd_f32_model`` is their order in plain
  torch); everything else the older CUDA-core kernel, which
  ``flash_attention_fwd_cuda_cores`` also runs on any input, to compare
  (``flash_attention_fwd_tma_wide`` and ``flash_attention_fwd_f32_wide``
  likewise run the wide bf16 and f32 kernels at 64 < D <= 128, which the
  mid ones replaced there);
- the backward (``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``, launched by
  ``_flash_bwd``) is ``csrc/flash_attention_bwd.cu``, with ``delta =
  rowsum(dO * O)`` computed here in f32 as ``_flash_bwd`` does. Four
  routes (``backward_route``): bf16 with D % 8 == 0, D <= 64 and 16-byte
  aligned tensors takes one fused tensor-core kernel
  (``flash_attention_bwd_fused``: S, P and dS once per key block, dQ summed
  across key blocks into a zeroed f32 buffer, so its order of additions
  changes from run to run), and with 64 < D <= 128 its wide-head
  counterpart (``flash_attention_bwd_fused_wide``, the same arithmetic:
  SD1.5's 640-channel level has heads of 80); f32 with D % 4 == 0, D <= 128
  and 16-byte aligned tensors takes one fused CUDA-core kernel
  (``flash_attention_bwd_f32_fused``: exact f32 products, each key block's
  dQ partial written apart and summed in key-block order by a second
  kernel, so dQ repeats bitwise; blocks of 128 keys at D <= 64, of 64
  above); everything else takes two CUDA-core
  kernels, dQ (``flash_attention_bwd_dq``) and dK/dV
  (``flash_attention_bwd_dkv``);
- ``FlashAttention`` is the ``torch.autograd.Function`` around them, the
  counterpart of the JAX package's ``jax.custom_vjp``: it saves q, k, v, O
  and lse, and its backward is ``flash_attention_bwd``.

The kernels are built with ``nvcc`` at first use and called through ctypes.
Layouts: ``flash_attention`` takes the models' ``(B, S, H, D)``; the kernels
take heads folded to ``(B*H, S, D)`` with contiguous rows, and lse is
``(B*H, Sq)`` where the TPU kernel kept ``(B*H, Sq_padded, 1)``.

CPU tensors take the plain versions; CUDA tensors take the kernels or raise.
"""

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from ..utils.profiling import annotate_launch
from ..utils.roofline import Work, attention_work
from .cuda_build import load_library

MAX_HEAD_DIM = 512
# the fused backward kernel: head dims it takes, and keys per block (dQ is
# added into its f32 buffer once per block of keys). Both copy the kernel's
# own: the entry's d > 64 check and FusedTile::BK in
# csrc/flash_attention_bwd.cu, which must stay equal to these.
FUSED_BWD_MAX_HEAD_DIM = 64
FUSED_BWD_KEYS = 128
# the wide-head fused kernel takes FUSED_BWD_MAX_HEAD_DIM < D <= this, in
# blocks of FUSED_BWD_KEYS keys too (the entry's d > 128 check,
# FusedWideTile::BK)
FUSED_WIDE_BWD_MAX_HEAD_DIM = 128
# the fused f32 backward kernel: the same, from the entry's d > 128 check and
# F32Tile::BK, 128 keys at D <= 64 and 64 above (each key block writes one
# dQ partial)
F32_BWD_MAX_HEAD_DIM = 128
F32_BWD_KEYS = 128
F32_BWD_WIDE_KEYS = 64
# the f32 forward kernels: keys per tile of the narrow (D <= 64) and the mid
# (D <= F32_FWD_MID_MAX_HEAD_DIM) kernel and of the wide one
# (F32NarrowTile::BK, F32MidTile::BK and F32WideTile::BK in
# csrc/flash_attention_fwd.cu), the columns per chunk of D in whose order
# the wide kernel sums S (the others sum all of D in one pass), and the mid
# kernel's query rows a block by padded D (F32MidTile::BQ); all must stay
# equal to the kernels'
F32_FWD_KEYS = 64
F32_FWD_WIDE_KEYS = 128
F32_FWD_CHUNK = 64
F32_FWD_MID_MAX_HEAD_DIM = 128
F32_FWD_MID_ROWS = {80: 192, 96: 224, 112: 192, 128: 160}
# the forward's routes, indexed by the entry's FwdRoute code
FWD_ROUTES = ("cuda_cores", "tma_narrow", "tma_wide", "f32", "tma_mid", "f32_mid")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# library name -> sources under csrc/
LIBRARIES = {
    "flash_attention_fwd": ("flash_attention_fwd.cu",),
    "flash_attention_bwd": ("flash_attention_bwd.cu",),
}


def flash_attention_fwd_reference(
    q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: f32 logits -> lse -> softmax ->
    PV.

    ``q3`` ``(BH, Sq, D)``, ``k3``/``v3`` ``(BH, Sk, D)``. P is cast to V's
    dtype before the product, accumulated in f32; O comes back in Q's dtype,
    lse ``(BH, Sq)`` in f32.
    """
    logits = torch.matmul(q3.float(), k3.float().transpose(-1, -2)) * scale
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    o = torch.matmul(p.to(v3.dtype).float(), v3.float())
    return o.to(q3.dtype), lse


def flash_attention_fwd_f32_model(
    q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The f32 forward kernels' order of operations in plain torch (f32 in,
    f32 out): key tiles of ``F32_FWD_KEYS`` (``F32_FWD_WIDE_KEYS`` at D >
    ``F32_FWD_MID_MAX_HEAD_DIM``) in order; per tile S = Q K^T over all of
    D in column order in one pass (at D > ``F32_FWD_MID_MAX_HEAD_DIM``
    summed over ``F32_FWD_CHUNK``-column chunks in chunk order); the running
    row max m, P = exp2(S c - m c) with c = scale log2 e, O and l rescaled
    by exp2(m_old c - m c) before P V and P's row sum are added; at the end
    O = O / l and lse = (m c + log2 l) ln 2, l == 0 taken as 1. A model for
    the CPU tests; CUDA tensors take the kernels through
    ``flash_attention_fwd``."""
    c = scale * 1.4426950408889634
    bh, sq, d = q3.shape
    m = torch.full((bh, sq, 1), -1e30, dtype=torch.float32, device=q3.device)
    l = torch.zeros((bh, sq, 1), dtype=torch.float32, device=q3.device)
    acc = torch.zeros((bh, sq, d), dtype=torch.float32, device=q3.device)
    keys = F32_FWD_KEYS if d <= F32_FWD_MID_MAX_HEAD_DIM else F32_FWD_WIDE_KEYS
    chunk = d if d <= F32_FWD_MID_MAX_HEAD_DIM else F32_FWD_CHUNK
    for k0 in range(0, k3.shape[1], keys):
        kb, vb = k3[:, k0:k0 + keys], v3[:, k0:k0 + keys]
        s = torch.matmul(q3[..., :chunk], kb[..., :chunk].transpose(-1, -2))
        for c0 in range(chunk, d, chunk):
            s = s + torch.matmul(q3[..., c0:c0 + chunk], kb[..., c0:c0 + chunk].transpose(-1, -2))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        ms = m_new * c
        corr = torch.exp2(m * c - ms)
        p = torch.exp2(s * c - ms)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.matmul(p, vb)
        m = m_new
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    return acc / safe_l, ((m * c + torch.log2(safe_l)) * 0.6931471805599453)[..., 0]


def f32_bwd_keys(d: int) -> int:
    """Keys per block of the fused f32 backward at head dim ``d``: one dQ
    partial each."""
    return F32_BWD_KEYS if d <= 64 else F32_BWD_WIDE_KEYS


def flash_attention_bwd_reference(
    q3: torch.Tensor,
    k3: torch.Tensor,
    v3: torch.Tensor,
    do3: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels, in the TPU kernels' numerics:
    P = exp(S * scale - lse), dV = P^T dO with P cast to dO's dtype,
    dS = P (dO V^T - delta), dQ = scale dS K and dK = scale dS^T Q with dS
    cast to K's/Q's dtype; f32 accumulation. Returns dQ, dK, dV in Q's, K's
    and V's dtypes."""
    qf, kf, vf, dof = q3.float(), k3.float(), v3.float(), do3.float()
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale - lse[..., None])
    dv = torch.matmul(p.to(do3.dtype).float().transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta[..., None])
    dq = scale * torch.matmul(ds.to(k3.dtype).float(), kf)
    dk = scale * torch.matmul(ds.to(q3.dtype).float().transpose(-1, -2), qf)
    return dq.to(q3.dtype), dk.to(k3.dtype), dv.to(v3.dtype)


def flash_attention_bwd_f32_fused_model(
    q3: torch.Tensor,
    k3: torch.Tensor,
    v3: torch.Tensor,
    do3: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused f32 kernel's order of operations in plain torch (f32 in,
    f32 out): per block of ``f32_bwd_keys(D)`` keys (128 at D <= 64, 64
    above), P = exp2(S scale log2 e - lse log2 e) and dS = P (dO V^T -
    delta); the block's dK and dV over all queries; its dQ partial: at D <=
    64 the sum of its two 64-key halves' dS K, above dS K over its 64 keys.
    dQ is scale times the partials summed in key-block order. A model for
    the CPU tests; CUDA tensors take the kernel through
    ``flash_attention_bwd``."""
    log2e = 1.4426950408889634
    lse2 = lse[..., None] * log2e
    keys = f32_bwd_keys(q3.shape[-1])
    dks, dvs, dq = [], [], None
    for k0 in range(0, k3.shape[1], keys):
        kb, vb = k3[:, k0:k0 + keys], v3[:, k0:k0 + keys]
        p = torch.exp2(torch.matmul(q3, kb.transpose(-1, -2)) * (scale * log2e) - lse2)
        ds = p * (torch.matmul(do3, vb.transpose(-1, -2)) - delta[..., None])
        if keys == F32_BWD_WIDE_KEYS:  # one 64-key block
            part = torch.matmul(ds, kb)
        else:  # two 64-key halves
            part = torch.matmul(ds[..., :64], kb[:, :64]) + torch.matmul(ds[..., 64:], kb[:, 64:])
        dq = part if dq is None else dq + part
        dvs.append(torch.matmul(p.transpose(-1, -2), do3))
        dks.append(torch.matmul(ds.transpose(-1, -2), q3) * scale)
    return dq * scale, torch.cat(dks, 1), torch.cat(dvs, 1)


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


def _check_bwd(q3, k3, v3, do3, lse, delta) -> None:
    _check(q3, k3, v3)
    if do3.shape != q3.shape or do3.dtype != q3.dtype or not do3.is_contiguous():
        raise ValueError(
            f"dO must be contiguous, shaped and typed as q {tuple(q3.shape)} {q3.dtype}; "
            f"got {tuple(do3.shape)} {do3.dtype}"
        )
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q3.shape[:2] or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 (B*H, Sq)")
    if not (do3.device == lse.device == delta.device == q3.device):
        raise ValueError("q, dO, lse and delta must be on one device")


_FUNCTIONS = {
    # name: (library, argtypes)
    "flash_attention_fwd": (
        "flash_attention_fwd",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p],
    ),
    "flash_attention_fwd_cuda_cores": (
        "flash_attention_fwd",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    ),
    "flash_attention_fwd_tma_wide": (
        "flash_attention_fwd",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p],
    ),
    "flash_attention_fwd_f32_wide": (
        "flash_attention_fwd",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p],
    ),
    "flash_attention_bwd_dq": (
        "flash_attention_bwd",
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    ),
    "flash_attention_bwd_dkv": (
        "flash_attention_bwd",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    ),
    "flash_attention_bwd_fused": (
        "flash_attention_bwd",
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p],
    ),
    "flash_attention_bwd_f32_fused": (
        "flash_attention_bwd",
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p],
    ),
    "flash_attention_bwd_fused_wide": (
        "flash_attention_bwd",
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p],
    ),
}


def _function(name: str):
    library, argtypes = _FUNCTIONS[name]
    fn = getattr(load_library(library, LIBRARIES[library]), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def launch_work(name: str, shape: Sequence) -> Work:
    """The work of one launch of wrapper ``name`` at its shape key (bh, sq,
    sk, d, dtype[, route]), as ``utils.roofline.attention_work`` counts it:
    the forward reads Q, K, V and writes O and the lse; the fused backwards
    (bf16 at D <= 64 and above, f32) do 5 products (S, dO V^T, P^T dO, dS^T
    Q, dS K) and the exps once, reading Q, K, V, dO, lse and delta and
    writing dQ, dK and dV, the bf16 ones also writing and reading their f32
    dQ buffer, the f32 one its dQ
    partials (one f32 (bh, sq, d) tensor per block of ``f32_bwd_keys(d)``
    keys); the CUDA-core pair K2 (3 products, dQ) and K3 (4, dK and dV)."""
    bh, sq, sk, d, dtype = shape[:5]
    args = {
        "flash_attention_fwd": dict(reads_q=1, writes_q=1),
        "flash_attention_fwd_cuda_cores": dict(reads_q=1, writes_q=1),
        "flash_attention_fwd_tma_wide": dict(reads_q=1, writes_q=1),
        "flash_attention_fwd_f32_wide": dict(reads_q=1, writes_q=1),
        "flash_attention_bwd_fused": dict(products=5, writes_q=1, writes_k=2, stats=2, f32_q=2),
        "flash_attention_bwd_fused_wide": dict(products=5, writes_q=1, writes_k=2, stats=2, f32_q=2),
        "flash_attention_bwd_f32_fused": dict(products=5, writes_q=1, writes_k=2, stats=2,
                                              f32_q=2 * -(-sk // f32_bwd_keys(d))),
        "flash_attention_bwd_dq": dict(products=3, stats=2, writes_q=1),
        "flash_attention_bwd_dkv": dict(products=4, stats=2, writes_k=2),
    }[name]
    return attention_work(bh, sq, sk, d, dtype, **args)


def _launch(name: str, q3: torch.Tensor, k3: torch.Tensor, *args, route: Optional[str] = None) -> None:
    """Call kernel entry ``name`` on the current stream of q's device (under
    a profiler, inside ``annotate_launch`` with its shape and work) and count the
    launch (total and by shape) on its wrapper. ``route``: the
    forward's, which its entry reports back (an argument before the stream)
    and which must be the one it took; then the launch is counted by route
    too, and the route ends the shape key."""
    bh, sq, d = q3.shape
    sk = k3.shape[1]
    shape = (bh, sq, sk, d, str(q3.dtype).replace("torch.", "")) + (() if route is None else (route,))
    taken = ctypes.c_int(-1)
    reported = () if route is None else (ctypes.byref(taken),)
    with torch.cuda.device(q3.device), annotate_launch(name, shape, lambda: launch_work(name, shape)):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _function(name)(*args, *reported, stream)
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed: cudaError {rc} "
            f"(q {tuple(q3.shape)}, k {tuple(k3.shape)}, {q3.dtype})"
        )
    if route is not None and FWD_ROUTES[taken.value] != route:
        raise RuntimeError(f"{name} took route {FWD_ROUTES[taken.value]}, forward_route gives {route}")
    wrapper = _WRAPPERS[name]
    wrapper.launches += 1
    wrapper.launches_by_shape[shape] = wrapper.launches_by_shape.get(shape, 0) + 1
    if route is not None:
        wrapper.launches_by_route[route] = wrapper.launches_by_route.get(route, 0) + 1


def _on_cuda(name: str, t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {t.device}")
    return True


def flash_attention_fwd(
    q3: torch.Tensor,
    k3: torch.Tensor,
    v3: torch.Tensor,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """O ``(BH, Sq, D)`` in Q's dtype and lse ``(BH, Sq)`` f32.

    ``scale`` defaults to ``D**-0.5``. Launches the kernel of
    ``forward_route`` on the current stream for CUDA tensors (counted in
    ``flash_attention_fwd.launches`` and ``.launches_by_route``); CPU
    tensors take ``flash_attention_fwd_reference``.
    """
    _check(q3, k3, v3)
    if scale is None:
        scale = q3.shape[-1] ** -0.5
    if not _on_cuda("flash_attention_fwd", q3):
        return flash_attention_fwd_reference(q3, k3, v3, scale)
    bh, sq, d = q3.shape
    o = torch.empty_like(q3)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q3.device)
    _launch(
        "flash_attention_fwd", q3, k3,
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o.data_ptr(), lse.data_ptr(),
        bh, sq, k3.shape[1], d, float(scale), _DTYPE_CODES[q3.dtype], route=forward_route(q3, k3, v3),
    )
    return o, lse


def forward_route(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor) -> str:
    """The forward kernel ``flash_attention_fwd`` launches for these CUDA
    tensors (the C entry makes the same choice and reports it): bf16 with
    D % 8 == 0 ``"tma_narrow"`` (D <= 64), ``"tma_mid"`` (64 < D <= 128) or
    ``"tma_wide"`` (tensor cores), f32 with D % 4 == 0 ``"f32_mid"`` (64 < D
    <= 128) or ``"f32"`` (the narrow and the wide f32 CUDA-core kernels),
    each with every base 16-byte aligned; anything else ``"cuda_cores"``
    (the older CUDA-core kernel)."""
    d = q3.shape[-1]
    aligned = all(t.data_ptr() % 16 == 0 for t in (q3, k3, v3))
    if q3.dtype == torch.bfloat16 and aligned and d % 8 == 0:
        return "tma_narrow" if d <= 64 else "tma_mid" if d <= 128 else "tma_wide"
    if q3.dtype == torch.float32 and aligned and d % 4 == 0:
        return "f32_mid" if 64 < d <= F32_FWD_MID_MAX_HEAD_DIM else "f32"
    return "cuda_cores"


def flash_attention_fwd_cuda_cores(q3, k3, v3, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """O and lse from the older CUDA-core kernel on any input, whatever its
    route: the kernel the f32 and bf16 routes replaced, to compare with them
    on the same inputs. Counted in ``flash_attention_fwd_cuda_cores.launches``.
    CUDA tensors only."""
    _check(q3, k3, v3)
    if not _on_cuda("flash_attention_fwd_cuda_cores", q3):
        raise ValueError("flash_attention_fwd_cuda_cores launches the CUDA kernel: CUDA tensors only")
    bh, sq, d = q3.shape
    o = torch.empty_like(q3)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q3.device)
    _launch(
        "flash_attention_fwd_cuda_cores", q3, k3,
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o.data_ptr(), lse.data_ptr(),
        bh, sq, k3.shape[1], d, float(scale), _DTYPE_CODES[q3.dtype],
    )
    return o, lse


def flash_attention_fwd_tma_wide(q3, k3, v3, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """O and lse from the wide bf16 tensor-core kernel (route ``"tma_wide"``'s,
    D padded to 128 at 64 < D <= 128), whatever the route: the kernel
    ``"tma_mid"`` replaced at 64 < D <= 128, to compare with it on the same
    inputs. Counted in ``flash_attention_fwd_tma_wide.launches``. bf16 CUDA
    tensors with D % 8 == 0, 64 < D and 16-byte aligned bases only."""
    _check(q3, k3, v3)
    if not _on_cuda("flash_attention_fwd_tma_wide", q3):
        raise ValueError("flash_attention_fwd_tma_wide launches the CUDA kernel: CUDA tensors only")
    d = q3.shape[-1]
    if forward_route(q3, k3, v3) not in ("tma_mid", "tma_wide"):
        raise ValueError(
            f"flash_attention_fwd_tma_wide takes bf16 with D % 8 == 0, D > 64 and 16-byte aligned bases; "
            f"got {q3.dtype}, D = {d}"
        )
    bh, sq, _ = q3.shape
    o = torch.empty_like(q3)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q3.device)
    _launch(
        "flash_attention_fwd_tma_wide", q3, k3,
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o.data_ptr(), lse.data_ptr(),
        bh, sq, k3.shape[1], d, float(scale),
    )
    return o, lse


def flash_attention_fwd_f32_wide(q3, k3, v3, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """O and lse from the wide f32 CUDA-core kernel (route ``"f32"``'s above
    D = 128, D padded to 128 at 64 < D <= 128), whatever the route: the
    kernel ``"f32_mid"`` replaced at 64 < D <= 128, to compare with it on
    the same inputs. Counted in ``flash_attention_fwd_f32_wide.launches``.
    f32 CUDA tensors with D % 4 == 0, 64 < D and 16-byte aligned bases only."""
    _check(q3, k3, v3)
    if not _on_cuda("flash_attention_fwd_f32_wide", q3):
        raise ValueError("flash_attention_fwd_f32_wide launches the CUDA kernel: CUDA tensors only")
    d = q3.shape[-1]
    if forward_route(q3, k3, v3) not in ("f32_mid", "f32") or d <= 64:
        raise ValueError(
            f"flash_attention_fwd_f32_wide takes f32 with D % 4 == 0, D > 64 and 16-byte aligned bases; "
            f"got {q3.dtype}, D = {d}"
        )
    bh, sq, _ = q3.shape
    o = torch.empty_like(q3)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q3.device)
    _launch(
        "flash_attention_fwd_f32_wide", q3, k3,
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o.data_ptr(), lse.data_ptr(),
        bh, sq, k3.shape[1], d, float(scale),
    )
    return o, lse


def flash_attention_bwd_dq(q3, k3, v3, do3, lse, delta, scale: float) -> torch.Tensor:
    """dQ ``(BH, Sq, D)`` in Q's dtype from the CUDA-core kernel (K2's
    route off the fused kernels), counted in
    ``flash_attention_bwd_dq.launches``. CUDA tensors only."""
    _check_bwd(q3, k3, v3, do3, lse, delta)
    if not _on_cuda("flash_attention_bwd_dq", q3):
        raise ValueError("flash_attention_bwd_dq launches the CUDA kernel: CUDA tensors only")
    bh, sq, d = q3.shape
    dq = torch.empty_like(q3)
    _launch(
        "flash_attention_bwd_dq", q3, k3,
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), bh, sq, k3.shape[1], d, float(scale),
        _DTYPE_CODES[q3.dtype],
    )
    return dq


def flash_attention_bwd_dkv(q3, k3, v3, do3, lse, delta, scale: float):
    """dK and dV ``(BH, Sk, D)`` in K's and V's dtypes from the CUDA-core
    kernel (K3's route off the fused kernels), counted in
    ``flash_attention_bwd_dkv.launches``. CUDA tensors only."""
    _check_bwd(q3, k3, v3, do3, lse, delta)
    if not _on_cuda("flash_attention_bwd_dkv", q3):
        raise ValueError("flash_attention_bwd_dkv launches the CUDA kernel: CUDA tensors only")
    bh, sq, d = q3.shape
    dk = torch.empty_like(k3)
    dv = torch.empty_like(v3)
    _launch(
        "flash_attention_bwd_dkv", q3, k3,
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, sq, k3.shape[1], d,
        float(scale), _DTYPE_CODES[q3.dtype],
    )
    return dk, dv


def takes_fused_backward(q3, k3, v3, do3) -> bool:
    """Whether ``flash_attention_bwd`` sends these CUDA tensors to the fused
    kernel: bf16, D % 8 == 0, D <= ``FUSED_BWD_MAX_HEAD_DIM``, every base
    16-byte aligned (the tensor maps and the bulk adds need it)."""
    return _takes_bf16(q3, k3, v3, do3, 0, FUSED_BWD_MAX_HEAD_DIM)


def _takes_bf16(q3, k3, v3, do3, above: int, up_to: int) -> bool:
    d = q3.shape[-1]
    return (
        q3.dtype == torch.bfloat16 and d % 8 == 0 and above < d <= up_to
        and all(t.data_ptr() % 16 == 0 for t in (q3, k3, v3, do3))
    )


def flash_attention_bwd_fused(q3, k3, v3, do3, lse, delta, scale: float):
    """dQ, dK, dV in bf16 from the fused kernel (K2 and K3 in one), counted
    in ``flash_attention_bwd_fused.launches``; the dQ buffer it adds into is
    zeroed here. CUDA tensors that ``takes_fused_backward`` accepts only."""
    return _fused_bf16("flash_attention_bwd_fused", takes_fused_backward, f"D <= {FUSED_BWD_MAX_HEAD_DIM}",
                       q3, k3, v3, do3, lse, delta, scale)


def takes_fused_wide_backward(q3, k3, v3, do3) -> bool:
    """Whether ``flash_attention_bwd`` sends these CUDA tensors to the fused
    kernel for wide heads: bf16, D % 8 == 0, ``FUSED_BWD_MAX_HEAD_DIM`` < D
    <= ``FUSED_WIDE_BWD_MAX_HEAD_DIM``, every base 16-byte aligned."""
    return _takes_bf16(q3, k3, v3, do3, FUSED_BWD_MAX_HEAD_DIM, FUSED_WIDE_BWD_MAX_HEAD_DIM)


def flash_attention_bwd_fused_wide(q3, k3, v3, do3, lse, delta, scale: float):
    """dQ, dK, dV in bf16 from the fused kernel for wide heads (K2 and K3 in
    one), counted in ``flash_attention_bwd_fused_wide.launches``; the dQ
    buffer it adds into is zeroed here. CUDA tensors that
    ``takes_fused_wide_backward`` accepts only."""
    return _fused_bf16(
        "flash_attention_bwd_fused_wide", takes_fused_wide_backward,
        f"{FUSED_BWD_MAX_HEAD_DIM} < D <= {FUSED_WIDE_BWD_MAX_HEAD_DIM}", q3, k3, v3, do3, lse, delta, scale,
    )


def _fused_bf16(name, takes, head_dims, q3, k3, v3, do3, lse, delta, scale):
    _check_bwd(q3, k3, v3, do3, lse, delta)
    if not _on_cuda(name, q3):
        raise ValueError(f"{name} launches the CUDA kernel: CUDA tensors only")
    if not takes(q3, k3, v3, do3):
        raise ValueError(
            f"{name} takes bf16 with D % 8 == 0, {head_dims} and 16-byte aligned bases; "
            f"got {q3.dtype}, D = {q3.shape[-1]}"
        )
    bh, sq, d = q3.shape
    dq_acc = torch.zeros((bh, sq, d), dtype=torch.float32, device=q3.device)
    dq = torch.empty_like(q3)
    dk = torch.empty_like(k3)
    dv = torch.empty_like(v3)
    _launch(
        name, q3, k3,
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        bh, sq, k3.shape[1], d, float(scale),
    )
    return dq, dk, dv


def takes_f32_fused_backward(q3, k3, v3, do3) -> bool:
    """Whether ``flash_attention_bwd`` sends these CUDA tensors to the fused
    f32 kernel: f32, D % 4 == 0, D <= ``F32_BWD_MAX_HEAD_DIM`` (128), every
    base 16-byte aligned (its 16-byte copies need it)."""
    d = q3.shape[-1]
    return (
        q3.dtype == torch.float32 and d % 4 == 0 and d <= F32_BWD_MAX_HEAD_DIM
        and all(t.data_ptr() % 16 == 0 for t in (q3, k3, v3, do3))
    )


def backward_route(q3, k3, v3, do3) -> str:
    """The backward kernel(s) ``flash_attention_bwd`` launches for these CUDA
    tensors: ``"fused"`` (bf16, tensor cores, D <= 64), ``"fused_wide"``
    (bf16, tensor cores, 64 < D <= 128), ``"f32_fused"`` (f32, CUDA cores,
    one fused kernel, D <= 128) or ``"cuda_cores"`` (the dQ and dK/dV pair,
    for what no fused kernel takes)."""
    if takes_fused_backward(q3, k3, v3, do3):
        return "fused"
    if takes_fused_wide_backward(q3, k3, v3, do3):
        return "fused_wide"
    if takes_f32_fused_backward(q3, k3, v3, do3):
        return "f32_fused"
    return "cuda_cores"


def flash_attention_bwd_f32_fused(q3, k3, v3, do3, lse, delta, scale: float):
    """dQ, dK, dV in f32 from the fused f32 kernel (K2 and K3 in one) and its
    dQ sum, counted in ``flash_attention_bwd_f32_fused.launches``; the dQ
    partials' scratch ``(ceil(Sk / f32_bwd_keys(D)), BH, Sq, D)`` is
    allocated here. Deterministic: the same inputs give bitwise the same
    grads. CUDA tensors that ``takes_f32_fused_backward`` accepts only."""
    _check_bwd(q3, k3, v3, do3, lse, delta)
    if not _on_cuda("flash_attention_bwd_f32_fused", q3):
        raise ValueError("flash_attention_bwd_f32_fused launches the CUDA kernel: CUDA tensors only")
    if not takes_f32_fused_backward(q3, k3, v3, do3):
        raise ValueError(
            f"flash_attention_bwd_f32_fused takes f32 with D % 4 == 0, D <= {F32_BWD_MAX_HEAD_DIM} and "
            f"16-byte aligned bases; got {q3.dtype}, D = {q3.shape[-1]}"
        )
    bh, sq, d = q3.shape
    sk = k3.shape[1]
    dq_part = torch.empty((-(-sk // f32_bwd_keys(d)), bh, sq, d), dtype=torch.float32, device=q3.device)
    dq = torch.empty_like(q3)
    dk = torch.empty_like(k3)
    dv = torch.empty_like(v3)
    _launch(
        "flash_attention_bwd_f32_fused", q3, k3,
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq_part.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        bh, sq, sk, d, float(scale),
    )
    return dq, dk, dv


def flash_attention_bwd(q3, k3, v3, do3, lse, delta, scale: float):
    """dQ, dK, dV: for CUDA tensors the kernel(s) of ``backward_route``;
    ``flash_attention_bwd_reference`` for CPU tensors."""
    _check_bwd(q3, k3, v3, do3, lse, delta)
    if not _on_cuda("flash_attention_bwd", q3):
        return flash_attention_bwd_reference(q3, k3, v3, do3, lse, delta, scale)
    route = backward_route(q3, k3, v3, do3)
    if route == "fused":
        return flash_attention_bwd_fused(q3, k3, v3, do3, lse, delta, scale)
    if route == "fused_wide":
        return flash_attention_bwd_fused_wide(q3, k3, v3, do3, lse, delta, scale)
    if route == "f32_fused":
        return flash_attention_bwd_f32_fused(q3, k3, v3, do3, lse, delta, scale)
    dq = flash_attention_bwd_dq(q3, k3, v3, do3, lse, delta, scale)
    dk, dv = flash_attention_bwd_dkv(q3, k3, v3, do3, lse, delta, scale)
    return dq, dk, dv


_WRAPPERS = {
    "flash_attention_fwd": flash_attention_fwd,
    "flash_attention_fwd_cuda_cores": flash_attention_fwd_cuda_cores,
    "flash_attention_fwd_tma_wide": flash_attention_fwd_tma_wide,
    "flash_attention_fwd_f32_wide": flash_attention_fwd_f32_wide,
    "flash_attention_bwd_dq": flash_attention_bwd_dq,
    "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
    "flash_attention_bwd_fused": flash_attention_bwd_fused,
    "flash_attention_bwd_f32_fused": flash_attention_bwd_f32_fused,
    "flash_attention_bwd_fused_wide": flash_attention_bwd_fused_wide,
}


def reset_launch_counts() -> None:
    for wrapper in _WRAPPERS.values():
        wrapper.launches = 0
        wrapper.launches_by_shape = {}
        wrapper.launches_by_route = {}


reset_launch_counts()


class FlashAttention(torch.autograd.Function):
    """O = softmax(q k^T scale) v over folded ``(BH, S, D)`` tensors, with the
    flash kernels as forward and backward. Saves q, k, v, O and lse, as the
    JAX package's ``_flash_fwd`` does."""

    @staticmethod
    def forward(ctx, q3, k3, v3, scale):
        o, lse = flash_attention_fwd(q3, k3, v3, scale)
        ctx.save_for_backward(q3, k3, v3, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do3):
        q3, k3, v3, o, lse = ctx.saved_tensors
        do3 = do3.to(q3.dtype).contiguous()
        delta = (do3.float() * o.float()).sum(-1)
        dq, dk, dv = flash_attention_bwd(q3, k3, v3, do3, lse, delta, ctx.scale)
        return dq, dk, dv, None


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
    """Flash attention over ``(B, S, H, D)`` tensors, differentiable through
    the backward kernels; numerics match
    ``ops.attention.dot_product_attention``."""
    b, _, h, d = query.shape
    if scale is None:
        scale = d**-0.5
    o = FlashAttention.apply(
        _fold_heads(query), _fold_heads(key), _fold_heads(value), float(scale)
    )
    return _unfold_heads(o, b, h)
