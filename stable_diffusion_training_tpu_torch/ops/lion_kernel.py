"""Fused 8-bit Lion update: the CUDA kernels' wrappers and their plain versions.

Port of ``stable_diffusion_training_tpu/ops/lion_kernel.py``. The TPU has
four layouts of the same update (dense, transposed, narrow, wide), each
shaped by its lane tiling; the card needs none of them. The port keeps one
layout of the momentum, the reference order of ``lion_quant.py``: codes
``(n_blocks, bs)`` int8 and scales ``(n_blocks,)`` f32 per leaf, over the
JAX leaf's flat element order. ``csrc/lion8bit_update.cu`` computes the
update (see its header for the math, the numerics it keeps and the two
kernels' designs) with two kernels behind four entries:

- ``lion8bit_update_leaves_`` (the role of the TPU's
  ``fused_lion8bit_update_dense``, K4, and
  ``fused_lion8bit_update_transposed_packed``, K5, on the train step):
  ``lion_leaves_kernel``, every leaf of a ``LeafTable`` in one launch,
  grads and update signs in torch layout; the table is built once per
  optimizer state;
- ``lion8bit_update_`` (K4's single-leaf entry): ``lion_stream_kernel`` on
  one leaf, the grad in JAX order; the train step sends it only a leaf the
  table cannot take (the FSDP and TP ranks' whole leaves among them);
- ``lion8bit_update_multi_`` (K5's multi-leaf entry): ``lion_stream_kernel``
  on many leaves in JAX order in one launch, through a leaf list built per
  call;
- ``fused_lion8bit_update`` (the TPU's public single-leaf entry, K6 with
  ``layout="narrow"`` and K7 with ``layout="wide"``): functional, with the
  JAX signature, scales ``(n_blocks, 1)``; both layouts hold the same
  ``(n_blocks, bs)`` bytes, so both launch ``lion_stream_kernel`` on a
  list of one.

``stream_tile_elements`` is the stream kernel's tile (the multi-leaf entry
cuts its leaf list by it; the library refuses any other) and
``stream_tiles`` models the kernel's tiles in plain Python for the CPU tests.

The in-place entries update codes and scales and return the update sign in
the grad's dtype. CPU tensors take the plain versions
(``lion8bit_update_reference``, ``lion8bit_update_leaves_reference``); CUDA
tensors take the kernel or raise.
"""

import array
import ctypes
import math
import operator
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..utils.profiling import annotate_launch
from ..utils.roofline import Work, lion_bytes
from .cuda_build import load_library

LIBRARIES = {"lion8bit_update": ("lion8bit_update.cu",)}
# offset ensuring x = 0 round-trips to exactly 0 through the odd-power compander
ZERO_CROSSING_OFFSET = 3.7398995e-09
POW5_C = float(127.0**-5)  # the fast compander's folded (q/127)^5 constant
# block sizes the kernels are built for
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
    """One launch of ``lion_stream_kernel`` over one checked CUDA leaf (the
    leaf by value); returns the update sign. Counting is the calling
    entry's."""
    nb, bs = codes.shape
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
    shaped and typed like ``grad`` (JAX flat order). ``lion_stream_kernel``
    (counted in ``lion8bit_update_.launches``) for CUDA tensors, the plain
    version for CPU tensors."""
    _check_leaf(grad, codes, scales)
    fast = fast_compander(compander)
    nb, bs = codes.shape
    if not _on_cuda(grad, bs):
        upd, new_codes, new_scales = lion8bit_update_reference(grad, codes, scales, b1, b2, compander)
        codes.copy_(new_codes)
        scales.copy_(new_scales)
        return upd
    with _annotate("lion8bit_update_", (nb, bs, grad.dtype)):
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
    """Update many leaves of one block size and grad dtype in one launch of
    ``lion_stream_kernel`` (counted in ``lion8bit_update_multi_.launches``);
    per leaf as ``lion8bit_update_``. CPU tensors take the plain version
    leaf by leaf."""
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
    dtype_code = _DTYPE_CODES[grads[0].dtype]
    n_blocks = [c.shape[0] for c in codes]
    tile_elems = stream_tile_elements(bs, grads[0].element_size())
    tile_offsets = stream_tile_offsets(n_blocks, tile_elems // bs)
    device = grads[0].device
    # the leaf list (csrc StreamLeaf: 4 pointers and the block count per
    # leaf, then the tile offsets) goes over from pinned memory without
    # waiting: a copy from pageable memory would first wait for all the work
    # queued on the device
    host = torch.tensor(
        [v for g, c, s, u in zip(grads, codes, scales, updates)
         for v in (g.data_ptr(), c.data_ptr(), s.data_ptr(), u.data_ptr(), c.shape[0])] + tile_offsets,
        dtype=torch.int64,
    ).pin_memory()
    table = host.to(device, non_blocking=True)
    key = (len(grads), sum(n_blocks), bs, grads[0].dtype)
    fn = _function(
        "lion8bit_update_multi",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int] + _COMMON_ARGS,
    )
    with torch.cuda.device(device), _annotate("lion8bit_update_multi_", key):
        rc = fn(
            table.data_ptr(), table[5 * len(grads):].data_ptr(), len(grads), tile_offsets[-1], tile_elems, bs,
            *_coefs(b1, b2), int(fast), dtype_code, torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"lion8bit_update_multi launch failed: cudaError {rc} ({len(grads)} leaves)")
    _count(lion8bit_update_multi_, key)
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
    tile height and has no effect on the card. CUDA tensors launch
    ``lion_stream_kernel`` on a list of one (block sizes ``BLOCK_SIZES``;
    others raise) and are counted in
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
    if flat.data_ptr() % 16:  # a view at an odd offset: bulk copies need 16-byte aligned runs
        flat = flat.clone()
    _check_leaf(flat, new_codes, new_scales)
    if _on_cuda(flat, bs):
        with _annotate("fused_lion8bit_update", (layout, nb, bs, grad.dtype)):
            upd = _launch_single(flat, new_codes, new_scales, b1, b2, fast)
        _count(fused_lion8bit_update, (layout, nb, bs, grad.dtype))
    else:
        upd, new_codes, new_scales = lion8bit_update_reference(flat, codes, new_scales, b1, b2, compander)
    return upd.reshape(grad.shape), new_codes, new_scales.reshape(nb, 1).to(mu_scale_dtype)


# --- lion_stream_kernel's tiles, in plain Python ----------------------------

STREAM_STAGE_BYTES = 16384  # csrc/lion8bit_update.cu kStageBytes


def stream_tile_elements(bs: int, itemsize: int) -> int:
    """Elements of one ``lion_stream_kernel`` tile (``StreamTile::kElems``):
    the largest power of two of whole blocks whose grads, codes and scales
    fit ``STREAM_STAGE_BYTES``. ``lion8bit_update_multi_`` passes it with
    every launch, and the library refuses a tile other than its own."""
    fit = STREAM_STAGE_BYTES // (bs * (itemsize + 1) + 4) * bs
    return 1 << (fit.bit_length() - 1)


def stream_tile_offsets(n_blocks: Sequence[int], blocks_per_tile: int) -> List[int]:
    """Each leaf's first tile and, last, the tile count: the kernel's leaf
    list's prefix sums."""
    offsets = [0]
    for nb in n_blocks:
        offsets.append(offsets[-1] + -(-nb // blocks_per_tile))
    return offsets


def stream_tiles(n_blocks: Sequence[int], bs: int, itemsize: int, bases: Sequence[Sequence[int]]):
    """The kernel's tiles over a leaf list (``tile_desc``), in tile order:
    ``(leaf, first block, blocks, bulk)``; ``bases`` holds each leaf's
    (grad, codes, scales, signs) byte addresses. A tile moves by bulk copies
    when its runs (grads, codes, scales, signs) are all 16-byte sized and
    aligned, else by plain loads."""
    per_tile = stream_tile_elements(bs, itemsize) // bs
    offsets = stream_tile_offsets(n_blocks, per_tile)
    tiles = []
    for tile in range(offsets[-1]):
        leaf = max(i for i in range(len(n_blocks)) if offsets[i] <= tile)  # the kernel's binary search
        b0 = (tile - offsets[leaf]) * per_tile
        blocks = min(per_tile, n_blocks[leaf] - b0)
        g, c, s, u = bases[leaf]
        starts = (g + b0 * bs * itemsize, c + b0 * bs, s + b0 * 4, u + b0 * bs * itemsize)
        bulk = (blocks * bs * itemsize) % 16 == 0 and (blocks * bs) % 16 == 0 and blocks % 4 == 0 and all(
            a % 16 == 0 for a in starts)
        tiles.append((leaf, b0, blocks, bulk))
    return tiles


# --- every leaf of a model in one launch, in torch layout -------------------

# lion_leaves_kernel's tile at each block size: (JAX blocks per torch column,
# torch columns); csrc/lion8bit_update.cu LeafTile, read back from the
# library (lion8bit_leaf_tile) before the first launch
LEAF_TILE = {1: (4, 64), 2: (4, 64), 4: (4, 64), 8: (4, 64), 16: (4, 64), 32: (2, 64), 64: (1, 64),
             128: (1, 32)}
MAX_LEAVES_PER_LAUNCH = 1024  # the kernel's by-value grad pointers (kMaxLeaves)
# the torch-to-JAX permutations whose JAX block is bs output channels at one
# torch column: Dense (O, I) -> (I, O), Conv (O, I, kh, kw) -> (kh, kw, I, O)
_TRANSPOSED = {2: (1, 0), 4: (2, 3, 1, 0)}


def leaf_kind(shape: Sequence[int], perm: Optional[Sequence[int]], bs: int) -> Optional[int]:
    """0: a transposed leaf the table takes, 1: a leaf whose torch and JAX
    orders agree, None: neither (the leaf keeps the single-leaf entry)."""
    if not perm or tuple(perm) == tuple(range(len(shape))):
        return 1
    if _TRANSPOSED.get(len(shape)) == tuple(perm) and shape[0] % bs == 0:
        return 0
    return None


def table_takes(shape: Sequence[int], perm: Optional[Sequence[int]], bs: int) -> bool:
    """Whether ``LeafTable`` takes a leaf of torch ``shape`` whose JAX layout
    is ``permute(perm)``: an identity, or a Dense or Conv kernel whose
    output channels (torch axis 0) ``bs`` divides."""
    return leaf_kind(shape, perm, bs) is not None


def _leaf_geometry(shape, perm, bs):
    """(kind, rows, cols, in, kk, row_tiles, tiles) of one leaf, as the
    kernel walks it (``LeafRecord``)."""
    groups, cols_per_tile = LEAF_TILE[bs]
    numel = math.prod(shape)
    kind = leaf_kind(shape, perm, bs)
    if kind is None:
        raise ValueError(f"the leaf table does not take shape {tuple(shape)} with permutation {perm} at bs {bs}")
    if kind == 1:
        n_blocks = numel // bs
        return 1, n_blocks, 1, 1, 1, 1, -(-n_blocks // (groups * cols_per_tile))
    out_ch, cols = shape[0], numel // shape[0]
    kk = cols // shape[1]
    row_tiles = -(-(out_ch // bs) // groups)
    return 0, out_ch, cols, shape[1], kk, row_tiles, row_tiles * -(-cols // cols_per_tile)


def leaf_tile_addresses(shape: Sequence[int], perm: Optional[Sequence[int]], bs: int):
    """The kernel's addressing of one leaf in plain torch: for each tile and
    each thread, the torch offsets of its ``bs`` elements and its JAX block
    (``-1`` for a thread past the leaf's edge). ``p.reshape(-1)[offsets[t,
    j]]`` is block ``blocks[t, j]`` of ``p.permute(perm).reshape(-1, bs)``.
    Returns ``(offsets (tiles, threads, bs), blocks (tiles, threads))``."""
    kind, rows, cols, in_ch, kk, row_tiles, tiles = _leaf_geometry(shape, perm, bs)
    groups, cols_per_tile = LEAF_TILE[bs]
    t = torch.arange(tiles)[:, None]
    thread = torch.arange(groups * cols_per_tile)[None, :]
    gl, cl = thread // cols_per_tile, thread % cols_per_tile
    lane = torch.arange(bs)
    if kind == 0:
        n_og = rows // bs
        og = (t % row_tiles) * groups + gl
        c = (t // row_tiles) * cols_per_tile + cl
        valid = (og < n_og) & (c < cols)
        blocks = ((c % kk) * in_ch + c // kk) * n_og + og
        offsets = (og[..., None] * bs + lane) * cols + c[..., None]
    else:
        blocks = t * (groups * cols_per_tile) + gl * cols_per_tile + cl
        valid = blocks < rows
        offsets = blocks[..., None] * bs + lane
    blocks = torch.where(valid, blocks, -1)
    return torch.where(valid[..., None], offsets, -1), blocks


class _Launch:
    """The device part of one launch: up to ``MAX_LEAVES_PER_LAUNCH`` leaves'
    records and the leaf of each tile."""

    def __init__(self, leaves: range, records: torch.Tensor, tile_leaf: torch.Tensor, elements: int):
        self.leaves, self.records, self.tile_leaf, self.elements = leaves, records, tile_leaf, elements
        self.n_tiles = tile_leaf.numel()

    def grads(self, grads: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
        return grads[self.leaves.start:self.leaves.stop]


class LeafTable:
    """Every quantized leaf of a model for ``lion8bit_update_leaves_``, built
    once per optimizer state: each leaf's codes and scales (held, and
    checked by identity on each call), its torch shape and permutation to
    the JAX layout, and on the device the kernel's leaf records and the
    leaf of each tile. The update signs of a call go into one buffer, the
    leaves of one shape next to each other so that one ``unbind`` makes
    their views."""

    def __init__(self, codes: Sequence[torch.Tensor], scales: Sequence[torch.Tensor],
                 shapes: Sequence[Sequence[int]], perms: Sequence[Optional[Sequence[int]]]):
        if not codes or not (len(codes) == len(scales) == len(shapes) == len(perms)):
            raise ValueError("need one or more leaves, each with codes, scales, a shape and a permutation")
        bs = codes[0].shape[1]
        if bs not in BLOCK_SIZES:
            raise ValueError(f"the Lion kernel takes block sizes {BLOCK_SIZES}, not {bs}")
        self.codes, self.scales = list(codes), list(scales)
        self.shapes = [torch.Size(s) for s in shapes]
        self.perms = [tuple(p) if p else None for p in perms]
        self.bs, self.device = bs, codes[0].device
        self.n_leaves = len(codes)
        for c, s, shape in zip(self.codes, self.scales, self.shapes):
            if c.dim() != 2 or c.dtype != torch.int8 or not c.is_contiguous() or c.numel() != shape.numel():
                raise ValueError(f"codes must be contiguous int8 (n_blocks, bs) of {tuple(shape)}, got "
                                 f"{tuple(c.shape)} {c.dtype}")
            if s.shape != (c.shape[0],) or s.dtype != torch.float32 or not s.is_contiguous():
                raise ValueError(f"scales must be contiguous float32 ({c.shape[0]},), got {tuple(s.shape)} {s.dtype}")
            if c.shape[1] != bs or c.device != self.device or s.device != self.device:
                raise ValueError("all leaves of a table share the block size and the device")
        self.n_tiles = sum(_leaf_geometry(shape, perm, bs)[-1] for shape, perm in zip(self.shapes, self.perms))
        # the update buffer: one run per shape, each run 16-element aligned
        by_shape: Dict[torch.Size, List[int]] = {}
        for i, shape in enumerate(self.shapes):
            by_shape.setdefault(shape, []).append(i)
        self.upd_off = [0] * self.n_leaves
        self.runs = []  # (shape, offset, leaf indices)
        offset = 0
        for shape, members in by_shape.items():
            self.runs.append((shape, offset, members))
            for j, i in enumerate(members):
                self.upd_off[i] = offset + j * shape.numel()
            offset += -(-len(members) * shape.numel() // 16) * 16
        self.upd_numel = offset
        self._launches: Optional[List[_Launch]] = None

    def matches(self, codes: Sequence[torch.Tensor], scales: Sequence[torch.Tensor]) -> bool:
        """True when ``codes`` and ``scales`` are this table's own tensors."""
        return (len(codes) == self.n_leaves
                and all(a is b for a, b in zip(codes, self.codes))
                and all(a is b for a, b in zip(scales, self.scales)))

    def launches(self) -> List[_Launch]:
        """The device records, built at the first launch (CUDA only)."""
        if self._launches is None:
            lib_tile = _leaf_tile(self.bs)
            if lib_tile != LEAF_TILE[self.bs]:
                raise RuntimeError(f"LEAF_TILE[{self.bs}] = {LEAF_TILE[self.bs]}, the kernel's tile is {lib_tile}")
            for name, t in (("codes", self.codes), ("scales", self.scales)):
                if any(x.data_ptr() % 16 for x in t):
                    raise ValueError(f"{name} must be 16-byte aligned for the Lion kernel's vector loads")
            self._launches = []
            for start in range(0, self.n_leaves, MAX_LEAVES_PER_LAUNCH):
                leaves = range(start, min(start + MAX_LEAVES_PER_LAUNCH, self.n_leaves))
                rows, tiles, tile0 = [], [], 0
                for i in leaves:
                    kind, n_rows, cols, in_ch, kk, row_tiles, n_tiles = _leaf_geometry(
                        self.shapes[i], self.perms[i], self.bs)
                    # csrc LeafRecord: ten int64
                    rows.append([self.codes[i].data_ptr(), self.scales[i].data_ptr(), self.upd_off[i], tile0,
                                 n_rows, cols, in_ch, kk, row_tiles, kind])
                    tiles.append(n_tiles)
                    tile0 += n_tiles
                records = torch.tensor(rows, dtype=torch.int64).to(self.device)
                tile_leaf = torch.repeat_interleave(
                    torch.arange(len(leaves), dtype=torch.int32), torch.tensor(tiles)).to(self.device)
                self._launches.append(_Launch(leaves, records, tile_leaf,
                                              sum(self.shapes[i].numel() for i in leaves)))
        return self._launches

    def views(self, buffer: torch.Tensor) -> List[torch.Tensor]:
        """Each leaf's update, in torch shape, in the leaves' order."""
        out: List[Optional[torch.Tensor]] = [None] * self.n_leaves
        for shape, offset, members in self.runs:
            run = buffer.as_strided((len(members), *shape), (shape.numel(), *_contiguous_strides(shape)), offset)
            for i, view in zip(members, run.unbind(0)):
                out[i] = view
        return out


def _contiguous_strides(shape: Sequence[int]) -> Tuple[int, ...]:
    strides, step = [], 1
    for n in reversed(shape):
        strides.append(step)
        step *= n
    return tuple(reversed(strides))


def _leaf_tile(bs: int) -> Tuple[int, int]:
    fn = _function("lion8bit_leaf_tile", [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)])
    groups, cols = ctypes.c_int(), ctypes.c_int()
    if fn(bs, ctypes.byref(groups), ctypes.byref(cols)) != 0:
        raise ValueError(f"the leaf kernel is not built for bs {bs}")
    return groups.value, cols.value


def inverse_permutation(perm: Sequence[int]) -> List[int]:
    """The permutation that undoes ``permute(perm)``."""
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return inv


def lion8bit_update_leaves_reference(
    grads: Sequence[torch.Tensor],
    codes: Sequence[torch.Tensor],
    scales: Sequence[torch.Tensor],
    perms: Sequence[Optional[Sequence[int]]],
    b1: float = 0.9,
    b2: float = 0.99,
    compander: str = "exact",
) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
    """Plain version of ``lion8bit_update_leaves_``: for each leaf, permute
    the torch-layout grad into JAX order, ``lion8bit_update_reference``, and
    the update back through the inverse permutation (contiguous, torch
    layout). Returns ``(updates, new_codes, new_scales)``."""
    updates, new_codes, new_scales = [], [], []
    for g, c, s, perm in zip(grads, codes, scales, perms):
        gj = g.permute(*perm).contiguous() if perm else g
        upd, nc, ns = lion8bit_update_reference(gj, c, s, b1, b2, compander)
        updates.append(upd.permute(*inverse_permutation(perm)).contiguous() if perm else upd)
        new_codes.append(nc)
        new_scales.append(ns)
    return updates, new_codes, new_scales


_DTYPE, _SHAPE, _DEVICE = (operator.attrgetter(name) for name in ("dtype", "shape", "device"))
_LEAVES_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p] + _COMMON_ARGS


def lion8bit_update_leaves_(
    grads: Sequence[torch.Tensor],
    table: LeafTable,
    b1: float = 0.9,
    b2: float = 0.99,
    compander: str = "exact",
) -> List[torch.Tensor]:
    """Update every leaf of ``table``: codes and scales in place; returns the
    update signs in the grads' dtype, in torch layout (views of one buffer),
    in the table's order. ``grads`` are contiguous, in torch layout, of one
    dtype, shaped as the table's leaves, each starting on a 16-byte
    boundary (both paths raise otherwise). CUDA tensors launch
    ``lion_leaves_kernel`` once per ``MAX_LEAVES_PER_LAUNCH`` leaves (counted
    in ``lion8bit_update_leaves_.launches``, by leaves, elements, block size
    and dtype); CPU tensors take ``lion8bit_update_leaves_reference``."""
    fast = fast_compander(compander)
    if len(grads) != table.n_leaves:
        raise ValueError(f"the table has {table.n_leaves} leaves, got {len(grads)} grads")
    # one C-level pass per property: this runs once a step on every leaf
    dtype = grads[0].dtype
    if dtype not in _DTYPE_CODES or set(map(_DTYPE, grads)) != {dtype}:
        raise TypeError(f"grads must share one dtype of {list(_DTYPE_CODES)}")
    if list(map(_SHAPE, grads)) != table.shapes or not all(map(torch.Tensor.is_contiguous, grads)):
        raise ValueError("grads must be contiguous and shaped as the table's leaves (torch layout)")
    # the kernel stages each grad with 16-byte cp.async: a view at another
    # offset (a slice of a flat buffer) breaks its vector loads
    misaligned = [i for i, g in enumerate(grads) if g.data_ptr() % 16]
    if misaligned:
        raise ValueError(f"grads must start on 16-byte boundaries; not so at leaves {misaligned[:8]}")
    if not _on_cuda(table.codes[0], table.bs):
        updates, new_codes, new_scales = lion8bit_update_leaves_reference(
            grads, table.codes, table.scales, table.perms, b1, b2, compander)
        for c, s, nc, ns in zip(table.codes, table.scales, new_codes, new_scales):
            c.copy_(nc)
            s.copy_(ns)
        return updates
    device = table.device
    if set(map(_DEVICE, grads)) != {device}:
        raise ValueError(f"grads must be on the table's device {device}")
    launches = table.launches()
    buffer = torch.empty(table.upd_numel, dtype=dtype, device=device)
    fn = _function("lion8bit_update_leaves", _LEAVES_ARGS)
    coefs = _coefs(b1, b2)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for launch in launches:
            ptrs = array.array("q", map(torch.Tensor.data_ptr, launch.grads(grads)))
            key = (len(launch.leaves), launch.elements, table.bs, dtype)
            with _annotate("lion8bit_update_leaves_", key):
                rc = fn(launch.records.data_ptr(), launch.tile_leaf.data_ptr(), ptrs.buffer_info()[0],
                        len(launch.leaves), launch.n_tiles, buffer.data_ptr(), table.bs, *coefs, int(fast),
                        _DTYPE_CODES[dtype], stream)
            if rc != 0:
                raise RuntimeError(f"lion8bit_update_leaves launch failed: cudaError {rc} ({len(launch.leaves)} leaves)")
            _count(lion8bit_update_leaves_, key)
    return table.views(buffer)


_GRAD_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def launch_work(entry: str, key: Sequence) -> Work:
    """The work of one launch of wrapper ``entry`` at its shape key
    (``_count``'s): ``utils.roofline.lion_bytes`` of its elements and
    blocks; no tensor-core flops."""
    dtype = str(key[-1]).replace("torch.", "")
    if entry == "lion8bit_update_leaves_":  # leaves, elements, bs, dtype
        elements = int(key[1])
        blocks = elements // int(key[2])
    else:  # [leaves or layout,] blocks, bs, dtype
        blocks = int(key[-3])
        elements = blocks * int(key[-2])
    return Work(0.0, 0.0, lion_bytes(elements, blocks, _GRAD_ITEMSIZE[dtype]), dtype)


def _annotate(entry: str, key: Sequence):
    """``annotate_launch`` of one launch of wrapper ``entry``."""
    return annotate_launch(entry, key, lambda: launch_work(entry, key))


def _count(wrapper, shape) -> None:
    """One launch of ``wrapper``: in total and by shape (single leaf: blocks,
    block size, grad dtype; many leaves: leaves, blocks, block size, dtype;
    the leaf table: leaves, elements, block size, dtype; the functional
    entry: layout, blocks, block size, dtype)."""
    wrapper.launches += 1
    key = shape[:-1] + (str(shape[-1]).replace("torch.", ""),)
    wrapper.launches_by_shape[key] = wrapper.launches_by_shape.get(key, 0) + 1


def reset_launch_counts() -> None:
    for wrapper in (lion8bit_update_leaves_, lion8bit_update_, lion8bit_update_multi_, fused_lion8bit_update):
        wrapper.launches = 0
        wrapper.launches_by_shape = {}


reset_launch_counts()
