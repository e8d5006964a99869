"""Data parallelism, FSDP and tensor parallelism over the mesh: replicated
state and summed grads, state sharded over the ``fsdp`` axis, the
attention and CLIP projections split over the ``model_parallel`` axis, or
both of the last two.

Port of ``stable_diffusion_training_tpu/parallel/sharding.py``. In the JAX
package a replicated ``NamedSharding`` makes every device hold the same state by
construction and GSPMD inserts the grads' all-reduce on the data axis; here
both are explicit collectives over the axis's process group:

- ``replicate_``: every rank's tensors become the first rank's
  (broadcast), for the params, EMA, Lion codes and scales and counters
  that ``replicated_tree`` / ``tree_device_put_replicated`` place;
- ``all_reduce_grads_``: the grads summed over the axes, in their own
  dtype, as XLA all-reduces bf16 grads.

Both move flat buckets of up to ``BUCKET_BYTES`` of one dtype, not one
collective per tensor, and every tensor's offset in a bucket is a multiple
of 16 bytes, so the reduced grads, views of the buckets, stay 16-byte
aligned for the fused Lion kernel's ``cp.async`` staging. ``assert_replicated``
checks that the ranks hold the same bytes.

The FSDP half (``params_fsdp_sharding``, ``_lion_fsdp_plan`` and
``train_state_fsdp_sharding`` of the JAX module) is ZeRO-3 through PyTorch's
FSDP2: ``fully_shard_`` shards each UNet down, mid and up block and each
CLIP encoder layer, then the root, on torch axis 0 over the ``fsdp`` axis
(HSDP, replicated over ``data_parallel``, when that axis is larger than 1).
The reduce-scatter sums, as ``all_reduce_grads_`` does, so the step's
``1 / W`` loss scale stays. ``fsdp_plan`` reads back each leaf's rows
(``RowShard``) and applies the momentum co-sharding rule
(``MomentumShard``): the port stores a quantized leaf's Lion momentum in the
reference order of the JAX leaf, and a rank's rows of a Dense or Conv kernel
(JAX's output channels) or of a leaf whose orders agree own whole blocks of
it when every rank's row range is a multiple of the block; the rank then
keeps exactly the reference momentum of its local leaf, which the Lion
kernels take unchanged. A leaf the rule refuses keeps its whole momentum on
every rank. JAX shards the largest divisible dim instead: another
placement of the same numbers. ``gather_rows_many`` rebuilds whole tensors
from their shards (``RowShard.gathers``, ``MomentumShard.gathers``), many to
a collective, for the checkpoint writers.

The TP half (``params_tp_sharding`` and ``train_state_tp_sharding`` of the
JAX module, ``fsdp_rest=False``) splits the leaves that the JAX rule splits,
Megatron-style, with explicit operators instead of GSPMD: ``tp_plan`` names
them by their JAX paths (``models.hf_io.jax_param_paths``): the output
channels (torch axis 0) of ``to_q``, ``to_k``, ``to_v``, ``q_proj``,
``k_proj``, ``v_proj`` and CLIP's ``fc1``, the input channels (torch axis 1)
of ``to_out.0``, ``out_proj`` and ``fc2``, where the axis divides them. The
biases of the column-split layers are split with their outputs (JAX keeps
them replicated: the same numbers, placed otherwise); every other leaf,
the UNet's GEGLU and ``net.2`` included, stays whole on every rank, and so do
the four projections of an attention whose heads the axis does not divide
(JAX splits those and runs the attention unpartitioned). The models own
their split: an attention says whether an axis can split it (``can_split``)
and, once ``tensor_parallel_`` has kept each rank's slices, takes the axis
through its ``split_`` hook, as CLIP's MLP does; this module knows no model
class. In their forwards a column-split layer reads its input through
``tp_copy`` (identity forward, the input grad summed over the axis
backward: one sum for q, k and v of a self-attention, one more for a
cross-attention's context), and ``tp_row_linear`` sums a row-split layer's
partial products (summed forward, identity backward), then adds its bias
once. Each rank runs attention on its own heads. The ranks of the axis
compute the whole leaves' grads each: the train step takes its first
rank's (``replicate_`` over ``model_parallel``), so those replicas stay
bitwise alike whatever the kernels' rounding. The plan (``ShardPlan`` with each split leaf's ``RowShard`` on
its axis) serves the optimizer, the global norm and the checkpoints as
FSDP's does: a Dense kernel split on its input channels holds a contiguous
range of the JAX ``(I, O)`` leaf, so its reference momentum is a flat range
of blocks; one split on its output channels holds whole blocks when every
rank's count is a multiple of the block.

TP with FSDP (``train_state_tp_sharding(fsdp_rest=True)`` of the JAX
module): ``tensor_parallel_`` splits first and keeps each rank's slices,
then ``fully_shard_`` shards every local leaf, slice or whole, on its torch
axis 0 over the fsdp sub-mesh (``mesh[AXIS_FSDP]`` leaves
``model_parallel`` out). ``shard_plan`` composes the two plans: a TP-split
leaf is a ``NestedShard`` (TP's ``RowShard`` of the whole leaf, FSDP2's of
the slice), every other leaf FSDP2's ``RowShard``. Its momentum
(``NestedMomentumShard``) is TP's blocks of the reference momentum, then
FSDP's blocks of those, each level by its own rule: a column-split kernel
keeps a contiguous range of output channels, and a row-split kernel (a
range of the JAX ``(I, O)`` leaf's rows) sharded on its output channels
keeps ``I / T`` runs of ``O / F`` elements, a strided set of block ranges
that is exactly the reference momentum of its local ``(I / T, O / F)``
leaf. That placement, not the refusal (the TP slice's momentum whole on
every fsdp rank, its grad gathered), keeps every split leaf of SD1.5 and
SDXL in the Lion leaf table with no collective; a leaf whose ranges do not
hold whole blocks at either level keeps its whole momentum, as under FSDP.
Whole tensors are gathered in two rounds (``RowGather.then``): the fsdp
rows first, then the TP slices.

Two ranks on one card talk through gloo (NCCL takes one rank a card),
whose CUDA all-gather and reduce-scatter are not usable and whose CUDA
all-reduce and broadcast cross the host: there every collective here, and
FSDP2's, is copies between buffers that the ranks map from each other
through CUDA IPC (``_CardExchange``); so do the TP sums.
"""

import hashlib
import math
import os
import tempfile
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..core.distributed import all_gather_objects
from ..core.mesh import AXIS_DATA, AXIS_FSDP, AXIS_TENSOR, axis_index, axis_size
from ..ops.lion_kernel import leaf_kind
from ..utils.staging import stream_bytes

ROW_AXES = (AXIS_DATA, AXIS_FSDP)  # the axes that split a batch's rows
# the single-tensor all-gather under its current name, and the older one on
# a PyTorch that lacks it
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor

BUCKET_BYTES = 256 << 20
ALIGN_BYTES = 16


def _aligned(numel: int, itemsize: int) -> int:
    step = max(1, ALIGN_BYTES // itemsize)
    return -(-numel // step) * step


def _buckets(tensors: Sequence[torch.Tensor], cap: int = BUCKET_BYTES) -> List[Tuple[List[int], List[int], int]]:
    """Indices of ``tensors`` grouped into buckets of one dtype and device:
    ``(indices, element offsets, elements)`` each, offsets 16-byte aligned,
    at most ``cap`` bytes unless one tensor alone is larger."""
    out = []
    open_ = {}  # (dtype, device) -> [indices, offsets, elements]
    for i, t in enumerate(tensors):
        key = (t.dtype, t.device)
        size = _aligned(t.numel(), t.element_size())
        bucket = open_.get(key)
        if bucket is not None and (bucket[2] + size) * t.element_size() > cap:
            out.append(tuple(open_.pop(key)))
            bucket = None
        if bucket is None:
            bucket = open_[key] = [[], [], 0]
        bucket[0].append(i)
        bucket[1].append(bucket[2])
        bucket[2] += size
    out.extend(tuple(b) for b in open_.values())
    return out


def _groups(mesh, axes: Sequence[str]) -> list:
    """The process groups of ``axes`` that the mesh has with more than one
    rank."""
    return [mesh.get_group(axis) for axis in axes if axis_size(mesh, axis) > 1]


@torch.no_grad()
def replicate_(tensors: Iterable[torch.Tensor], mesh, axes: Sequence[str] = ROW_AXES) -> None:
    """Every rank's ``tensors`` (in the same order and shapes on every rank)
    become, in place, those of the mesh's first rank: broadcast from each
    axis's first rank, one axis after the other."""
    tensors = list(tensors)
    if mesh is None or not tensors:
        return
    for group in _groups(mesh, axes):
        _broadcast_(tensors, group)


def _broadcast_(tensors: List[torch.Tensor], group) -> None:
    src = dist.get_global_rank(group, 0)
    leader = dist.get_rank() == src
    for indices, offsets, numel in _buckets(tensors):
        members = [tensors[i] for i in indices]
        flat = torch.empty(numel, dtype=members[0].dtype, device=members[0].device)
        if leader:
            for t, off in zip(members, offsets):
                flat[off : off + t.numel()].copy_(t.reshape(-1))
        if _shares_card(group, flat.device):
            _CardExchange.of(group, flat.device).broadcast(flat, 0)
        else:
            dist.broadcast(flat, src=src, group=group)
        if not leader:
            for t, off in zip(members, offsets):
                t.copy_(flat[off : off + t.numel()].view(t.shape))


@torch.no_grad()
def all_reduce_grads_(grads: Dict[str, torch.Tensor], mesh, axes: Sequence[str] = ROW_AXES) -> Dict[str, torch.Tensor]:
    """Sum ``grads`` over ``axes`` (SUM in each grad's dtype; the ranks of
    a replicated ``fsdp`` axis are data parallel too) and put the sums in
    its place: each value becomes a contiguous, 16-byte aligned view of a
    bucket that holds the reduced grads. Each grad's own buffer is let go
    once it is packed. Returns ``grads``."""
    groups = [] if mesh is None else _groups(mesh, axes)
    if not groups:
        return grads
    names = list(grads)
    shapes = [grads[n].shape for n in names]
    buckets = _buckets([grads[n] for n in names])
    for indices, offsets, numel in buckets:
        first = grads[names[indices[0]]]
        flat = torch.empty(numel, dtype=first.dtype, device=first.device)
        del first
        for i, off in zip(indices, offsets):
            g = grads[names[i]]
            flat[off : off + g.numel()].copy_(g.reshape(-1))
            grads[names[i]] = None
        for group in groups:
            _sum_(flat, group)
        for i, off in zip(indices, offsets):
            grads[names[i]] = flat[off : off + shapes[i].numel()].view(shapes[i])
    return grads


def state_digest(tensors: Iterable[torch.Tensor]) -> str:
    """sha256 of the tensors' shapes and dtypes, in order, then of their
    bytes, in order (``stream_bytes``)."""
    tensors = list(tensors)
    h = hashlib.sha256()
    for t in tensors:
        h.update(f"{tuple(t.shape)}{t.dtype};".encode())
    stream_bytes(tensors, h.update)
    return h.hexdigest()


def assert_replicated(tensors: Iterable[torch.Tensor], what: str = "state", mesh=None, axis: Optional[str] = None) -> str:
    """Raise unless every rank holds the same bytes in ``tensors`` (by
    ``state_digest``, gathered over the host-side group); with ``mesh`` and
    ``axis``, every rank of each of that axis's groups (the ranks that share
    their place on the other axes). Returns the digest."""
    digest = state_digest(tensors)
    place = () if axis is None else tuple(
        axis_index(mesh, name) for name in mesh.mesh_dim_names if name != axis
    )
    groups: Dict[tuple, List[str]] = {}
    for other, d in all_gather_objects((place, digest)):
        groups.setdefault(tuple(other), []).append(d)
    if any(len(set(ds)) != 1 for ds in groups.values()):
        raise RuntimeError(f"{what} differs across ranks: digests {groups}")
    return digest


def all_reduce_(tensor: torch.Tensor, mesh, axes: Sequence[str] = ROW_AXES) -> torch.Tensor:
    """``tensor`` summed in place over ``axes`` (nothing without a mesh)."""
    for group in [] if mesh is None else _groups(mesh, axes):
        _sum_(tensor, group)
    return tensor


def _sum_(tensor: torch.Tensor, group) -> None:
    """All-reduce (SUM) of a contiguous tensor over ``group``: through
    ``_CardExchange`` on gloo ranks of a card."""
    if _shares_card(group, tensor.device):
        _CardExchange.of(group, tensor.device).all_reduce(tensor)
    else:
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)


# --- FSDP: state sharded on torch axis 0 over the fsdp axis --------------------


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a ``DTensor`` (a view of its storage, no
    autograd history), else ``t`` itself."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        with torch.no_grad():
            return t.to_local()
    return t


def _shares_card(group, device: torch.device) -> bool:
    """Whether a collective of ``group`` on ``device`` goes through
    ``_CardExchange``: gloo ranks on a card (NCCL takes one rank a card;
    gloo's CUDA all-gather and reduce-scatter are not usable, and its CUDA
    all-reduce and broadcast cross the host)."""
    return device.type == "cuda" and dist.get_backend(group) == "gloo"


_EXCHANGES: Dict[tuple, "_CardExchange"] = {}  # by (group ranks, device)


class _CardExchange:
    """One buffer per rank of a gloo group whose ranks share a card, each
    rank mapping every other rank's (CUDA IPC; a shared file mapping for CPU
    tensors). A collective is device copies between two barriers: each rank
    writes its bytes into its own buffer, then reads what it needs from
    every buffer, and no rank writes again before every rank has read."""

    def __init__(self, group, device: torch.device):
        self.group, self.device = group, device
        self.world, self.rank = dist.get_world_size(group), dist.get_rank(group)
        self.buffers: List[torch.Tensor] = []  # by group rank; this rank's own at self.rank
        self.nbytes = 0
        self._earlier: List[List[torch.Tensor]] = []  # kept alive: the other ranks may map them
        card = str(torch.cuda.get_device_properties(device).uuid) if device.type == "cuda" else "cpu"
        cards = [None] * self.world
        dist.all_gather_object(cards, card, group=group)
        if len(set(cards)) != 1:
            raise RuntimeError(f"gloo ranks on different cards ({cards}): use NCCL between cards")

    @classmethod
    def of(cls, group, device: torch.device) -> "_CardExchange":
        key = tuple(dist.get_process_group_ranks(group)), str(device)
        if key not in _EXCHANGES:
            _EXCHANGES[key] = cls(group, device)
        return _EXCHANGES[key]

    def _ensure(self, nbytes: int) -> None:
        """Buffers of at least ``nbytes`` (every rank asks for the same)."""
        if nbytes <= self.nbytes:
            return
        nbytes = max(nbytes, 2 * self.nbytes)
        handles = [None] * self.world
        if self.device.type == "cuda":
            from torch.multiprocessing.reductions import reduce_tensor

            own = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
            dist.all_gather_object(handles, reduce_tensor(own), group=self.group)
            peers = [own if r == self.rank else fn(*args) for r, (fn, args) in enumerate(handles)]
        else:  # a file each rank maps shared, unlinked once every rank has
            fd, path = tempfile.mkstemp(prefix="card_exchange_")
            os.close(fd)
            os.truncate(path, nbytes)
            own = torch.from_file(path, shared=True, size=nbytes, dtype=torch.uint8)
            dist.all_gather_object(handles, path, group=self.group)
            peers = [own if r == self.rank else torch.from_file(p, shared=True, size=nbytes, dtype=torch.uint8)
                     for r, p in enumerate(handles)]
            dist.barrier(group=self.group)
            os.unlink(path)
        self._earlier.append(self.buffers)
        self.buffers, self.nbytes = peers, nbytes

    def _fence(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dist.barrier(group=self.group)

    def _publish(self, t: torch.Tensor) -> int:
        nbytes = t.numel() * t.element_size()
        self._ensure(nbytes)
        self.buffers[self.rank][:nbytes].copy_(t.detach().contiguous().reshape(-1).view(torch.uint8))
        self._fence()
        return nbytes

    def all_gather(self, out: torch.Tensor, local: torch.Tensor) -> None:
        """``out`` (contiguous, ``world`` times ``local``'s bytes) becomes
        every rank's ``local`` in rank order."""
        nbytes = self._publish(local)
        flat = out.view(-1).view(torch.uint8)
        for r, buf in enumerate(self.buffers):
            flat[r * nbytes : (r + 1) * nbytes].copy_(buf[:nbytes])
        self._fence()

    def all_reduce(self, t: torch.Tensor) -> None:
        """``t`` (contiguous) becomes the sum of every rank's, added in rank
        order in its dtype."""
        nbytes = self._publish(t)
        parts = [buf[:nbytes].view(t.dtype) for buf in self.buffers]
        total = parts[0].clone()
        for part in parts[1:]:
            total.add_(part)
        t.view(-1).copy_(total)
        self._fence()

    def broadcast(self, t: torch.Tensor, src: int) -> None:
        """``t`` (contiguous) becomes group rank ``src``'s."""
        nbytes = self._publish(t)
        if self.rank != src:
            t.view(-1).view(torch.uint8).copy_(self.buffers[src][:nbytes])
        self._fence()

    def reduce_scatter(self, out: torch.Tensor, full: torch.Tensor) -> None:
        """``out`` becomes this rank's slice of the sum of every rank's
        ``full``, added in rank order in ``full``'s dtype."""
        nbytes = self._publish(full)
        n = out.numel()
        parts = [buf[:nbytes].view(full.dtype)[self.rank * n : (self.rank + 1) * n] for buf in self.buffers]
        total = parts[0].clone()
        for part in parts[1:]:
            total.add_(part)
        out.copy_(total.view(out.shape))
        self._fence()


class _CardAllGather:
    """FSDP2's all-gather through the ranks' ``_CardExchange`` (its
    ``AllGather`` protocol)."""

    def allocate(self, size, *, dtype, device):
        return torch.empty(*size, dtype=dtype, device=device)

    def __call__(self, output_tensor, input_tensor, group, async_op=False):
        _CardExchange.of(group, input_tensor.device).all_gather(output_tensor, input_tensor)
        return None


class _CardReduceScatter:
    """FSDP2's reduce-scatter through the ranks' ``_CardExchange`` (its
    ``ReduceScatter`` protocol; ``op`` is SUM, ``fully_shard_``)."""

    def allocate(self, size, *, dtype, device):
        return torch.empty(*size, dtype=dtype, device=device)

    def __call__(self, output_tensor, input_tensor, group, op, async_op=False):
        _CardExchange.of(group, input_tensor.device).reduce_scatter(output_tensor, input_tensor)
        return None


def fsdp_units(module: nn.Module) -> List[nn.Module]:
    """The modules that ``fully_shard_`` shards one by one before the root:
    a UNet's down, mid and up blocks, a CLIP tower's encoder layers."""
    if hasattr(module, "down_blocks"):
        return [*module.down_blocks, module.mid_block, *module.up_blocks]
    return list(module.text_model.encoder.layers)


def fsdp_mesh(mesh):
    """The mesh FSDP2 shards over: the ``fsdp`` axis, or ``(data_parallel,
    fsdp)`` (HSDP: replicated over the data axis) when the data axis has more
    than one rank."""
    if axis_size(mesh, AXIS_DATA) > 1:
        return mesh[(AXIS_DATA, AXIS_FSDP)]
    return mesh[AXIS_FSDP]


def fully_shard_(module: nn.Module, mesh) -> nn.Module:
    """Shard ``module`` with FSDP2 over the mesh's ``fsdp`` axis: each of
    ``fsdp_units`` its own unit (all-gathered before its forward, freed after
    it, gathered again for its backward), the rest with the root. The grads'
    reduce-scatter sums (``set_gradient_divide_factor(1)`` with SUM comms);
    on gloo ranks of a card both go through ``_CardExchange``."""
    from torch.distributed.fsdp import fully_shard

    sub = fsdp_mesh(mesh)
    units = fsdp_units(module)
    for unit in units:
        fully_shard(unit, mesh=sub)
    fully_shard(module, mesh=sub)
    device = next(module.parameters()).device
    for m in (*units, module):
        m.set_gradient_divide_factor(1.0)
        m.set_force_sum_reduction_for_comms(True)
        if _shares_card(sub.get_group(sub.ndim - 1), device):
            m.set_custom_all_gather(_CardAllGather())
            m.set_custom_reduce_scatter(_CardReduceScatter())
    return module


@dataclass(frozen=True)
class RowGather:
    """One tensor to rebuild whole from the axis-0 rows that the ranks of
    ``group`` hold (``counts[i]`` rows on rank ``i``, this rank's ``local``),
    and ``post``, applied to the whole tensor (a transpose back to the
    reference order), if any. ``then``: a second level (a leaf split over
    two axes), the ``RowGather`` whose local part is the tensor this one
    rebuilds."""

    local: torch.Tensor
    counts: Tuple[int, ...]
    group: Any
    post: Optional[Any] = None
    then: Optional[Callable[[torch.Tensor], "RowGather"]] = None


@torch.no_grad()
def gather_rows_many(gathers: Sequence[RowGather], host: bool = False, keep: bool = True) -> List[Optional[torch.Tensor]]:
    """Each of ``gathers`` whole, in order (a collective: every rank of
    their groups calls it with the same list). The tensors of one group go
    in one all-gather per ``BUCKET_BYTES``, each rank's rows padded to the
    largest count, through ``_CardExchange`` on gloo ranks of a card. The
    results are in host memory with ``host``, else on the local tensors'
    device; a rank with ``keep`` False takes part and gets Nones. The
    gathers with a ``then`` take two rounds: every rank keeps the first
    round's tensors on the device, the local parts of the second's."""
    out: List[Optional[torch.Tensor]] = [None] * len(gathers)
    direct = [i for i, g in enumerate(gathers) if g.then is None]
    staged = [i for i, g in enumerate(gathers) if g.then is not None]
    for i, full in zip(direct, _gather_round([gathers[i] for i in direct], host, keep)):
        out[i] = full
    if staged:
        firsts = _gather_round([gathers[i] for i in staged], False, True)
        seconds = gather_rows_many([gathers[i].then(f) for i, f in zip(staged, firsts)], host, keep)
        for i, full in zip(staged, seconds):
            out[i] = full
    return out


def _gather_round(gathers: Sequence[RowGather], host: bool, keep: bool) -> List[Optional[torch.Tensor]]:
    """One level of ``gather_rows_many``: each of ``gathers`` whole from
    its group's rows."""
    out: List[Optional[torch.Tensor]] = [None] * len(gathers)
    by_group: Dict[int, List[int]] = {}
    for i, g in enumerate(gathers):
        by_group.setdefault(id(g.group), []).append(i)
    for members in by_group.values():
        bucket, nbytes = [], 0
        for i in members:
            size = _slot_bytes(gathers[i])
            if bucket and nbytes + size > BUCKET_BYTES:
                _gather_bucket(gathers, bucket, out, host, keep)
                bucket, nbytes = [], 0
            bucket.append(i)
            nbytes += size
        if bucket:
            _gather_bucket(gathers, bucket, out, host, keep)
    return out


def _row_bytes(t: torch.Tensor) -> int:
    return t.element_size() * math.prod(t.shape[1:])


def _slot_bytes(g: RowGather) -> int:
    return -(-max(g.counts) * _row_bytes(g.local) // ALIGN_BYTES) * ALIGN_BYTES


def _gather_bucket(gathers, bucket, out, host, keep) -> None:
    first = gathers[bucket[0]]
    group, device = first.group, first.local.device
    offsets, total = [], 0
    for i in bucket:
        offsets.append(total)
        total += _slot_bytes(gathers[i])
    flat = torch.zeros(total, dtype=torch.uint8, device=device)
    for i, off in zip(bucket, offsets):
        local = gathers[i].local.detach().contiguous().reshape(-1).view(torch.uint8)
        flat[off : off + local.numel()].copy_(local)
    world = len(first.counts)
    whole = torch.empty(world * total, dtype=torch.uint8, device=device)
    if _shares_card(group, device):
        _CardExchange.of(group, device).all_gather(whole, flat)
    else:
        _ALL_GATHER(whole, flat, group=group)
    if not keep:
        return
    for i, off in zip(bucket, offsets):
        g, row = gathers[i], _row_bytes(gathers[i].local)
        parts = [whole[r * total + off : r * total + off + n * row] for r, n in enumerate(g.counts)]
        # rebuilt (and transposed back) where the bucket lies; only the
        # finished tensor crosses to the host
        full = torch.cat(parts).view(g.local.dtype).view((sum(g.counts),) + tuple(g.local.shape[1:]))
        if g.post is not None:
            full = g.post(full)
        out[i] = full.contiguous().cpu() if host else full


@dataclass(frozen=True)
class RowShard:
    """One leaf split over an axis's ranks on torch axis ``dim``: the whole
    leaf's ``shape``, the ``bounds`` of each rank's range of that axis
    (rank ``i`` holds ``bounds[i]:bounds[i + 1]``, possibly none), this
    rank's ``index`` on the mesh axis and its ``group``. FSDP2 splits axis 0
    as ``torch.chunk`` does; TP splits axis 0 (a column-split layer) or 1 (a
    row-split one) evenly."""

    shape: torch.Size
    bounds: Tuple[int, ...]
    index: int
    group: Any
    dim: int = 0

    @property
    def groups(self) -> tuple:
        """The groups whose ranks hold disjoint parts of the leaf."""
        return (self.group,)

    @property
    def start(self) -> int:
        return self.bounds[self.index]

    @property
    def stop(self) -> int:
        return self.bounds[self.index + 1]

    @property
    def counts(self) -> List[int]:
        return [b - a for a, b in zip(self.bounds, self.bounds[1:])]

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's range of the whole tensor (a view)."""
        return full.narrow(self.dim, self.start, self.stop - self.start)

    def gather(self, local: torch.Tensor, host: bool = False) -> torch.Tensor:
        """The whole tensor from every rank's range (a collective)."""
        return gather_rows_many(self.gathers(local), host)[0]

    def gathers(self, local: torch.Tensor) -> List[RowGather]:
        """The whole tensor as a ``RowGather``, for ``gather_rows_many``: a
        split on axis 1 gathered as the rows of the transpose."""
        if self.dim == 0:
            return [RowGather(local, tuple(self.counts), self.group)]
        return [RowGather(local.detach().transpose(0, self.dim).contiguous(), tuple(self.counts), self.group,
                          _transposer(self.dim))]


def _transposer(dim: int):
    return lambda full: full.transpose(0, dim).contiguous()


@dataclass(frozen=True)
class NestedShard:
    """A leaf split over two axes: ``outer`` splits the whole leaf (TP's
    ``RowShard``, on torch axis 0 or 1), ``inner`` the outer slice (FSDP2's,
    on its axis 0). The rank holds ``inner.take(outer.take(whole))``; the
    whole leaf is rebuilt in two rounds, the fsdp rows first, then the TP
    slices. Answers as a ``RowShard`` does."""

    outer: RowShard
    inner: RowShard

    @property
    def shape(self) -> torch.Size:
        return self.outer.shape

    @property
    def groups(self) -> tuple:
        return self.inner.groups + self.outer.groups

    def take(self, full: torch.Tensor) -> torch.Tensor:
        return self.inner.take(self.outer.take(full))

    def gathers(self, local: torch.Tensor) -> List[RowGather]:
        return [replace(g, then=lambda t: self.outer.gathers(t)[0]) for g in self.inner.gathers(local)]

    def gather(self, local: torch.Tensor, host: bool = False) -> torch.Tensor:
        return gather_rows_many(self.gathers(local), host)[0]


@dataclass(frozen=True)
class MomentumShard:
    """The co-sharding rule's answer for one quantized leaf: this rank's
    blocks of the whole leaf's reference-order codes ``(n_blocks, bs)`` and
    scales ``(n_blocks,)``. ``transposed``: a Dense or Conv kernel split on
    its output channels, whose JAX block is ``bs`` output channels (torch
    rows) at one of the ``columns`` torch columns, so the whole codes are
    ``(columns, rows / bs, bs)`` and the rank's are ``[:, start / bs : stop
    / bs]``; otherwise the rank's blocks are a flat range, ``columns``
    elements of the reference order for each index of its range: the rows
    of a leaf whose orders agree, or the input channels of a Dense kernel
    split on torch axis 1 (the rows of the JAX ``(I, O)`` leaf,
    ``columns`` = O)."""

    rows: RowShard
    transposed: bool
    columns: int
    bs: int

    def _block_counts(self) -> List[int]:
        per_row = 1 if self.transposed else self.columns
        return [n * per_row // self.bs for n in self.rows.counts]

    def take(self, codes: torch.Tensor, scales: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """This rank's codes and scales of the whole leaf's."""
        lo, hi = (b * (1 if self.transposed else self.columns) // self.bs for b in (self.rows.start, self.rows.stop))
        if not self.transposed:
            return codes[lo:hi], scales[lo:hi]
        groups = self.rows.shape[0] // self.bs
        return (codes.view(self.columns, groups, self.bs)[:, lo:hi].reshape(-1, self.bs),
                scales.view(self.columns, groups)[:, lo:hi].reshape(-1))

    def gathers(self, codes: torch.Tensor, scales: torch.Tensor) -> List[RowGather]:
        """The whole leaf's codes and scales from every rank's, as two
        ``RowGather``s: the blocks of a transposed leaf gathered as rows of
        ``(rows / bs, columns, ...)`` and put back in reference order."""
        return [self.part_gather(codes), self.part_gather(scales)]

    def part_gather(self, t: torch.Tensor) -> RowGather:
        """The ``RowGather`` of this rank's codes ``(n, bs)`` or scales
        ``(n,)``."""
        counts, group = tuple(self._block_counts()), self.rows.group
        if not self.transposed:
            return RowGather(t, counts, group)
        tail = tuple(t.shape[1:])  # (bs,) for the codes, () for the scales
        blocks = t.view(self.columns, -1, *tail).transpose(0, 1).contiguous()
        return RowGather(blocks, counts, group, lambda full: full.transpose(0, 1).reshape(-1, *tail))

    def gather(self, codes: torch.Tensor, scales: torch.Tensor, host: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """The whole leaf's codes and scales from every rank's (a
        collective)."""
        full_codes, full_scales = gather_rows_many(self.gathers(codes, scales), host)
        return full_codes, full_scales


@dataclass(frozen=True)
class NestedMomentumShard:
    """The momentum of a ``NestedShard`` leaf: ``outer``'s blocks of the
    whole leaf's reference-order codes (TP's ``MomentumShard``), then
    ``inner``'s of those (FSDP2's, over the outer slice as its leaf). For a
    row-split kernel (a range of the JAX ``(I, O)`` leaf's rows) sharded on
    its output channels that is a strided set of block ranges: ``I / T``
    runs of ``O / F`` elements, each of whole blocks."""

    outer: MomentumShard
    inner: MomentumShard

    def take(self, codes: torch.Tensor, scales: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.inner.take(*self.outer.take(codes, scales))

    def gathers(self, codes: torch.Tensor, scales: torch.Tensor) -> List[RowGather]:
        return [replace(g, then=self.outer.part_gather) for g in self.inner.gathers(codes, scales)]

    def gather(self, codes: torch.Tensor, scales: torch.Tensor, host: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        full_codes, full_scales = gather_rows_many(self.gathers(codes, scales), host)
        return full_codes, full_scales


class ShardPlan:
    """One sharded model's split leaves: ``rows`` (``{name: RowShard}``;
    under FSDP every leaf, under TP the split ones; with both, each TP-split
    leaf a ``NestedShard``), the torch-to-JAX permutation of each leaf
    (``perms``), for the momentum rule, and ``fsdp``: whether FSDP2 holds
    the leaves (its parameters are DTensors) or ``tensor_parallel_`` alone
    does (plain parameters, the split leaves' slices and the rest whole)."""

    def __init__(self, rows: Dict[str, Any], perms: Dict[str, Optional[Sequence[int]]], fsdp: bool = False):
        self.rows = rows
        self.perms = perms
        self.fsdp = fsdp

    @property
    def tp_names(self) -> set:
        """The leaves split over the ``model_parallel`` axis: each of its
        ranks holds its own slice, where the other leaves are alike on
        them."""
        return {n for n, r in self.rows.items() if isinstance(r, NestedShard) or not self.fsdp}

    def momentum(self, name: str, bs: int):
        """The co-sharding rule: the leaf's momentum is split as the leaf
        when it is a transposed leaf (Dense or Conv kernel) or one whose
        orders agree, no rank is empty, and every rank's range holds whole
        blocks; None keeps the whole momentum on every rank. A
        ``NestedShard`` leaf's is split when the rule takes both levels (a
        ``NestedMomentumShard``), else kept whole."""
        rows = self.rows[name]
        if isinstance(rows, NestedShard):
            outer, inner = (self._momentum(r, name, bs) for r in (rows.outer, rows.inner))
            return None if outer is None or inner is None else NestedMomentumShard(outer, inner)
        return self._momentum(rows, name, bs)

    def _momentum(self, rows: RowShard, name: str, bs: int) -> Optional[MomentumShard]:
        kind = leaf_kind(rows.shape, self.perms.get(name), bs)
        if kind is None or 0 in rows.counts:
            return None
        if rows.dim == 0:
            columns = rows.shape.numel() // rows.shape[0]
            transposed = kind == 0
        elif kind == 0 and len(rows.shape) == 2:  # a Dense kernel's input channels
            columns, transposed = rows.shape[0], False
        else:
            return None
        per_index = 1 if transposed else columns
        if any(b * per_index % bs for b in rows.bounds):
            return None
        return MomentumShard(rows, transposed, columns, bs)

    def take(self, name: str, full: torch.Tensor) -> torch.Tensor:
        return self.rows[name].take(full)


def fsdp_plan(module: nn.Module) -> Optional[ShardPlan]:
    """The ``ShardPlan`` of a module that ``fully_shard_`` sharded (None for
    one that holds whole tensors)."""
    from torch.distributed.tensor import DTensor

    from ..models.hf_io import jax_param_paths

    rows = {}
    for name, p in module.named_parameters():
        if not isinstance(p, DTensor):
            continue
        dim = next(i for i, pl in enumerate(p.placements) if pl.is_shard())
        mesh, n = p.device_mesh, p.shape[0]
        chunk = -(-n // mesh.size(dim))
        rows[name] = RowShard(
            p.shape, tuple(min(i * chunk, n) for i in range(mesh.size(dim) + 1)),
            mesh.get_local_rank(dim), mesh.get_group(dim),
        )
    if not rows:
        return None
    return ShardPlan(rows, {name: perm for name, (_, perm) in jax_param_paths(module).items()}, fsdp=True)


# --- tensor parallelism: Megatron's column and row splits over model_parallel --

# the JAX rule's parents of the split kernels (JAX parallel/sharding.py
# _TP_COLUMN, _TP_ROW); its _TP_GEGLU ("net_0") matches no kernel's parent
TP_COLUMN = ("to_q", "to_k", "to_v", "q_proj", "k_proj", "v_proj", "mlp_fc1")
TP_ROW = ("to_out", "out_proj", "mlp_fc2")
TP_PLAN_ATTR = "tensor_parallel_plan"  # where tensor_parallel_ keeps a module's plan

# the TP sums issued, by direction: the row-split layers' forward sums and
# the column-split layers' input-grad sums
TP_ALL_REDUCES = {"forward": 0, "backward": 0}


@dataclass(frozen=True)
class TpAxis:
    """The ``model_parallel`` axis a split module sums over: its process
    group and its size."""

    group: Any
    size: int


def _tp_all_reduce(t: torch.Tensor, axis: TpAxis, direction: str) -> torch.Tensor:
    """A new tensor holding ``t`` summed over the axis (``_sum_``: through
    ``_CardExchange`` on gloo ranks of a card), counted in
    ``TP_ALL_REDUCES``."""
    out = t.detach().clone(memory_format=torch.contiguous_format)
    _sum_(out, axis.group)
    TP_ALL_REDUCES[direction] += 1
    return out


class _CopyToTp(torch.autograd.Function):
    """Identity forward; the input's grad summed over the axis backward
    (the input of column-split layers)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _tp_all_reduce(grad, ctx.axis, "backward"), None


class _SumOverTp(torch.autograd.Function):
    """Summed over the axis forward; identity backward (the partial
    products of a row-split layer)."""

    @staticmethod
    def forward(ctx, x, axis):
        return _tp_all_reduce(x, axis, "forward")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def tp_copy(x: torch.Tensor, axis: TpAxis) -> torch.Tensor:
    """``x`` as the input of column-split layers: every layer that reads
    the returned tensor adds its grad to one sum over the axis."""
    return _CopyToTp.apply(x, axis)


def tp_row_linear(x: torch.Tensor, linear: nn.Linear, axis: TpAxis) -> torch.Tensor:
    """A row-split ``linear`` on this rank's input channels ``x``: the
    partial products summed over the axis, then the bias added once."""
    out = _SumOverTp.apply(torch.nn.functional.linear(x, linear.weight), axis)
    return out if linear.bias is None else out + linear.bias


def _qualified(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def tp_plan(module: nn.Module, mesh) -> Optional[ShardPlan]:
    """The JAX ``params_tp_sharding`` rule over ``module``'s whole leaves,
    by their JAX paths, as a ``ShardPlan`` of the split leaves: a kernel
    whose parent is in ``TP_COLUMN`` split on torch axis 0 (JAX axis 1),
    one in ``TP_ROW`` on torch axis 1 (JAX axis 0), each where the axis
    divides it, and a column-split kernel's bias with it; the projections of
    an attention that cannot run on a share of its heads (its
    ``can_split(n)`` is false: the axis does not divide them) stay whole.
    None without a ``model_parallel`` axis above 1."""
    n = axis_size(mesh, AXIS_TENSOR)
    if n <= 1:
        return None
    from ..models.hf_io import jax_param_paths

    whole = set()  # the params of the attentions kept whole
    for prefix, m in module.named_modules():
        if hasattr(m, "can_split") and not m.can_split(n):
            whole.update(_qualified(prefix, name) for name, _ in m.named_parameters())
    paths = jax_param_paths(module)
    group, index = mesh.get_group(AXIS_TENSOR), axis_index(mesh, AXIS_TENSOR)
    rows = {}
    for name, p in module.named_parameters():
        path, _ = paths[name]
        parent = path[-2] if len(path) >= 2 else ""
        if name in whole or not (p.dim() == 2 and path[-1] == "kernel" or path[-1] == "bias"):
            continue
        if parent in TP_COLUMN:
            dim = 0
        elif parent in TP_ROW and path[-1] == "kernel":
            dim = 1
        else:
            continue
        if p.shape[dim] % n:
            continue
        step = p.shape[dim] // n
        rows[name] = RowShard(p.shape, tuple(i * step for i in range(n + 1)), index, group, dim)
    return ShardPlan(rows, {name: perm for name, (_, perm) in paths.items()}) if rows else None


@torch.no_grad()
def tensor_parallel_(module: nn.Module, mesh) -> Optional[ShardPlan]:
    """Split ``module`` over the mesh's ``model_parallel`` axis as
    ``tp_plan`` says: each split leaf becomes a parameter holding this
    rank's slice, and each submodule with a ``split_`` hook (the UNet's and
    CLIP's attentions, CLIP's MLP) whose own leaves were split is told the
    axis (a ``TpAxis``), on which it runs its share of the heads or of the
    hidden channels. Keeps the plan on the module (``shard_plan``) and
    returns it; None (and nothing changed) when there is nothing to split."""
    plan = tp_plan(module, mesh)
    if plan is None:
        return None
    for name, shard in plan.rows.items():
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        old = getattr(owner, leaf)
        local = shard.take(old.detach()).clone(memory_format=torch.contiguous_format)
        setattr(owner, leaf, nn.Parameter(local, requires_grad=old.requires_grad))
        if leaf == "weight" and isinstance(owner, nn.Linear):
            owner.out_features, owner.in_features = local.shape
    axis = TpAxis(mesh.get_group(AXIS_TENSOR), axis_size(mesh, AXIS_TENSOR))
    for prefix, m in module.named_modules():
        if hasattr(m, "split_") and any(_qualified(prefix, n) in plan.rows for n, _ in m.named_parameters()):
            m.split_(axis)
    setattr(module, TP_PLAN_ATTR, plan)
    return plan


def shard_plan(module: nn.Module) -> Optional[ShardPlan]:
    """The plan of a module's split leaves: FSDP2's (``fsdp_plan``), the one
    ``tensor_parallel_`` kept, both composed when FSDP2 sharded a split
    module (each TP-split leaf a ``NestedShard``), else None (whole
    tensors). Its ``fsdp`` says whether FSDP2 holds the leaves."""
    fsdp, tp = fsdp_plan(module), getattr(module, TP_PLAN_ATTR, None)
    if fsdp is None or tp is None:
        return fsdp or tp
    rows = {n: NestedShard(tp.rows[n], r) if n in tp.rows else r for n, r in fsdp.rows.items()}
    return ShardPlan(rows, fsdp.perms, fsdp=True)
