"""Data parallelism over the mesh's ``data_parallel`` axis: replicated
state, summed grads.

Port of the data-parallel half of
``stable_diffusion_training_tpu/parallel/sharding.py``. In the JAX package
a replicated ``NamedSharding`` makes every device hold the same state by
construction and GSPMD inserts the grads' all-reduce on the data axis; here
both are explicit collectives over the axis's process group:

- ``replicate_``: every rank's tensors become the axis's first rank's
  (broadcast), for the params, EMA, Lion codes and scales and counters
  that ``replicated_tree`` / ``tree_device_put_replicated`` place;
- ``all_reduce_grads_``: the grads summed over the axis, in their own
  dtype, as XLA all-reduces bf16 grads.

Both move flat buckets of up to ``BUCKET_BYTES`` of one dtype, not one
collective per tensor, and every tensor's offset in a bucket is a multiple
of 16 bytes, so the reduced grads, views of the buckets, stay 16-byte
aligned for the fused Lion kernel's ``cp.async`` staging. ``assert_replicated``
checks that the ranks hold the same bytes. The FSDP and tensor-parallel
rules of the JAX module are not ported (ROADMAP Queue 1 item 7); the
config refuses them.
"""

import hashlib
from typing import Dict, Iterable, List, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core.distributed import all_gather_objects
from ..core.mesh import AXIS_DATA

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


@torch.no_grad()
def replicate_(tensors: Iterable[torch.Tensor], mesh, axis: str = AXIS_DATA) -> None:
    """Every rank's ``tensors`` (in the same order and shapes on every rank)
    become, in place, those of rank 0 of ``axis``."""
    tensors = list(tensors)
    if mesh is None or not tensors:
        return
    group = mesh.get_group(axis)
    src = dist.get_global_rank(group, 0)
    leader = dist.get_rank() == src
    for indices, offsets, numel in _buckets(tensors):
        members = [tensors[i] for i in indices]
        flat = torch.empty(numel, dtype=members[0].dtype, device=members[0].device)
        if leader:
            for t, off in zip(members, offsets):
                flat[off : off + t.numel()].copy_(t.reshape(-1))
        dist.broadcast(flat, src=src, group=group)
        if not leader:
            for t, off in zip(members, offsets):
                t.copy_(flat[off : off + t.numel()].view(t.shape))


@torch.no_grad()
def all_reduce_grads_(grads: Dict[str, torch.Tensor], mesh, axis: str = AXIS_DATA) -> Dict[str, torch.Tensor]:
    """Sum ``grads`` over ``axis`` (SUM in each grad's dtype) and put the
    sums in its place: each value becomes a contiguous, 16-byte aligned view
    of a bucket that holds the reduced grads. Each grad's own buffer is let
    go once it is packed. Returns ``grads``."""
    if mesh is None:
        return grads
    group = mesh.get_group(axis)
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
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        for i, off in zip(indices, offsets):
            grads[names[i]] = flat[off : off + shapes[i].numel()].view(shapes[i])
    return grads


def state_digest(tensors: Iterable[torch.Tensor]) -> str:
    """sha256 of the tensors' bytes, in order, with their shapes and
    dtypes."""
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach()
        h.update(f"{tuple(t.shape)}{t.dtype};".encode())
        h.update(t.contiguous().reshape(-1).view(torch.uint8).cpu().numpy().data)
    return h.hexdigest()


def assert_replicated(tensors: Iterable[torch.Tensor], what: str = "state") -> str:
    """Raise unless every rank holds the same bytes in ``tensors`` (by
    ``state_digest``, gathered over the host-side group). Returns the
    digest."""
    digest = state_digest(tensors)
    digests = all_gather_objects(digest)
    if len(set(digests)) != 1:
        raise RuntimeError(f"{what} differs across ranks: digests {digests}")
    return digest
