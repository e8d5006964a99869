"""Process-group start-up and per-process batch handling.

Port of ``stable_diffusion_training_tpu/core/distributed.py``. Where the JAX
package starts its runtime with ``jax.distributed.initialize`` and builds
global arrays from each host's shard, the port runs one process per card
(``torchrun --nproc_per_node=N``) and joins them in a ``torch.distributed``
process group: NCCL between cards, gloo on the CPU. Torch has no global
array, so each rank keeps its own rows of every batch on its own device
(``put_local_batch``), the batch split over the mesh's data x fsdp ranks
(``batch_shard``; the JAX package shards it on ``data_parallel`` and
replicates it over ``fsdp``); the collectives the JAX package leaves to
GSPMD are spelled out in ``parallel/sharding.py``.

Small host-side agreements (``agree_min``, ``barrier``, the replication
check's digests) go over a gloo group, so that they never wait on the card's
stream: the default group when it is gloo, else one made beside it by
``initialize_distributed``.
"""

import datetime
import os
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

_CONTROL = {"group": None}  # the gloo group beside an NCCL default group


def initialize_distributed(
    backend: Optional[str] = None,
    *,
    device=None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    local_rank: Optional[int] = None,
    init_method: Optional[str] = None,
    timeout: datetime.timedelta = datetime.timedelta(minutes=30),
):
    """Join this process to the training job's process group and return the
    default group; None for a single process.

    The arguments default to torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``; ``MASTER_ADDR`` and ``MASTER_PORT`` through
    ``init_method="env://"``). With no ``WORLD_SIZE`` there, or an explicit
    ``world_size=1``, this is a no-op, as the JAX function is for one
    process; under torchrun a world of one still forms a group. A group
    that is already initialised is returned as it is. The rank's device is
    ``device`` or ``cuda:<LOCAL_RANK>``, set as the current device before
    the group forms; there is no CPU fallback: a rank without a card raises,
    and so does a ``LOCAL_RANK`` past the card count. The backend is NCCL
    on a card and gloo on the CPU."""
    if dist.is_initialized():
        _ensure_control_group()
        return dist.group.WORLD
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    elif world_size == 1 or world_size is None:
        return None
    rank = int(os.environ["RANK"]) if rank is None else rank
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dev = rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init_method or "env://",
        rank=rank,
        world_size=world_size,
        timeout=timeout,
    )
    _ensure_control_group()
    return dist.group.WORLD


def _ensure_control_group() -> None:
    """A gloo group over every rank for host-side agreements, made once
    (collectively) when the default group is not gloo."""
    if dist.get_backend() != "gloo" and _CONTROL["group"] is None:
        _CONTROL["group"] = dist.new_group(backend="gloo")


def _control_group():
    if dist.get_backend() == "gloo":
        return None  # the default group
    if _CONTROL["group"] is None:
        raise RuntimeError("initialize_distributed() has not run in this process")
    return _CONTROL["group"]


def rank_device(device=None, local_rank: Optional[int] = None) -> torch.device:
    """This rank's device: ``device`` when given, else ``cuda:<local_rank>``
    (``local_process_index()`` by default) in a process group, else
    ``cuda``. Raises when CUDA is asked for and absent, and when the local
    rank has no card of its own."""
    if device is not None or not dist.is_initialized() and local_rank is None:
        return resolve_device(device)
    resolve_device("cuda")  # no card: raises
    local_rank = local_process_index() if local_rank is None else local_rank
    if local_rank >= torch.cuda.device_count():
        raise RuntimeError(
            f"LOCAL_RANK={local_rank} but this host has {torch.cuda.device_count()} CUDA device(s): "
            "one process per card"
        )
    return torch.device("cuda", local_rank)


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_process_index() -> int:
    """This process's rank among the processes of its host: torchrun's
    ``LOCAL_RANK``, else the rank (one host)."""
    return int(os.environ.get("LOCAL_RANK", process_index()))


def agree_min(value: int) -> int:
    """The least of every rank's ``value`` (the value itself for one
    process), over the host-side group: no wait on the card."""
    if not dist.is_initialized():
        return value
    t = torch.tensor([value], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=_control_group())
    return int(t.item())


def barrier() -> None:
    """Every rank waits for the others here (nothing for one process)."""
    if dist.is_initialized():
        dist.barrier(group=_control_group())


def run_on(selected: bool, fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)`` on the ranks where ``selected`` is true (rank
    0 for the files a run writes once, a host's first rank for its shared
    ramdisk) while the others wait; every rank raises if it failed on one,
    so that no rank waits for a rank that is gone. Returns ``fn``'s result
    where it ran, else None."""
    result, error = None, None
    if selected:
        try:
            result = fn(*args, **kwargs)
        except Exception as e:  # re-raised below, after every rank knows
            error = e
    if agree_min(0 if error is not None else 1) == 0:
        if error is not None:
            raise error
        raise RuntimeError(f"{getattr(fn, '__name__', fn)} failed on another rank")
    return result


def all_gather_objects(obj: Any) -> list:
    """Every rank's ``obj``, in rank order (``[obj]`` for one process)."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj, group=_control_group())
    return out


def batch_shard(mesh=None) -> Tuple[int, int]:
    """``(index, count)`` of this rank's rows of a global batch: its block
    over the mesh's data x fsdp axes (``core.mesh.row_index``), else the
    process index and count."""
    if mesh is not None:
        from .mesh import row_index

        return row_index(mesh)
    return process_index(), process_count()


def process_local_batch_slice(global_batch_size: int, mesh=None) -> slice:
    """The per-process slice of a global batch (each process loads and
    feeds only its rows: its block of the data x fsdp axes)."""
    index, count = batch_shard(mesh)
    per_host = global_batch_size // count
    start = index * per_host
    return slice(start, start + per_host)


def slice_batch_for_process(batch: Dict[str, Any], mesh=None) -> Dict[str, Any]:
    """Cut a global batch down to this process's rows (``batch_shard``).
    Every leaf's leading dim is batch-derived (``pixel_values`` B; ids and
    mask B * concat), so the proportional slice is right for every key;
    numpy or torch leaves, nested dicts. A no-op for one process."""
    index, n = batch_shard(mesh)
    if n == 1:
        return batch

    def _slice(leaf):
        if isinstance(leaf, dict):
            return {k: _slice(v) for k, v in leaf.items()}
        per = leaf.shape[0] // n
        start = index * per
        return leaf[start : start + per]

    return _slice(batch)


def put_local_batch(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """This process's shard of a batch onto its device: numpy leaves through
    pinned host memory without blocking on a card, as they are on the CPU.
    The JAX package's ``put_global_batch`` assembles a global array from the
    shards; torch has none, and each rank steps on its own rows."""
    device = torch.device(device)
    out = {}
    for key, value in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(value)) if isinstance(value, np.ndarray) else value
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[key] = t
    return out


def hybrid_rank_layout(ici_shape: Sequence[int], dcn_shape: Optional[Sequence[int]] = None) -> np.ndarray:
    """The ranks of a hybrid mesh: axis ``i`` has ``dcn_shape[i] *
    ici_shape[i]`` entries, the host (DCN) index major and the local (ICI)
    index minor, with ranks numbered host by host as torchrun numbers them
    (``rank = host * prod(ici_shape) + local``)."""
    ici = tuple(int(x) for x in ici_shape)
    dcn = tuple(int(x) for x in dcn_shape) if dcn_shape is not None else (1,) * len(ici)
    if len(dcn) != len(ici):
        raise ValueError(f"dcn_shape {dcn} and ici_shape {ici} differ in rank")
    n = len(ici)
    ranks = np.arange(int(np.prod(dcn)) * int(np.prod(ici))).reshape(dcn + ici)
    # (d0.., i0..) -> (d0, i0, d1, i1, ...) -> (d0*i0, d1*i1, ...)
    order = [a for pair in zip(range(n), range(n, 2 * n)) for a in pair]
    return ranks.transpose(order).reshape(tuple(d * i for d, i in zip(dcn, ici)))


def create_hybrid_mesh(
    ici_shape: Sequence[int],
    dcn_shape: Optional[Sequence[int]] = None,
    axis_names: Tuple[str, ...] = ("data_parallel", "fsdp", "model_parallel"),
    device_type: Optional[str] = None,
):
    """A mesh whose axes span hosts (DCN: ``dcn_shape``, host-major) and
    the ranks of a host (ICI: ``ici_shape``), so that the collectives of the
    trailing axes stay within a host and only the leading axes cross hosts:
    the JAX function's layout with hosts for slices and a host's local
    ranks for a slice's chips (``hybrid_rank_layout``)."""
    from torch.distributed.device_mesh import DeviceMesh

    from .mesh import default_device_type

    layout = hybrid_rank_layout(ici_shape, dcn_shape)
    if layout.size != process_count():
        raise ValueError(f"a hybrid mesh of {layout.size} ranks in a world of {process_count()}")
    names = tuple(axis_names)[: layout.ndim]
    return DeviceMesh(device_type or default_device_type(), torch.from_numpy(layout), mesh_dim_names=names)
