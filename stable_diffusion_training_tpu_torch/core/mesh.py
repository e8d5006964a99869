"""The process group as a mesh of named axes.

Port of ``stable_diffusion_training_tpu/core/mesh.py``. The reference pins a
``(device_count, 1)`` mesh with axes ``("data_parallel", "model_parallel")``
(its ``training_utils.py:24-37``) and only ever uses data parallelism; the
JAX package builds that mesh, or the three-axis ``(data_parallel, fsdp,
model_parallel)`` one, over devices, the port over the ranks of the
``torch.distributed`` process group, one per card, as a
``torch.distributed.device_mesh.DeviceMesh`` (``init_device_mesh`` with
``mesh_dim_names``). The JAX module's ``replicated`` and ``batch_sharding``
have no torch meaning: a rank holds whole tensors, replicated by
``parallel.sharding.replicate_``, its FSDP shards
(``parallel.sharding.fully_shard_``) or its slices of the tensor-parallel
leaves (``parallel.sharding.tensor_parallel_``, over ``model_parallel``,
the rank's place on it ``axis_index(mesh, AXIS_TENSOR)``), and its own
rows of each batch (``row_index``: the rows split over ``data_parallel`` x
``fsdp``, so the ``model_parallel`` ranks of a row block see the same rows
and, seeded alike, the same draws). On a ``[D, F, T]`` mesh a rank's
groups are its fsdp ranks (``mesh[AXIS_FSDP]``, the sub-mesh of the ranks
that share its data and model_parallel places: FSDP2 shards over it), its
model_parallel ranks (``mesh.get_group(AXIS_TENSOR)``: the TP sums and the
whole leaves' broadcast) and the world.
"""

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXIS_DATA = "data_parallel"
AXIS_FSDP = "fsdp"
AXIS_TENSOR = "model_parallel"
MESH_AXES = (AXIS_DATA, AXIS_FSDP, AXIS_TENSOR)

_DEFAULT = {"mesh": None}


def default_device_type() -> str:
    """``cuda`` where there is a card, else ``cpu``."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def create_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Optional[Sequence[str]] = None,
    device_type: Optional[str] = None,
):
    """A ``DeviceMesh`` over the process group's ranks, laid out row-major
    (rank ``r`` at the mesh coordinate of ``r`` in ``shape``'s order). The
    default shape is ``(world_size, 1)``: data parallelism over every rank,
    as the JAX default is ``(device_count, 1)``; three axes name
    ``(AXIS_DATA, AXIS_FSDP, AXIS_TENSOR)``. The product of ``shape`` must
    be the world size. Needs a process group (``initialize_distributed``);
    every rank calls it, since it forms the axes' groups."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: call core.distributed.initialize_distributed first")
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    shape = (world, 1) if shape is None else tuple(int(s) for s in shape)
    if axis_names is None:
        axis_names = MESH_AXES if len(shape) == 3 else (AXIS_DATA, AXIS_TENSOR)
    names = tuple(axis_names)
    if len(names) != len(shape):
        raise ValueError(f"mesh shape {shape} and axis names {names} differ in length")
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} holds {math.prod(shape)} ranks, the world has {world}")
    return init_device_mesh(device_type or default_device_type(), shape, mesh_dim_names=names)


def set_default_mesh(mesh) -> None:
    _DEFAULT["mesh"] = mesh


def get_default_mesh():
    """The data-parallel default mesh, built on first use."""
    if _DEFAULT["mesh"] is None:
        _DEFAULT["mesh"] = create_mesh()
    return _DEFAULT["mesh"]


def axis_size(mesh, axis: str = AXIS_DATA) -> int:
    """Ranks along ``axis`` (1 for no mesh or an axis it lacks)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str = AXIS_DATA) -> int:
    """This rank's coordinate along ``axis`` (0 for no mesh or an axis it
    lacks)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(axis)


def row_index(mesh) -> Tuple[int, int]:
    """``(index, count)``: this rank's block of rows of a global batch, the
    batch split into ``count`` = data x fsdp equal blocks, indexed data-major
    as the mesh lays the axes out (``(0, 1)`` for no mesh)."""
    fsdp = axis_size(mesh, AXIS_FSDP)
    return axis_index(mesh, AXIS_DATA) * fsdp + axis_index(mesh, AXIS_FSDP), axis_size(mesh, AXIS_DATA) * fsdp
