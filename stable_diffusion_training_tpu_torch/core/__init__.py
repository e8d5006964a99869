"""The process group and its mesh: ``initialize_distributed`` joins the
ranks (torchrun's environment), ``create_mesh`` names their axes."""

from .distributed import (
    initialize_distributed,
    process_count,
    process_index,
    put_local_batch,
    rank_device,
    slice_batch_for_process,
)
from .mesh import AXIS_DATA, AXIS_FSDP, AXIS_TENSOR, create_mesh, get_default_mesh, set_default_mesh

__all__ = [
    "AXIS_DATA",
    "AXIS_FSDP",
    "AXIS_TENSOR",
    "create_mesh",
    "get_default_mesh",
    "initialize_distributed",
    "process_count",
    "process_index",
    "put_local_batch",
    "rank_device",
    "set_default_mesh",
    "slice_batch_for_process",
]
