"""Data parallelism, FSDP and tensor parallelism over the mesh: replicated
state and summed grads, state sharded over the ``fsdp`` axis, or the
attention and CLIP projections split over ``model_parallel``
(``sharding``'s FSDP and TP halves)."""

from .sharding import all_reduce_grads_, assert_replicated, replicate_, state_digest, tensor_parallel_, tp_plan

__all__ = ["all_reduce_grads_", "assert_replicated", "replicate_", "state_digest", "tensor_parallel_", "tp_plan"]
