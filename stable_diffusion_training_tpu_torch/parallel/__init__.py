"""Data parallelism and FSDP over the mesh: replicated state and summed
grads, or state sharded over the ``fsdp`` axis (``sharding``'s FSDP half)."""

from .sharding import all_reduce_grads_, assert_replicated, replicate_, state_digest

__all__ = ["all_reduce_grads_", "assert_replicated", "replicate_", "state_digest"]
