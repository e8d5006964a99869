"""Data parallelism over the mesh: replicated state and summed grads."""

from .sharding import all_reduce_grads_, assert_replicated, replicate_, state_digest

__all__ = ["all_reduce_grads_", "assert_replicated", "replicate_", "state_digest"]
