"""Data for the port's trainer: aspect-ratio buckets and the in-memory
loader with the streamer protocol, ported from
``stable_diffusion_training_tpu/data``. The streaming ``DataLoader`` is
not ported yet (ROADMAP Queue 1 item 4)."""

from .buckets import all_bucket_resolutions, assign_bucket, calculate_resolution_array
from .memory import InMemoryDataLoader, synthetic_batch

__all__ = [
    "InMemoryDataLoader",
    "all_bucket_resolutions",
    "assign_bucket",
    "calculate_resolution_array",
    "synthetic_batch",
]
