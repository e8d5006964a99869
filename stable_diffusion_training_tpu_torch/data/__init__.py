"""Data for the port's trainer, ported from ``stable_diffusion_training_tpu/data``:
aspect-ratio buckets, the in-memory loader with the streamer protocol, and
the offline latent cache (VAE moments and SDXL's frozen-tower conditioning,
read back by ``CachedLatentLoader``). The streaming ``DataLoader`` is not
ported yet (ROADMAP Queue 1 item 4)."""

from .buckets import all_bucket_resolutions, assign_bucket, calculate_resolution_array
from .latent_cache import (
    CachedLatentLoader,
    cache_batches_to_dir,
    compute_encoder_hidden_states,
    compute_pooled_text_embeds,
    encode_batch_to_moments,
    precompute_latent_cache,
    sdxl_time_ids,
)
from .memory import InMemoryDataLoader, synthetic_batch

__all__ = [
    "CachedLatentLoader",
    "InMemoryDataLoader",
    "all_bucket_resolutions",
    "assign_bucket",
    "cache_batches_to_dir",
    "calculate_resolution_array",
    "compute_encoder_hidden_states",
    "compute_pooled_text_embeds",
    "encode_batch_to_moments",
    "precompute_latent_cache",
    "sdxl_time_ids",
    "synthetic_batch",
]
