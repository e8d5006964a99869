"""In-memory data loader honoring the streamer batch protocol.

The port's own copy of ``stable_diffusion_training_tpu/data/memory.py``.
Serves pre-built (or synthetic) numpy batches through the call-site
protocol of the streaming loader: ``grab_next_batch()`` returns a batch
dict, ``None`` (transient miss), or the ``"end_of_batch"`` sentinel, plus the
chunk calls the trainer makes. Batches are numpy, made with the same seeds
as the JAX package's, so the two packages see the same bytes.
"""

from typing import Dict, List, Sequence, Tuple

import numpy as np


def synthetic_batch(
    batch_size: int,
    resolution: Tuple[int, int],
    context_window: int = 77,
    concat_count: int = 3,
    vocab_size: int = 49408,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """One deterministic fake batch: NCHW f32 pixels in [-1,1], Nx77 int32 ids."""
    rng = np.random.default_rng(seed)
    w, h = resolution
    pixel_values = rng.uniform(-1.0, 1.0, size=(batch_size, 3, w, h)).astype(
        np.float32
    )
    input_ids = rng.integers(
        0, vocab_size, size=(batch_size * concat_count, context_window)
    ).astype(np.int32)
    attention_mask = np.ones_like(input_ids)
    return {
        "pixel_values": pixel_values,
        "input_ids": input_ids,
        "attention_mask": attention_mask,
    }


class InMemoryDataLoader:
    """Minimal loader: a list of batches plus the streamer protocol surface."""

    def __init__(self, batches: Sequence[Dict[str, np.ndarray]]):
        self._batches: List[Dict[str, np.ndarray]] = list(batches)
        self._cursor = 0
        self._print_debug = False
        self.chunk_number = 0
        self._bulk_batch_count = len(self._batches)
        self._first_batch_count = 0

    @classmethod
    def synthetic(
        cls,
        num_batches: int,
        batch_size: int,
        resolutions: Sequence[Tuple[int, int]],
        context_window: int = 77,
        concat_count: int = 3,
        vocab_size: int = 49408,
        seed: int = 0,
    ) -> "InMemoryDataLoader":
        batches = [
            synthetic_batch(
                batch_size,
                resolutions[i % len(resolutions)],
                context_window=context_window,
                concat_count=concat_count,
                vocab_size=vocab_size,
                seed=seed + i,
            )
            for i in range(num_batches)
        ]
        return cls(batches)

    # --- streamer protocol --------------------------------------------------
    def delete_prev_chunks(self, prev_chunk: int) -> None:
        pass

    def grab_and_prefetch_chunk(self, numb_of_prefetched_batch: int = 1) -> None:
        pass

    def prepare_training_dataframe(self) -> None:
        pass

    def create_training_dataframe(self) -> None:
        pass

    def dispatch_worker(self) -> None:
        self._cursor = 0

    def grab_next_batch(self):
        if self._cursor >= len(self._batches):
            return "end_of_batch"
        batch = self._batches[self._cursor]
        self._cursor += 1
        return batch
