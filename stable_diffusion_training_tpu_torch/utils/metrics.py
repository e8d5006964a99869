"""Training metrics writers.

The port's own copy of ``stable_diffusion_training_tpu/utils/metrics.py``:
TensorBoard scalars next to (never instead of) the reference-compatible
``loss.csv``, opt-in through the config's ``tensorboard_dir``. Under data
parallelism rank 0 alone writes them.
"""

from typing import Optional



class MetricsWriter:
    """Scalar metrics sink; TensorBoard-backed when a log dir is given.

    Deliberately tiny surface (``scalar``/``flush``/``close``) so the trainer
    stays decoupled from the backend; with ``log_dir=None``, and on every
    rank but rank 0, every call is a no-op and nothing is imported.
    """

    def __init__(self, log_dir: Optional[str] = None):
        self._writer = None
        from ..core.distributed import process_index  # core imports utils

        if log_dir and process_index() == 0:
            # self-contained event-file writer (tb_events): scalars need no
            # tensorboard package
            from .tb_events import EventFileWriter

            self._writer = EventFileWriter(log_dir)

    @property
    def active(self) -> bool:
        return self._writer is not None

    def scalar(self, tag: str, value, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, float(value), int(step))

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
