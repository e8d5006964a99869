"""Wall-clock timing context, used around the step table's assembly
(``train/aot.py``). Port of ``stable_diffusion_training_tpu/utils/timing.py``."""

import time


class TimingContextManager:
    """``with TimingContextManager("lowering 512x512"): ...`` prints elapsed time."""

    def __init__(self, label: str = "", quiet: bool = False):
        self.label = label
        self.quiet = quiet
        self.elapsed = None

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.elapsed = time.perf_counter() - self._start
        if not self.quiet:
            print(f"[timing] {self.label}: {self.elapsed:.4f}s")
        return False
