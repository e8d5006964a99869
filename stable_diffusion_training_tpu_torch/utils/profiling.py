"""Profiling: a ``torch.profiler`` capture and per-step timing.

Port of ``stable_diffusion_training_tpu/utils/profiling.py``. Where the JAX
package writes an XLA profiler trace, ``profiler_trace`` records the host's
and, on a CUDA device, the card's activity with ``torch.profiler`` and
writes it as a Chrome trace (``chrome://tracing``, Perfetto) into the
directory. ``StepTimer`` keeps per-step wall clock with p50/p90 summaries;
``estimate_unet_flops`` is the JAX package's rough FLOPs a step.
"""

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def profiler_trace(logdir: str, enabled: bool = True, device="cuda"):
    """Record the enclosed block with ``torch.profiler`` (CPU activity, and
    CUDA activity when ``device`` is a CUDA device) and write the Chrome
    trace ``trace_<pid>_<ns>.json`` into ``logdir``. Yields the profiler
    (None when disabled)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StepTimer:
    """Wall-clock step timer with percentile summaries.

    Usage::

        timer = StepTimer()
        with timer.step():
            loss = train_step(...)[4]["loss"].item()
        print(timer.summary())
    """

    def __init__(self, skip_first: int = 1):
        self.times: List[float] = []
        self.skip_first = skip_first
        self._seen = 0

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self._seen += 1
        if self._seen > self.skip_first:
            self.times.append(dt)

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "steps": int(arr.size),
            "p50_s": float(np.percentile(arr, 50)),
            "p90_s": float(np.percentile(arr, 90)),
            "mean_s": float(arr.mean()),
            "min_s": float(arr.min()),
        }


def estimate_unet_flops(
    batch: int, latent_h: int, latent_w: int, params: Optional[int] = None
) -> float:
    """Rough FLOPs-per-step estimate for roofline reporting: ~3x forward
    cost for fwd+bwd, forward ~= 2 * params * tokens-equivalent."""
    params = params or 860_000_000  # SD1.5 UNet
    spatial = latent_h * latent_w
    return 3.0 * 2.0 * params * batch * (spatial / 4096.0)
