"""Profiling: a ``torch.profiler`` capture and per-step timing.

Port of ``stable_diffusion_training_tpu/utils/profiling.py``. Where the JAX
package writes an XLA profiler trace, ``profiler_trace`` records the host's
and, on a CUDA device, the card's activity with ``torch.profiler`` and
writes it as a Chrome trace (``chrome://tracing``, Perfetto) into the
directory, from rank 0 alone under data parallelism. ``StepTimer`` keeps
per-step wall clock with p50/p90 summaries;
``estimate_unet_flops`` is the JAX package's rough FLOPs a step.
``annotate_launch`` names each launch of the port's kernels in a trace with
its wrapper, shape and work (``utils.roofline`` reads it).
"""

import contextlib
import os
import time
from typing import Callable, ContextManager, Dict, List, Optional, Sequence

import numpy as np
import torch

from .roofline import Work, launch_name


def annotate_launch(entry: str, key: Sequence, work: Callable[[], Work]) -> ContextManager:
    """While a profiler records: a ``record_function`` around a kernel
    launch, named by ``utils.roofline.launch_name`` with the wrapper's name,
    its shape key and ``work()`` (the wrapper's own count of the launch's
    work), which the trace shows as the op that launched the kernel;
    otherwise nothing but the check of a flag."""
    if not torch.autograd._profiler_enabled():
        return contextlib.nullcontext()
    return torch.profiler.record_function(launch_name(entry, key, work()))


@contextlib.contextmanager
def profiler_trace(logdir: str, enabled: bool = True, device="cuda"):
    """Record the enclosed block with ``torch.profiler`` (CPU activity, and
    CUDA activity when ``device`` is a CUDA device) and write the Chrome
    trace ``trace_<pid>_<ns>.json`` into ``logdir``. Yields the profiler
    (None when disabled, and on every rank but rank 0)."""
    from ..core.distributed import process_index  # core imports utils

    if not enabled or process_index() != 0:
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
