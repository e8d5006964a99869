"""The port's ``utils/timing.py`` and ``utils/profiling.py`` against the JAX
package's, on the CPU: ``StepTimer``'s summaries and
``TimingContextManager``'s elapsed time on the same clock readings (both
modules' ``time.perf_counter`` replaced by one sequence), and
``estimate_unet_flops``, exactly; ``profiler_trace`` writes a Chrome trace
on the CPU (the JAX package's writes an XLA trace, so only the port's
file is read)."""

import json
import os

import pytest
import torch

from stable_diffusion_training_tpu.utils import profiling as jax_profiling
from stable_diffusion_training_tpu.utils import timing as jax_timing
from stable_diffusion_training_tpu_torch.utils import profiling, timing
from torch_threads import _one_thread  # noqa: F401 (the fixture)

# perf_counter readings: a start and an end per step, irregular gaps
READINGS = [0.0, 0.5, 1.0, 1.25, 2.0, 2.75, 3.0, 3.125, 4.0, 4.375, 5.0, 6.0]


@pytest.mark.parametrize("skip_first", [0, 1, 3])
def test_step_timer_matches_jax(monkeypatch, skip_first):
    summaries = []
    for module in (profiling, jax_profiling):
        readings = iter(READINGS)
        monkeypatch.setattr(module.time, "perf_counter", lambda: next(readings))
        timer = module.StepTimer(skip_first=skip_first)
        for _ in range(len(READINGS) // 2):
            with timer.step():
                pass
        summaries.append(timer.summary())
        monkeypatch.undo()
    assert summaries[0] == summaries[1]
    assert summaries[0]["steps"] == len(READINGS) // 2 - skip_first
    assert profiling.StepTimer().summary() == {}


@pytest.mark.parametrize("args", [(8, 64, 64, None), (8, 96, 96, 865_910_724), (4, 128, 128, 2_567_463_684),
                                  (1, 96, 112, None)])
def test_estimate_unet_flops_matches_jax(args):
    assert profiling.estimate_unet_flops(*args) == jax_profiling.estimate_unet_flops(*args)


@pytest.mark.parametrize("quiet", [False, True])
def test_timing_context_manager_matches_jax(monkeypatch, capsys, quiet):
    results = []
    for module in (timing, jax_timing):
        readings = iter([10.0, 12.5])
        monkeypatch.setattr(module.time, "perf_counter", lambda: next(readings))
        with module.TimingContextManager("lowering 768x768", quiet=quiet) as t:
            pass
        results.append((t.elapsed, capsys.readouterr().out))
        monkeypatch.undo()
    assert results[0] == results[1]
    assert results[0][0] == 2.5
    assert results[0][1] == ("" if quiet else "[timing] lowering 768x768: 2.5000s\n")


def test_profiler_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    """CPU activity only (the device is the CPU): one ``trace_*.json`` with
    the enclosed ops; a disabled trace yields None and writes nothing."""
    with profiling.profiler_trace(str(tmp_path / "off"), enabled=False) as prof:
        assert prof is None
    assert not os.path.exists(tmp_path / "off")
    with profiling.profiler_trace(str(tmp_path / "on"), device="cpu") as prof:
        torch.matmul(torch.ones(16, 16), torch.ones(16, 16))
    assert prof is not None
    files = os.listdir(tmp_path / "on")
    assert len(files) == 1 and files[0].startswith("trace_") and files[0].endswith(".json")
    with open(tmp_path / "on" / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::matmul" in names
