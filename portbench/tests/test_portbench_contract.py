"""``BENCHMARK.json`` and ``run.py`` against the benchmark's contract: the
file's keys, names, units, bounds and files; the result's last line with
the card stubbed by the CPU; no result without a card or without the port;
no module of JAX or of the JAX package loaded by a whole run."""

import io
import json
import os
import re
import shutil
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from portbench_tiny import ROOT, tiny_cell

from portbench import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_keys_names_and_files(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"] and bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [x["name"] for part in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[part]]
    assert all(NAME.match(n) for n in names)
    for part in ("configs", "workloads"):
        assert len({x["name"] for x in bench[part]}) == len(bench[part])
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["file"].startswith("portbench/")
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"] and "\t" not in c["why"]
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["traffic"]) and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert os.path.isfile(os.path.join(ROOT, "portbench", "traffic", w["traffic"] + ".json"))
        assert os.path.isfile(os.path.join(ROOT, "portbench", "workloads", w["name"] + ".json"))
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(bench["workloads"])


def test_metrics_units_bounds_and_readers(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert {"images_per_s", "peak_mem_gb", "setup_s"} <= e2e
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert next(m for m in bench["end_to_end"] if m["name"] == "setup_s")["bound"] == 0.25
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e and set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert os.path.isfile(os.path.join(ROOT, "portbench", "metrics", m["name"] + ".py"))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_loads_with_its_limits(bench):
    for w in bench["workloads"]:
        cell = run.load_cell(w["name"])
        assert set(cell["check"]["limits"]) == {"loss_gap", "grad_gap", "change_gap", "ema_gap"}
        assert {m["name"] for m in cell["end_to_end"]} == {"images_per_s", "peak_mem_gb", "setup_s"}
        assert cell["per_layer"]


def _main_on_cpu(monkeypatch, trace):
    cell = tiny_cell("tiny")
    monkeypatch.setattr(run, "load_cell", lambda name: cell)
    monkeypatch.setattr(run, "device_of", lambda cell, device=None: torch.device("cpu"))
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(["--workload", "tiny", "--seed", str(2**31 + 7), "--seconds", "0.5", "--trace", str(trace)])
    return rc, cell, out.getvalue().strip().splitlines()[-1], err.getvalue().strip().splitlines()


@pytest.mark.parametrize("trace", [0, 1])
def test_the_last_line_with_the_card_stubbed(monkeypatch, trace):
    rc, cell, last, err = _main_on_cpu(monkeypatch, trace)
    assert rc == 0
    result = json.loads(last)
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"] and keys[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 4
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(result["metrics"]) <= {m["name"] for m in cell["per_layer"]}
        assert "mfu" in result["metrics"] and result["device"]["window_s"] > 0
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == {m["name"] for m in cell["end_to_end"]}
        assert all(set(v) == {"value", "unit"} for v in result["metrics"].values())
    assert set(result["checks"]) == {"loss_gap", "grad_gap", "change_gap", "ema_gap", "failed_steps"}
    assert list(result["checks"])[-1] == "failed_steps" and list(result)[-1] == "checks"
    assert all(line.startswith("check ") for line in err[-5:])


@pytest.mark.parametrize("fault,number", [("unchanged_state", "change_gap"), ("half_batch", "loss_gap"),
                                          ("skipped_ema", "ema_gap")])
def test_a_planted_fault_comes_out_not_correct(monkeypatch, fault, number):
    """A whole run with the timed path broken underneath, once for each
    fault a one-card training cell can have (it holds no exchange between
    chips and produces no token)."""
    cell = tiny_cell("tiny")
    result = run.run_cell(cell, 2**31 + 9, 0.3, False, device="cpu", fault=fault)
    assert result["correct"] is False
    assert result["checks"][number]["value"] > 10 * result["checks"][number]["limit"]


def test_no_card_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: this checks the run without one")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "portbench", "run.py"), "--workload", "sd15-train-512",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 2 and proc.stdout == ""


def test_no_port_no_result(tmp_path):
    """A directory with only BENCHMARK.json and portbench/ gives no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "sd15-train-512", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


def test_a_whole_run_loads_nothing_of_jax():
    """A traced tiny run on the CPU, in a fresh process: every module of the
    cell's path loaded, none whose top-level name is JAX's or the JAX
    package's (compared whole: the port's name begins with the latter)."""
    code = (
        "import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "import torch, importlib\n"
        "from portbench_tiny import tiny_cell\n"
        "from portbench import run, calibrate\n"
        "for m in ('mfu', 'idle_share', 'attention_roofline', 'gemm_conv_roofline', 'optimizer_host_ms',"
        " 'optimizer_device_ms', 'elementwise_ms'): importlib.import_module('portbench.metrics.' + m)\n"
        "for fam in ('tiny', 'tiny_sdxl'): run.run_cell(tiny_cell(fam), 3, 0.2, True, device='cpu')\n"
        "print(sorted(n for n in sys.modules if n.split('.')[0] == 'stable_diffusion_training_tpu_torch')[:1])\n"
        "print(run.forbidden_modules())\n"
    ) % (ROOT, os.path.join(ROOT, "portbench", "tests"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-2] != "[]"  # the port was loaded
    assert lines[-1] == "[]"
