"""Each per-layer reader (``portbench/metrics``) on a small Chrome trace
written here: one attention call and its backward on another thread, one
recorded matmul, one optimizer span; and the breakdown."""

import gzip
import importlib
import json

import pytest

import portbench_tiny  # noqa: F401  (puts the repository on the path)

from portbench.trace import chrome, work
from portbench.trace.view import TraceView, attention_work, parse_attention

ATTN = "portbench.attention b=1 sq=64 sk=64 h=2 d=8 dtype=bfloat16 grad=1"
STEPS = 2


def op(name, ts, dur, tid=1, cat="cpu_op", **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts, "dur": dur, "args": args}


def launch(ts, corr, tid=1):
    return op("cudaLaunchKernel", ts, 2, tid, "cuda_runtime", correlation=corr)


def kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def write_trace(path):
    events = [
        op(ATTN, 100, 50, cat="user_annotation"),
        op("FlashFunction", 110, 20, **{"Sequence number": 7, "External id": 1}),
        launch(115, 1),
        op("aten::mm", 200, 20, **{"External id": 2, "Input Dims": [[64, 32], [32, 16]],
                                   "Input type": ["c10::BFloat16", "c10::BFloat16"], "Concrete Inputs": ["", ""]}),
        launch(205, 2),
        op("portbench.optimizer.apply_gradients", 300, 100, cat="user_annotation"),
        op("aten::add_", 305, 20, **{"External id": 3}),
        launch(310, 3),
        op("autograd::engine::evaluate_function: FlashFunctionBackward", 500, 40, tid=2,
           **{"Sequence number": 7, "External id": 4}),
        launch(510, 4, tid=2),
        kernel("void flash_fwd_tma_kernel<40, false>(Params)", 120, 10, 1),
        kernel("nvjet_tst_128x64_64x4_1x2_h_bz_TNT", 210, 5, 2),
        kernel("void at::native::vectorized_elementwise_kernel<4, add>(int, F)", 320, 30, 3),
        kernel("void flash_bwd_fused_kernel<40>(Params)", 520, 20, 4),
    ]
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events, "deviceProperties": [{"id": 0}]}, f)


@pytest.fixture
def view(tmp_path):
    path = tmp_path / "trace.json.gz"
    write_trace(path)
    v = TraceView(str(path), STEPS)
    v.window = {"images": 64, "seconds": 2.0, "steps": 8, "flops": 64 * 1e12}
    v.peak_flops = 989e12
    return v


def read(name, view):
    return importlib.import_module(f"portbench.metrics.{name}").read(view)


def test_attention_roofline_counts_the_forward_and_its_backward(view):
    fwd, bwd = attention_work(parse_attention(ATTN))
    assert fwd.flops == 4 * 2 * 64 * 64 * 8 and bwd.flops == 2 * fwd.flops
    expected = 100 * (fwd.bound()[0] + bwd.bound()[0]) / ((10 + 20) / 1e3)
    assert read("attention_roofline", view) == pytest.approx(expected)


def test_gemm_conv_roofline_reads_the_recorded_matmul_alone(view):
    w = work.Work(2.0 * 64 * 16 * 32, 0.0, 2 * (64 * 32 + 32 * 16 + 64 * 16), "bfloat16")
    assert read("gemm_conv_roofline", view) == pytest.approx(100 * w.bound()[0] / (5 / 1e3))


def test_optimizer_elementwise_and_idle(view):
    assert read("optimizer_host_ms", view) == pytest.approx(100 / 1e3 / STEPS)
    assert read("optimizer_device_ms", view) == pytest.approx(30 / 1e3 / STEPS)
    assert read("elementwise_ms", view) == pytest.approx(30 / 1e3 / STEPS)
    assert read("idle_share", view) == pytest.approx(100 * (1 - 65 / 440))
    assert view.busy_s() == pytest.approx(65e-6)


def test_mfu_reads_the_window(view):
    assert read("mfu", view) == pytest.approx(100 * 64 * 1e12 / 2.0 / 989e12)
    view.window = None
    assert read("mfu", view) is None


def test_categories_and_breakdown(view):
    assert chrome.categorize("nvjet_tst_128x64_64x4_1x2_h_bz_TNT") == "gemm"
    out = view.breakdown()
    assert out["device_ops"][0] == ["at::native::vectorized_elementwise_kernel", pytest.approx(30e-6)]
    longest = out["idle_gaps"][0]
    assert longest[1] == pytest.approx((520 - 350) * 1e-6)


def test_a_reader_with_nothing_to_read_returns_none(tmp_path):
    path = tmp_path / "empty.json"
    path.write_text(json.dumps({"traceEvents": [op("aten::relu", 1, 1)]}))
    v = TraceView(str(path), 1)
    for name in ("attention_roofline", "gemm_conv_roofline", "optimizer_host_ms", "optimizer_device_ms",
                 "elementwise_ms"):
        assert read(name, v) is None
