"""On the card (``cuda`` marker; skipped without one): a whole tiny traced
run through the port's kernels, correct against the reference, with every
per-layer reader finding its spans and kernels; and the fp8 control not
correct under the limits that the bf16 program meets there.

    python -m pytest portbench/tests -q -m cuda
"""

import pytest
import torch

from portbench_tiny import tiny_cell

from portbench import calibrate, run


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["tiny", "tiny_sdxl"])
def test_a_traced_tiny_run_on_the_card(family):
    device = _card()
    cell = tiny_cell(family, limits={"loss_gap": 1e-3, "grad_gap": 1e-2, "change_gap": 5e-2, "ema_gap": 1e-3})
    result = run.run_cell(cell, 2**31 + 21, 1.0, True, device=device)
    assert result["failed"] == 0
    assert result["_forbidden"] == []
    for name in ("mfu", "idle_share", "gemm_conv_roofline", "optimizer_host_ms", "optimizer_device_ms",
                 "elementwise_ms", "attention_roofline"):
        assert name in result["metrics"], name
    assert 0 < result["metrics"]["mfu"]["value"] < 100
    assert result["device"]["busy_s"] > 0


# the tiny bf16 cell's limits: its change swings with the few elements that
# a bf16 Lion step moves at these widths, and is not what separates here
BF16_LIMITS = {"loss_gap": 1e-3, "grad_gap": 0.05, "change_gap": 1.0, "ema_gap": 0.05}


def control_lines(device):
    cell = tiny_cell("tiny", "bfloat16", limits=BF16_LIMITS)
    cell["traffic"]["resolution"] = [64, 64]
    return {line["kind"]: line for line in calibrate.calibrate(cell, [2**31 + 5], 1, 0, device=device)}


@pytest.mark.cuda
def test_the_fp8_control_reads_above_the_bf16_program_on_the_card():
    by = control_lines(_card())
    assert by["program"]["correct"] is True
    assert by["control"]["correct"] is False
    assert by["control"]["loss_gap"] > 5 * by["program"]["loss_gap"]
    assert by["control"]["grad_gap"] > 2 * by["program"]["grad_gap"]
