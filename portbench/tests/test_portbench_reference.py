"""The plain reference (``portbench/reference``) against the port on the
CPU: the tiny SD1.5-shaped and SDXL-shaped families in f32, the checked
steps' numbers far under the cells' limits; the reference's models on the
port's own names and shapes; the control and the planted faults read
above the program; the EMA moves in bf16 too, so that a skipped EMA reads
1 there."""

import pytest
import torch

from portbench_tiny import tiny_cell

from portbench import compare, run
from portbench.reference.numerics import Numerics
from portbench.traffic import make_inputs

SEED = 2**31 + 12345


def readings(cell, fault=None, num=None):
    config, traffic, check = cell["config"], cell["traffic"], cell["check"]
    device = torch.device("cpu")
    inputs = make_inputs(traffic, config, run.derived_seed(SEED, 2), device)
    if num is None:
        program = run.Program(config, traffic, device)
        run.load_program(program, config, traffic, SEED, device)
        side = run.program_readings(program, inputs, check["checked_steps"], fault)
    else:
        side = run.reference_readings(config, traffic, SEED, inputs, check["checked_steps"], 2, device, num)
    ref = run.reference_readings(config, traffic, SEED, inputs, check["checked_steps"], 2, device)
    return compare.numbers(side, ref)


@pytest.mark.parametrize("family", ["tiny", "tiny_sdxl"])
def test_reference_follows_the_port_in_f32(family):
    nums = readings(tiny_cell(family))
    assert nums["loss_gap"] < 1e-5
    assert nums["grad_gap"] < 1e-3
    assert nums["change_gap"] < 1e-2
    assert nums["ema_gap"] < 1e-5
    assert nums["leaves_kept"] > 0.8 * nums["leaves"]
    assert nums["ema_leaves"] == nums["leaves"]  # every trained model keeps an EMA


@pytest.mark.parametrize("family", ["tiny", "tiny_sdxl"])
def test_reference_modules_have_the_ports_names_and_shapes(family):
    cell = tiny_cell(family)
    program = run.Program(cell["config"], cell["traffic"], torch.device("cpu"))
    for key in run.model_keys(cell["config"], cell["traffic"]):
        with torch.device("meta"):
            ref = dict(run.reference_module(key, cell["config"]).named_parameters())
        port = dict(program.modules()[key].named_parameters())
        assert set(ref) <= set(port)
        assert all(port[n].shape == p.shape for n, p in ref.items())
        if key != "vae":  # the port's VAE also holds the decoder, which the step does not run
            assert set(ref) == set(port)


@pytest.mark.parametrize("fault", ["half_batch", "unchanged_state", "skipped_ema"])
def test_a_planted_fault_reads_far_above_the_program(fault):
    nums = readings(tiny_cell("tiny"), fault=fault)
    assert max(nums["loss_gap"] / 1e-5, nums["change_gap"] / 1e-2, nums["ema_gap"] / 1e-5) > 10


@pytest.mark.parametrize("family", ["tiny", "tiny_sdxl"])
def test_the_ema_moves_in_bf16_and_a_skipped_one_reads_one(family):
    """In bf16 the program's EMA rate rounds to 1 and only the elements far
    smaller than their parameter move: enough that both sides' EMA change,
    and the same change on both."""
    cell = tiny_cell(family, "bfloat16")
    assert readings(cell)["ema_gap"] < 1e-3
    assert readings(cell, fault="skipped_ema")["ema_gap"] == 1.0


def test_the_control_reads_far_above_the_program_in_bf16():
    """fp8 products against the bf16 reference, and the bf16 program."""
    cell = tiny_cell("tiny", "bfloat16")
    control = readings(cell, num=Numerics("fp8"))
    program = readings(cell)
    assert control["loss_gap"] > 10 * program["loss_gap"]
    assert control["grad_gap"] > 5 * program["grad_gap"]


def test_fp8_rounding_is_coarser_than_bf16_and_passes_gradients():
    x = torch.randn(4096, dtype=torch.float32, requires_grad=True)
    from portbench.reference.numerics import round_fp8
    y = round_fp8(x)
    rel = ((y - x).abs() / x.abs().clamp(min=1e-3)).median()
    assert 2**-9 < rel < 2**-3
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
