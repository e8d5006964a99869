"""TP with FSDP on four gloo ranks of the CPU: the step on a ``(1, 2, 2)``
mesh against the one-process step and against the JAX step on the same
mesh.

One four-rank world (``tests/torch_dist_child.py``) runs every case on a
``(data_parallel, fsdp, model_parallel) = (1, 2, 2)`` mesh with
``tensor_parallel_shard_params`` and ``fsdp_shard_params``: the attention
projections of the UNet and the text encoder and CLIP's MLP split
Megatron-style over the two model_parallel ranks, then every rank's leaves
sharded with FSDP2 over its two fsdp ranks; the Lion state and EMA on each
rank's local shards. Rank ``r`` is ``(fsdp, model_parallel) = (r // 2, r %
2)``: the fsdp ranks take the rows of a global batch of 2 (4 with
accumulation) one each, the model_parallel ranks of a row the same row and
draws. A rank's dump holds whole tensors, gathered from the shards and
slices in two rounds, so the four dumps are compared bitwise with each
other, then:

- against the one-process step on the same global batch and draws: plain,
  ``grad_accumulation_steps=2``, a frozen text encoder, the latent cache,
  gradient checkpointing (its recompute gathers nothing again: the step's
  FSDP2 all-gathers are counted), and the plain step with every collective
  on the route of gloo ranks of one card (``_CardExchange``, here over CPU
  shared memory);
- without ``fsdp_shard_params``: the fsdp ranks are data parallel, the
  ``[2, 1, 2]`` layout;
- with the model_parallel rank 1s' grads of the leaves TP leaves whole off
  by a rounding step (as a card's run-to-run sums may leave them): they take
  their axis partner's, after FSDP2's reduce-scatter, so the step is the
  plain one bitwise;
- against the JAX ``train_step`` on a ``(1, 2, 2)`` mesh of four of
  conftest's virtual CPU devices with both flags (``train_state_tp_sharding(
  fsdp_rest=True)``: Megatron specs on the params, the optimizer state
  sharded over fsdp, the Pallas Lion ``shard_map``'d in interpret mode),
  JAX's draws injected, from JAX's initial state restored into the ranks'
  shards; that state, saved again by the ranks, is the same files byte for
  byte.

Each rank's local Lion codes and scales are its part of the gathered ones
(the composed rule: the 32-wide attentions' q, k and v, 8 output channels a
rank, and ``conv_out``, 2, keep their whole momentum in the tiny models),
and the step's sums over the model_parallel axis are counted as under TP
alone.

Tolerances: those of ``tests/test_torch_port_train_step.py`` (loss 1e-5
relative, params and EMA 2 lr + 1e-6, at most 1e-3 of the update signs,
codes more than one apart only at |code| <= 10 and for at most 1e-4 of
them, scales 1e-2 relative), via ``test_torch_port_distributed``'s
``assert_dump_matches``: the reduce-scatter and the split layers sum in
another order, which is all that moves a sign or a code.
"""

import os
import time

import jax
import pytest
import torch

import torch_dist_child as child
from stable_diffusion_training_tpu.core.mesh import create_mesh as jax_create_mesh
from stable_diffusion_training_tpu.train import (
    TrainingConfig as JaxTrainingConfig,
    on_device_model_training_state as jax_training_state,
)
from stable_diffusion_training_tpu_torch.train import TrainingConfig, on_device_model_training_state
from stable_diffusion_training_tpu_torch.train import save_train_state
from test_torch_port_distributed import STEP_CASES, _run_jax_step, _step_cases, assert_dump_matches, assert_ranks_equal
from test_torch_port_tp import _sums
from test_torch_port_train_step import _batch, _config, _jax_draws, _load_jax_state
from torch_threads import _one_thread  # noqa: F401 (the fixture)

WORLD = 4
MESH = (1, 2, 2)
BOTH = dict(mesh_shape=list(MESH), fsdp_shard_params=True, tensor_parallel_shard_params=True)
DEADLINE_S = 300
CASES = STEP_CASES + ("gradient-checkpointing", "card-exchange")


def _cases(tmp):
    """Every case on the (1, 2, 2) mesh; the fsdp ranks split the rows as
    the two FSDP ranks of ``tests/test_torch_port_fsdp.py`` do."""
    cases = {name: dict(case, mesh=MESH, config={**case["config"], **BOTH}) for name, case in _step_cases().items()}
    cases["gradient-checkpointing"] = dict(cases["plain"], config={**BOTH, "gradient_checkpointing": True})
    cases["card-exchange"] = dict(cases["plain"], card_exchange=True)
    cases["rounded-whole-grads"] = dict(cases["plain"], rounding_rank=1)
    cases["rounded-whole-grads-3"] = dict(cases["plain"], rounding_rank=3)
    cases["tp-only"] = dict(cases["plain"], config={**BOTH, "fsdp_shard_params": False})
    devices = jax.devices()[:WORLD]
    mesh = jax_create_mesh(shape=MESH, axis_names=("data_parallel", "fsdp", "model_parallel"), devices=devices)
    jax_states = jax_training_state(
        _config(JaxTrainingConfig, "v-zero-snr", tensor_parallel_shard_params=True, fsdp_shard_params=True), mesh=mesh
    )
    port_states = on_device_model_training_state(_config(TrainingConfig, "v-zero-snr"), device="cpu")
    _load_jax_state(port_states, jax_states)
    state_dir = os.path.join(tmp, "jax_state")
    save_train_state(state_dir, *port_states[:4], torch.Generator())
    torch.save(port_states[4].call.state_dict(), os.path.join(state_dir, "vae.pt"))
    rng = jax.random.PRNGKey(7)
    cases["jax"] = dict(kind="step", mesh=MESH, config=BOTH, batch=_batch(), draws=_jax_draws(rng, (32, 32)),
                        state_dir=state_dir, resave_dir=os.path.join(tmp, "jax_state_resaved"))
    return cases, (jax_states, mesh, _batch(), rng, port_states)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tp_fsdp"))
    cases, jax_inputs = _cases(tmp)
    procs = child.start_world(tmp, cases, WORLD)
    try:  # the one-process references, while the ranks run
        refs = {name: child.run_step(case, draws_key="draws_one" if "draws_one" in case else "draws")
                for name, case in _step_cases().items()}
        refs["jax"] = _run_jax_step(*jax_inputs)
    finally:
        codes = child.wait_world(procs, time.monotonic() + DEADLINE_S)
    return dict(refs=refs, results=child.world_results(tmp, cases, WORLD), codes=codes, tmp=tmp)


def _result(world, name, rank):
    got = world["results"].get((name, rank))
    assert got is not None, f"rank {rank} gave no result for {name} (exit codes {world['codes']})"
    assert not isinstance(got, str), got
    return got


def _ranks_equal(world, name):
    """Every rank's gathered dump bitwise equal to rank 0's; rank 0's."""
    first = _result(world, name, 0)
    for rank in range(1, WORLD):
        assert_ranks_equal(first, _result(world, name, rank))
    return first


def test_ranks_exit_cleanly(world):
    assert world["codes"] == [0] * WORLD


@pytest.mark.parametrize("name", STEP_CASES)
def test_tp_fsdp_step_matches_the_one_process_step(world, name):
    got = _ranks_equal(world, name)
    assert_dump_matches(got, world["refs"][name])
    if name == "frozen-text-encoder":
        for k, p in got["params"]["text_encoder"].items():
            assert torch.equal(p, got["before"]["text_encoder"][k]), k
        assert got["mu"]["text_encoder"] == {}


def test_tp_fsdp_step_matches_jax_on_a_1x2x2_mesh(world):
    assert_dump_matches(_ranks_equal(world, "jax"), world["refs"]["jax"])


@pytest.mark.parametrize("name", CASES)
def test_local_momentum_is_the_part_of_the_gathered_state(world, name):
    """Each rank's codes and scales of a split leaf are its blocks of the
    whole leaf's; the leaves kept whole are those the composed rule names
    (q, k and v of the tiny models' 32-wide attentions, ``conv_out``)."""
    for rank in range(WORLD):
        got = _result(world, name, rank)
        whole = got["whole"]
        assert "conv_out.weight" in whole["unet"]
        assert all(n.endswith(("to_q.weight", "to_k.weight", "to_v.weight")) for n in whole["unet"]
                   if n != "conv_out.weight")
        assert all(n.endswith(("q_proj.weight", "k_proj.weight", "v_proj.weight")) for n in whole["text_encoder"])
        for key in ("unet", "text_encoder"):
            assert all(got["local_slices"][key].values()), (rank, key)
        assert len(got["local_slices"]["unet"]) > 10


@pytest.mark.parametrize(
    "name,sums",
    [
        ("plain", _sums(2, 3, 2, 2)),
        ("grad-accumulation", {k: 2 * v for k, v in _sums(2, 3, 2, 2).items()}),
        ("frozen-text-encoder", _sums(2, 2, 2, 0)),
        ("latent-cache", _sums(2, 3, 2, 2)),
        ("gradient-checkpointing", _sums(4, 3, 2, 2)),
        ("card-exchange", _sums(2, 3, 2, 2)),
    ],
)
def test_tp_sums_per_module(world, name, sums):
    """The step's sums over the model_parallel axis, counted on each rank:
    as under TP alone (FSDP2 adds none)."""
    for rank in range(WORLD):
        assert _result(world, name, rank)["tp_all_reduces"] == sums, (name, rank)


def test_gradient_checkpointing_recomputes_without_gathering_again(world):
    plain, ckpt = _result(world, "plain", 0), _result(world, "gradient-checkpointing", 0)
    assert ckpt["all_gathers"] == plain["all_gathers"] > 0
    assert_dump_matches(_ranks_equal(world, "gradient-checkpointing"), world["refs"]["plain"])


def test_card_exchange_matches_the_gloo_collectives(world):
    """FSDP2's collectives, the TP sums and the dump's gathers through the
    ranks' mapped buffers: the same step, bitwise; no collective through
    the process group's all-gather."""
    shared = _ranks_equal(world, "card-exchange")
    assert_ranks_equal(shared, _result(world, "plain", 0))
    assert shared["all_gathers"] == 0


@pytest.mark.parametrize("name", ["rounded-whole-grads", "rounded-whole-grads-3"])
def test_the_whole_leaves_take_the_first_ranks_shards(world, name):
    """A model_parallel rank 1 (of fsdp rank 0 or 1) whose grads of the
    leaves TP leaves whole are off by a rounding step: after the
    reduce-scatter its shards of them become its axis partner's, so the
    four ranks stay bitwise alike and the step is the plain one, bitwise."""
    assert_ranks_equal(_ranks_equal(world, name), _result(world, "plain", 0))


def test_an_fsdp_axis_without_fsdp_shard_params_is_data_parallel(world):
    """``[1, 2, 2]`` with ``tensor_parallel_shard_params`` alone trains as
    ``[2, 1, 2]`` does: the fsdp ranks hold whole leaves (their TP slices and
    the rest), each its row, the grads summed over them; the step is the
    plain one's within its bounds, and no FSDP2 collective runs."""
    got = _ranks_equal(world, "tp-only")
    assert got["all_gathers"] == 0 and got["tp_all_reduces"] == _sums(2, 3, 2, 2)
    assert all(all(v.values()) and v for v in got["local_slices"].values())
    assert_dump_matches(got, world["refs"]["plain"])


def test_a_restored_state_saves_the_same_bytes(world):
    """The one-process full state restored into the four ranks' shards,
    then saved by them (gathered in two rounds, rank 0 writing), is the
    same files, byte for byte."""
    assert world["codes"] == [0] * WORLD
    src, again = (os.path.join(world["tmp"], d) for d in ("jax_state", "jax_state_resaved"))
    names = sorted(n for n in os.listdir(src) if n != "vae.pt")
    assert names == sorted(os.listdir(again)) and "unet_state.safetensors" in names
    for name in names:
        with open(os.path.join(src, name), "rb") as a, open(os.path.join(again, name), "rb") as b:
            assert a.read() == b.read(), name
