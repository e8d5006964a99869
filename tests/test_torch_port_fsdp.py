"""FSDP training on two gloo ranks of the CPU: the sharded step against the
one-process step and against the JAX step on a ``(1, 2, 1)`` mesh.

One two-rank world (``tests/torch_dist_child.py``) runs every case on a
``(data_parallel, fsdp, model_parallel) = (1, 2, 1)`` mesh with
``fsdp_shard_params``: the UNet and the text encoder sharded with FSDP2
(each down, mid and up block and each CLIP layer a unit), the Lion state
and EMA on the local shards, the grads from ``loss.backward()`` summed by
the reduce-scatter. Each rank takes its row of a global batch of 2 (4 with
accumulation). A rank's dump holds whole tensors, gathered from the shards,
so the ranks' dumps are compared bitwise with each other, then:

- against the one-process step on the same global batch and draws: plain,
  ``grad_accumulation_steps=2``, a frozen text encoder, the latent cache,
  gradient checkpointing (whose recompute must not all-gather a block
  again: the step's all-gathers are counted with and without it), and the
  plain step with FSDP2's collectives and the state's gathers on the route
  that gloo ranks of one card take (``_CardExchange``: copies between the
  ranks' mapped buffers, here CPU shared memory);
- against the JAX ``train_step`` on a ``(1, 2, 1)`` mesh of two of
  conftest's virtual CPU devices with ``fsdp_shard_params=True`` (the JAX
  package shards the largest divisible dim of each leaf and runs its Pallas
  Lion ``shard_map``'d, in interpret mode), JAX's draws injected, from JAX's
  initial state restored into the ranks' shards.

Each rank's local Lion codes and scales are also its slice of the gathered
ones (the co-sharding rule), and the only UNet leaf whose momentum stays
whole is ``conv_out.weight`` (4 output channels). The one-process state
that the JAX case restores into the ranks' shards, saved again by them, is
the same files byte for byte.

Tolerances: those of ``tests/test_torch_port_train_step.py`` (loss 1e-5
relative, params and EMA 2 lr + 1e-6, at most 1e-3 of the update signs,
codes more than one apart only at |code| <= 10 and for at most 1e-4 of
them, scales 1e-2 relative), via ``test_torch_port_distributed``'s
``assert_dump_matches``: the reduce-scatter sums the rows' grads in another
order, which is all that moves a sign or a code.
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
from test_torch_port_train_step import _batch, _config, _jax_draws, _load_jax_state
from torch_threads import _one_thread  # noqa: F401 (the fixture)

WORLD = 2
MESH = (1, WORLD, 1)
FSDP = dict(mesh_shape=list(MESH), fsdp_shard_params=True)
DEADLINE_S = 300
CASES = STEP_CASES + ("gradient-checkpointing", "card-exchange")


def _cases(tmp):
    cases = {}
    for name, case in _step_cases().items():
        cases[name] = dict(case, mesh=MESH, config={**case["config"], **FSDP})
    cases["gradient-checkpointing"] = dict(cases["plain"], config={**FSDP, "gradient_checkpointing": True})
    cases["card-exchange"] = dict(cases["plain"], card_exchange=True)
    devices = jax.devices()[:2]
    mesh = jax_create_mesh(shape=MESH, axis_names=("data_parallel", "fsdp", "model_parallel"), devices=devices)
    jax_states = jax_training_state(_config(JaxTrainingConfig, "v-zero-snr", fsdp_shard_params=True), mesh=mesh)
    port_states = on_device_model_training_state(_config(TrainingConfig, "v-zero-snr"), device="cpu")
    _load_jax_state(port_states, jax_states)
    state_dir = os.path.join(tmp, "jax_state")
    save_train_state(state_dir, *port_states[:4], torch.Generator())
    torch.save(port_states[4].call.state_dict(), os.path.join(state_dir, "vae.pt"))
    rng = jax.random.PRNGKey(7)
    cases["jax"] = dict(kind="step", mesh=MESH, config=FSDP, batch=_batch(), draws=_jax_draws(rng, (32, 32)),
                        state_dir=state_dir, resave_dir=os.path.join(tmp, "jax_state_resaved"))
    return cases, (jax_states, mesh, _batch(), rng, port_states)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("fsdp"))
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


def test_ranks_exit_cleanly(world):
    assert world["codes"] == [0] * WORLD


@pytest.mark.parametrize("name", STEP_CASES)
def test_fsdp_step_matches_the_one_process_step(world, name):
    a, b = _result(world, name, 0), _result(world, name, 1)
    assert_ranks_equal(a, b)
    assert_dump_matches(a, world["refs"][name])
    if name == "frozen-text-encoder":
        for k, p in a["params"]["text_encoder"].items():
            assert torch.equal(p, a["before"]["text_encoder"][k]), k
        assert a["mu"]["text_encoder"] == {}


def test_fsdp_step_matches_jax_on_a_1x2x1_mesh(world):
    a, b = _result(world, "jax", 0), _result(world, "jax", 1)
    assert_ranks_equal(a, b)
    assert_dump_matches(a, world["refs"]["jax"])


@pytest.mark.parametrize("name", CASES)
def test_local_momentum_is_the_slice_of_the_gathered_state(world, name):
    """Each rank's codes and scales are its blocks of the whole leaf's, and
    the UNet leaf the rule keeps whole is ``conv_out.weight`` alone."""
    for rank in range(WORLD):
        got = _result(world, name, rank)
        assert got["whole"]["unet"] == ["conv_out.weight"]
        for key in ("unet", "text_encoder"):
            assert all(got["local_slices"][key].values()), (rank, key)
        assert len(got["local_slices"]["unet"]) > 10


def test_gradient_checkpointing_recomputes_without_gathering_again(world):
    """The recompute runs inside FSDP2's backward unshard: the step's
    all-gathers are as many as without checkpointing, and the step is the
    plain one's (within the bounds)."""
    plain, ckpt = _result(world, "plain", 0), _result(world, "gradient-checkpointing", 0)
    assert ckpt["all_gathers"] == plain["all_gathers"] > 0
    assert_ranks_equal(ckpt, _result(world, "gradient-checkpointing", 1))
    assert_dump_matches(ckpt, world["refs"]["plain"])


def test_a_restored_state_saves_the_same_bytes(world):
    """The one-process full state restored into the two ranks' shards, then
    saved by them (gathered, rank 0 writing), is the same files, byte for
    byte."""
    assert world["codes"] == [0] * WORLD
    src, again = (os.path.join(world["tmp"], d) for d in ("jax_state", "jax_state_resaved"))
    names = sorted(n for n in os.listdir(src) if n != "vae.pt")
    assert names == sorted(os.listdir(again)) and "unet_state.safetensors" in names
    for name in names:
        with open(os.path.join(src, name), "rb") as a, open(os.path.join(again, name), "rb") as b:
            assert a.read() == b.read(), name


def test_card_exchange_matches_the_gloo_collectives(world):
    """FSDP2's all-gathers and reduce-scatters, and the dump's gathers,
    through the ranks' mapped buffers: the same step, bitwise."""
    shared, plain = _result(world, "card-exchange", 0), _result(world, "plain", 0)
    assert_ranks_equal(shared, _result(world, "card-exchange", 1))
    assert_ranks_equal(shared, plain)
    assert shared["all_gathers"] == 0 < plain["all_gathers"]  # none through the process group's all-gather
