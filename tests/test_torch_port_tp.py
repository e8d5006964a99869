"""Tensor parallelism on two gloo ranks of the CPU: the split step against
the one-process step and against the JAX step on a ``(1, 1, 2)`` mesh.

One two-rank world (``tests/torch_dist_child.py``) runs every case on a
``(data_parallel, fsdp, model_parallel) = (1, 1, 2)`` mesh with
``tensor_parallel_shard_params``: the attention projections of the UNet and
the text encoder and CLIP's MLP split Megatron-style over the two ranks
(``parallel.tensor_parallel_``), each rank running attention on its own
heads, the Lion state and EMA on each rank's leaves. Both ranks take the
whole global batch of 2 (4 with accumulation): the model_parallel ranks of
a row block see the same rows and draws. A rank's dump holds whole tensors,
gathered from the slices, so the ranks' dumps are compared bitwise with
each other, then:

- against the one-process step on the same global batch and draws: plain,
  ``grad_accumulation_steps=2``, a frozen text encoder, the latent cache,
  gradient checkpointing, and the plain step with the TP sums and the
  dump's gathers on the route that gloo ranks of one card take
  (``_CardExchange``, here over CPU shared memory);
- with rank 1's grads of the whole leaves off by a rounding step (as a
  card's run-to-run sums may leave them): both ranks take rank 0's, so the
  step is the plain one bitwise; and on a ``[1, 2]`` mesh without
  ``tensor_parallel_shard_params`` (replicas of the whole models) the same;
- against the JAX ``train_step`` on a ``(1, 1, 2)`` mesh of two of
  conftest's virtual CPU devices with ``tensor_parallel_shard_params=True``
  (``params_tp_sharding``'s Megatron specs, the flash path and the Pallas
  Lion ``shard_map``'d, in interpret mode), JAX's draws injected, from
  JAX's initial state restored into the ranks' slices.

Each rank's local Lion codes and scales are its slice of the gathered ones
(every split leaf of the tiny models holds whole blocks: none keeps its
momentum whole), and the step's sums over the axis are counted: per UNet
transformer block 2 forward (``attn1``'s and ``attn2``'s ``to_out``) and 3
backward (``attn1``'s input, ``attn2``'s hidden states and its context), per
CLIP layer 2 and 2; a frozen text encoder takes no backward sum of its own
nor of the context; gradient checkpointing repeats the UNet's forward sums
in its recompute.

Tolerances: those of ``tests/test_torch_port_train_step.py`` (loss 1e-5
relative, params and EMA 2 lr + 1e-6, at most 1e-3 of the update signs,
codes more than one apart only at |code| <= 10 and for at most 1e-4 of
them, scales 1e-2 relative), via ``test_torch_port_distributed``'s
``assert_dump_matches``: the split layers sum their partial products in
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
from stable_diffusion_training_tpu_torch.models import UNet2DConditionModel, configs
from stable_diffusion_training_tpu_torch.models.attention import BasicTransformerBlock
from stable_diffusion_training_tpu_torch.train import TrainingConfig, on_device_model_training_state
from stable_diffusion_training_tpu_torch.train import save_train_state
from test_torch_port_distributed import STEP_CASES, _run_jax_step, _step_cases, assert_dump_matches, assert_ranks_equal
from test_torch_port_train_step import _batch, _config, _jax_draws, _load_jax_state
from torch_threads import _one_thread  # noqa: F401 (the fixture)

WORLD = 2
MESH = (1, 1, WORLD)
TP = dict(mesh_shape=list(MESH), tensor_parallel_shard_params=True)
DEADLINE_S = 300
CASES = STEP_CASES + ("gradient-checkpointing", "card-exchange")


def _cases(tmp):
    """Every case on the TP mesh; both ranks take the whole batch, so an
    accumulation case takes the one-process step's micro-batches and draws."""
    cases = {}
    for name, case in _step_cases().items():
        case = dict(case, mesh=MESH, config={**case["config"], **TP})
        if "draws_one" in case:
            case["draws"] = case.pop("draws_one")
        cases[name] = case
    cases["gradient-checkpointing"] = dict(cases["plain"], config={**TP, "gradient_checkpointing": True})
    cases["card-exchange"] = dict(cases["plain"], card_exchange=True)
    # rank 1's grads of the whole leaves off by a rounding step
    cases["rounded-whole-grads"] = dict(cases["plain"], rounding_rank=1)
    cases["replicas"] = dict(cases["plain"], mesh=(1, WORLD), config={"mesh_shape": [1, WORLD]}, rounding_rank=1)
    devices = jax.devices()[:2]
    mesh = jax_create_mesh(shape=MESH, axis_names=("data_parallel", "fsdp", "model_parallel"), devices=devices)
    jax_states = jax_training_state(_config(JaxTrainingConfig, "v-zero-snr", tensor_parallel_shard_params=True),
                                    mesh=mesh)
    port_states = on_device_model_training_state(_config(TrainingConfig, "v-zero-snr"), device="cpu")
    _load_jax_state(port_states, jax_states)
    state_dir = os.path.join(tmp, "jax_state")
    save_train_state(state_dir, *port_states[:4], torch.Generator())
    torch.save(port_states[4].call.state_dict(), os.path.join(state_dir, "vae.pt"))
    rng = jax.random.PRNGKey(7)
    cases["jax"] = dict(kind="step", mesh=MESH, config=TP, batch=_batch(), draws=_jax_draws(rng, (32, 32)),
                        state_dir=state_dir, resave_dir=os.path.join(tmp, "jax_state_resaved"))
    return cases, (jax_states, mesh, _batch(), rng, port_states)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tp"))
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


def _sums(fwd_unet: int, bwd_unet: int, fwd_clip: int, bwd_clip: int) -> dict:
    """The step's TP sums for the tiny models: per transformer block of the
    UNet and per CLIP layer."""
    blocks = sum(isinstance(m, BasicTransformerBlock)
                 for m in UNet2DConditionModel(**configs.TINY_UNET, device="cpu").modules())
    layers = configs.TINY_CLIP["num_hidden_layers"]
    return {"forward": fwd_unet * blocks + fwd_clip * layers, "backward": bwd_unet * blocks + bwd_clip * layers}


def test_ranks_exit_cleanly(world):
    assert world["codes"] == [0] * WORLD


@pytest.mark.parametrize("name", STEP_CASES)
def test_tp_step_matches_the_one_process_step(world, name):
    a, b = _result(world, name, 0), _result(world, name, 1)
    assert_ranks_equal(a, b)
    assert_dump_matches(a, world["refs"][name])
    if name == "frozen-text-encoder":
        for k, p in a["params"]["text_encoder"].items():
            assert torch.equal(p, a["before"]["text_encoder"][k]), k
        assert a["mu"]["text_encoder"] == {}


def test_tp_step_matches_jax_on_a_1x1x2_mesh(world):
    a, b = _result(world, "jax", 0), _result(world, "jax", 1)
    assert_ranks_equal(a, b)
    assert_dump_matches(a, world["refs"]["jax"])


@pytest.mark.parametrize("name", CASES)
def test_local_momentum_is_the_slice_of_the_gathered_state(world, name):
    """Each rank's codes and scales of a split leaf are its blocks of the
    whole leaf's: the UNet's 32 split kernels and, when it trains, the text
    encoder's 12 (q, k, v, out, fc1 and fc2 of each layer; the biases keep
    dense momentum). No split leaf of the tiny models keeps its momentum
    whole."""
    for rank in range(WORLD):
        got = _result(world, name, rank)
        assert got["whole"] == {"unet": [], "text_encoder": []}, rank
        trained = {"unet": 32, "text_encoder": 12 if got["mu"]["text_encoder"] else 0}
        for key, n in trained.items():
            slices = got["local_slices"][key]
            assert len(slices) == n and all(slices.values()), (rank, key)


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
    """The step's sums over the model_parallel axis, counted on each rank."""
    for rank in range(WORLD):
        assert _result(world, name, rank)["tp_all_reduces"] == sums, (name, rank)


def test_gradient_checkpointing_matches_the_plain_step(world):
    ckpt = _result(world, "gradient-checkpointing", 0)
    assert_ranks_equal(ckpt, _result(world, "gradient-checkpointing", 1))
    assert_dump_matches(ckpt, world["refs"]["plain"])


def test_card_exchange_matches_the_gloo_collectives(world):
    """The TP sums and the dump's gathers through the ranks' mapped
    buffers: the same step, bitwise."""
    shared, plain = _result(world, "card-exchange", 0), _result(world, "plain", 0)
    assert_ranks_equal(shared, _result(world, "card-exchange", 1))
    assert_ranks_equal(shared, plain)


def test_the_whole_leaves_take_the_first_ranks_grads(world):
    """Rank 1's grads of the leaves that stay whole, off by a rounding step
    as a card's run-to-run sums may leave them: the step gives both ranks
    rank 0's, so the ranks stay bitwise alike and the step is the plain
    one, bitwise."""
    got = _result(world, "rounded-whole-grads", 0)
    assert_ranks_equal(got, _result(world, "rounded-whole-grads", 1))
    assert_ranks_equal(got, _result(world, "plain", 0))


def test_a_model_parallel_axis_without_splits_holds_replicas(world):
    """``mesh_shape [1, 2]`` without ``tensor_parallel_shard_params``: both
    ranks take the whole batch and the whole models, sum nothing over the
    axis, and take rank 0's grads (rank 1's are off by a rounding step):
    the ranks bitwise alike, the step the one-process one."""
    a, b = _result(world, "replicas", 0), _result(world, "replicas", 1)
    assert_ranks_equal(a, b)
    assert a["tp_all_reduces"] == {"forward": 0, "backward": 0} and a["local_slices"] == {"unet": {}, "text_encoder": {}}
    assert_dump_matches(a, world["refs"]["plain"])


def test_a_restored_state_saves_the_same_bytes(world):
    """The one-process full state restored into the two ranks' slices, then
    saved by them (gathered, rank 0 writing), is the same files, byte for
    byte."""
    assert world["codes"] == [0] * WORLD
    src, again = (os.path.join(world["tmp"], d) for d in ("jax_state", "jax_state_resaved"))
    names = sorted(n for n in os.listdir(src) if n != "vae.pt")
    assert names == sorted(os.listdir(again)) and "unet_state.safetensors" in names
    for name in names:
        with open(os.path.join(src, name), "rb") as a, open(os.path.join(again, name), "rb") as b:
            assert a.read() == b.read(), name
