"""One step of the JAX package's multichip layout on eight gloo ranks of the
CPU: a ``(data_parallel, fsdp, model_parallel) = (2, 2, 2)`` mesh with
``fsdp_shard_params`` and ``tensor_parallel_shard_params``, as
``__graft_entry__.dryrun_multichip(8)`` trains the JAX package.

One eight-rank world (``tests/torch_dist_child.py``) takes one step of the
tiny models on a global batch of 4 (one row for each data x fsdp rank, the
model_parallel pair of a row the same row), from JAX's initial state
restored into the ranks' shards, with the JAX step's draws injected. The
parent takes the JAX ``train_step`` on the same mesh of conftest's eight
virtual CPU devices (HSDP over data x fsdp under TP:
``train_state_tp_sharding(fsdp_rest=True)``). Checks: all eight gathered
dumps bitwise equal (the two data replicas run the same update on the
summed grads), rank 0's against the JAX step within
``tests/test_torch_port_train_step.py``'s bounds, and every split leaf's
local momentum its part of the gathered one.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
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
from test_torch_port_distributed import _run_jax_step, assert_dump_matches, assert_ranks_equal
from test_torch_port_train_step import CONCAT, RES, _config, _load_jax_state
from torch_threads import _one_thread  # noqa: F401 (the fixture)

WORLD = 8
MESH = (2, 2, 2)
BATCH = 4
DEADLINE_S = 300


def _batch():
    rng = np.random.default_rng(4)
    return {
        "pixel_values": rng.uniform(-1.0, 1.0, (BATCH, 3, RES, RES)).astype(np.float32),
        "input_ids": rng.integers(0, 1000, (BATCH * CONCAT, 77)).astype(np.int32),
    }


def _jax_draws(rng, h, w):
    """The JAX step's draws at a batch of 4 (its split tree, as
    ``test_torch_port_train_step._jax_draws`` makes them at 2)."""
    _, sample_rng, _ = jax.random.split(rng, num=3)
    eps = jax.random.normal(sample_rng, (BATCH, h, w, 4), dtype=jnp.float32)
    offset_rng, noise_rng, perturb_rng, t_rng = jax.random.split(key=sample_rng, num=4)
    draws = {
        "latent_eps": np.asarray(eps).transpose(0, 3, 1, 2),
        "noise": np.asarray(jax.random.normal(noise_rng, (BATCH, 4, h, w))),
        "noise_offset": np.asarray(jax.random.normal(offset_rng, (BATCH, 4, 1, 1))),
        "perturb_noise": np.asarray(jax.random.normal(perturb_rng, (BATCH, 4, h, w))),
        "timesteps": np.asarray(jax.random.randint(t_rng, (BATCH,), 0, 1000)),
    }
    return {k: torch.tensor(v) for k, v in draws.items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tp_fsdp_dryrun"))
    flags = dict(fsdp_shard_params=True, tensor_parallel_shard_params=True)
    mesh = jax_create_mesh(shape=MESH, axis_names=("data_parallel", "fsdp", "model_parallel"),
                           devices=jax.devices()[:WORLD])
    jax_states = jax_training_state(_config(JaxTrainingConfig, "v-zero-snr", batch_size=BATCH, **flags),
                                    mesh=mesh)
    port_states = on_device_model_training_state(_config(TrainingConfig, "v-zero-snr"), device="cpu")
    _load_jax_state(port_states, jax_states)
    state_dir = os.path.join(tmp, "jax_state")
    save_train_state(state_dir, *port_states[:4], torch.Generator())
    torch.save(port_states[4].call.state_dict(), os.path.join(state_dir, "vae.pt"))
    rng = jax.random.PRNGKey(7)
    batch = _batch()
    cases = {"dryrun": dict(kind="step", mesh=MESH, batch=batch, draws=_jax_draws(rng, RES // 2, RES // 2),
                            state_dir=state_dir, config=dict(batch_size=BATCH, mesh_shape=list(MESH), **flags))}
    procs = child.start_world(tmp, cases, WORLD)
    try:
        ref = _run_jax_step(jax_states, mesh, batch, rng, port_states)
    finally:
        codes = child.wait_world(procs, time.monotonic() + DEADLINE_S)
    return dict(ref=ref, results=child.world_results(tmp, cases, WORLD), codes=codes)


def test_ranks_exit_cleanly(world):
    assert world["codes"] == [0] * WORLD


def test_2x2x2_step_matches_jax_on_the_same_mesh(world):
    got = [world["results"].get(("dryrun", r)) for r in range(WORLD)]
    for r, dump in enumerate(got):
        assert dump is not None and not isinstance(dump, str), (r, dump)
    for dump in got[1:]:
        assert_ranks_equal(got[0], dump)
    assert_dump_matches(got[0], world["ref"])
    for dump in got:
        assert all(all(v.values()) and v for v in dump["local_slices"].values())
