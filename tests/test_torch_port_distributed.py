"""Data-parallel training across processes on the CPU: two gloo ranks.

The module starts one two-rank world (``spawn``; each rank is
``tests/torch_dist_child.py``, torch and the port only, one thread, a
120 s group timeout) and runs every case in it, in order; the parent
computes the references meanwhile and waits with a deadline, killing the
ranks on expiry. Each test asserts one case's results.

- ``core.distributed``'s batch slicing against the JAX functions (their
  ``jax.process_index`` / ``process_count`` patched to the rank's), the
  config's mesh checks, the meshes, and the collectives' buckets (sums,
  16-byte aligned views; rank 0's values replicated).
- The two-rank step against the one-process step on the same global batch
  and draws: plain, ``grad_accumulation_steps=2``, a frozen text encoder,
  the latent cache. With accumulation each rank splits its own rows: over
  a global batch of 4, micro-batch ``j`` holds rows ``j`` (rank 0) and
  ``2 + j`` (rank 1), the one-process step's holds rows ``2j`` and
  ``2j + 1``; the draws are made per row and injected so that every row
  gets its own draws on both sides.
- The two-rank step against the JAX ``train_step`` on a ``(2, 1)`` mesh of
  two of conftest's virtual CPU devices (states replicated and the batch
  sharded on ``data_parallel``, as ``tests/test_parallel.py`` places them),
  JAX's draws injected.
- ``trainer.main`` on two ranks, from an in-memory loader of each rank's
  rows and from the streaming loader over a local chunk: one writer of
  every file, rank 0 alone fetching and deleting the chunks, each rank fed
  its half of each batch, and the result against a one-process
  ``trainer.main`` over the same global batches. Then the two-rank
  checkpoint resumed by one process.

Tolerances, and why: every comparison of the two ranks with each other is
bitwise (they run the same update on the same summed grads). Against the
one-process step and the JAX step the bounds are those of
``tests/test_torch_port_train_step.py`` (its module docstring): loss 1e-5
relative, params and EMA 2 * lr + 1e-6, at most 1e-3 of the update signs
flipped, codes at most one apart above |code| 10 (at most 1e-4 of all
codes further), scales 1e-2 relative. The split batch sums the same rows'
grads in another order (two partial means, then a sum), which is all that
moves a sign or a code. Over n trainer steps the params' bound is n times
the step's flip (2 * lr each) + 1e-6.
"""

import multiprocessing
import os
import shutil
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import torch_dist_child as child
from stable_diffusion_training_tpu.core import distributed as jax_distributed
from stable_diffusion_training_tpu.core.mesh import create_mesh as jax_create_mesh
from stable_diffusion_training_tpu.train import (
    TrainingConfig as JaxTrainingConfig,
    on_device_model_training_state as jax_training_state,
    train_step as jax_train_step,
)
from stable_diffusion_training_tpu_torch.core import distributed as cd
from stable_diffusion_training_tpu_torch.data import InMemoryDataLoader, synthetic_batch
from stable_diffusion_training_tpu_torch.data import dataloader as port_dl
from stable_diffusion_training_tpu_torch.models.hf_io import jax_params_to_state_dict, lion_momentum_from_jax
from stable_diffusion_training_tpu_torch.models.hf_io import load_safetensors
from stable_diffusion_training_tpu_torch.train import TrainingConfig, on_device_model_training_state
from stable_diffusion_training_tpu_torch.train import save_train_state, trainer
from stable_diffusion_training_tpu_torch.train.train_step import make_draws
from stable_diffusion_training_tpu_torch.utils.json_io import read_json_file
from test_torch_port_train_step import LR, PARAM_ATOL, STEP_OPTIONS, _batch, _config, _jax_draws, _load_jax_state
from test_torch_port_trainer import _local_chunk, _rows, _weights, make_config_dict
from torch_threads import _one_thread  # noqa: F401 (the fixture)

WORLD = 2
DEADLINE_S = 420  # the world takes ~1 min alone; its collectives time out at 120 s
STEP_CASES = ("plain", "grad-accumulation", "frozen-text-encoder", "latent-cache")
CONFIG_CASES = {
    "default": ({}, "ok"),
    "data-axis": (dict(mesh_shape=[2, 1]), "ok"),
    "data-axis-named": (dict(mesh_shape=[2, 1, 1], mesh_axis_names=["data_parallel", "fsdp", "model_parallel"]), "ok"),
    "tensor-axis": (dict(mesh_shape=[1, 2]), "ok"),
    "fsdp-axis": (dict(mesh_shape=[1, 2, 1], mesh_axis_names=["data_parallel", "fsdp", "model_parallel"]), "ok"),
    "fsdp-params": (dict(fsdp_shard_params=True), "ok"),
    "tensor-parallel-params": (dict(tensor_parallel_shard_params=True), "ok"),
    "tensor-parallel-with-fsdp": (dict(mesh_shape=[1, 2, 2], tensor_parallel_shard_params=True), "ValueError"),
    "mesh-not-the-world": (dict(mesh_shape=[4, 1]), "ValueError"),
    "batch-not-split": (dict(batch_size=3), "ValueError"),
    "micro-batch-not-split": (dict(batch_size=2, grad_accumulation_steps=2), "ValueError"),
}
TRAINER_STEPS = 2


def _row_draws(n, latent_hw, seed):
    """Seeded draws for ``n`` rows, one dict per row."""
    g = torch.Generator().manual_seed(seed)
    d = make_draws(g, (n, 4) + latent_hw, torch.float32, 1000, "cpu")
    return [{k: v[i : i + 1] for k, v in d.items()} for i in range(n)]


def _stack(rows):
    return {k: torch.cat([r[k] for r in rows]) for k in rows[0]}


def _step_cases():
    batch = _batch()  # 2 rows at 64x64, 3 windows each
    rows = _row_draws(4, (32, 32), seed=5)  # the tiny VAE downsamples once
    plain = dict(kind="step", config={}, batch=batch, draws=_stack(rows[:2]))
    rng = np.random.default_rng(3)
    accum_batch = {
        "pixel_values": rng.uniform(-1, 1, (4, 3, 64, 64)).astype(np.float32),
        "input_ids": rng.integers(0, 1000, (4 * 3, 77)).astype(np.int32),
    }
    latent = {"latent_moments": rng.standard_normal((2, 8, 32, 32)).astype(np.float32),
              "input_ids": batch["input_ids"]}
    return {
        "plain": plain,
        "grad-accumulation": dict(
            kind="step", config=dict(batch_size=4, grad_accumulation_steps=2), batch=accum_batch,
            # micro j: global rows j and 2 + j on two ranks, 2j and 2j + 1 in one process
            draws=[_stack([rows[j], rows[2 + j]]) for j in range(2)],
            draws_one=[_stack([rows[2 * j], rows[2 * j + 1]]) for j in range(2)],
        ),
        "frozen-text-encoder": dict(plain, config=dict(train_text_encoder=False)),
        "latent-cache": dict(plain, config=dict(use_latent_cache=True), batch=latent),
    }


def _jax_case(tmp):
    """The JAX step on a (2, 1) mesh, and its starting state in the port's
    full-state layout for the ranks."""
    devices = jax.devices()[:2]
    mesh = jax_create_mesh(shape=(2, 1), axis_names=("data_parallel", "model_parallel"), devices=devices)
    jax_states = jax_training_state(_config(JaxTrainingConfig, "v-zero-snr"), mesh=mesh)
    port_states = on_device_model_training_state(_config(TrainingConfig, "v-zero-snr"), device="cpu")
    _load_jax_state(port_states, jax_states)
    state_dir = os.path.join(tmp, "jax_state")
    save_train_state(state_dir, *port_states[:4], torch.Generator())
    torch.save(port_states[4].call.state_dict(), os.path.join(state_dir, "vae.pt"))
    batch = _batch()
    rng = jax.random.PRNGKey(7)
    case = dict(kind="step", config={}, batch=batch, draws=_jax_draws(rng, (32, 32)), state_dir=state_dir)
    return case, (jax_states, mesh, batch, rng, port_states)


def _run_jax_step(jax_states, mesh, batch, rng, port_states):
    import importlib

    from stable_diffusion_training_tpu.optim.lion8bit import set_lion_fsdp_mesh, set_lion_tp_mesh

    # the module: ops/__init__ exports an ``attention`` function under its name
    attn = importlib.import_module("stable_diffusion_training_tpu.ops.attention")
    try:
        sharded = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, PartitionSpec("data_parallel")))
                   for k, v in batch.items()}
        step = jax.jit(jax_train_step, static_argnames=("strip_bos_eos_token", "ema_rate") + STEP_OPTIONS)
        j_out = step(*jax_states[:4], sharded, rng, jax_states[4], jax_states[5], strip_bos_eos_token=True,
                     ema_rate=0.999, offset_noise_magnitude=0.0, min_snr_gamma_magnitude=0.0,
                     perturbation_noise_magnitude=0.0)
        numpy = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
        dump = {"loss": float(j_out[4]["loss"]), "params": {}, "ema": {}, "mu": {}}
        for key, idx in (("unet", 0), ("text_encoder", 1)):
            dump["params"][key] = jax_params_to_state_dict(numpy(j_out[idx].params))
            dump["ema"][key] = jax_params_to_state_dict(numpy(j_out[idx + 2]))
            mu = lion_momentum_from_jax(numpy(j_out[idx].opt_state[1][0].mu_quant), port_states[idx].model, "cpu")
            dump["mu"][key] = {n: (m.codes, m.scales) if hasattr(m, "codes") else m for n, m in mu.items()}
        return dump
    finally:  # process-wide registrations of the JAX package: none may leak
        attn.set_attention_mesh(None)
        set_lion_fsdp_mesh(None)
        set_lion_tp_mesh(None)


def _trainer_configs(tmp):
    """Config files of the two-rank runs and of their one-process
    references (each its own directories and ramdisk), and the chunk."""
    eval_kw = dict(eval_sample_interval=2, eval_sample_prompt_ids=[list(range(1, 78))],
                   eval_num_inference_steps=2, eval_sample_resolution=32)
    out = {}
    for tag in ("ddp_mem", "one_mem", "ddp_stream", "one_stream"):
        kw = dict(chunk_limit=1, ramdisk_path=str(tmp / f"ramdisk_{tag}"))
        if tag.endswith("mem"):
            kw.update(eval_kw, eval_sample_dir=str(tmp / f"eval_{tag}"), tensorboard_dir=str(tmp / f"tb_{tag}"),
                      profile_trace_dir=str(tmp / f"trace_{tag}"))
        else:
            kw.update(repo={"repo_0": {}}, numb_of_dataloader_worker_thread=1)
        out[tag] = make_config_dict(tmp, tag, **kw)
    _local_chunk(out["ddp_stream"][0]["ramdisk_path"])
    for tag in ("one_stream", "plan"):
        shutil.copytree(out["ddp_stream"][0]["ramdisk_path"], str(tmp / f"ramdisk_{tag}"))
    return out


def _memory_batches():
    return [synthetic_batch(2, (64, 64), vocab_size=1000, seed=i) for i in range(TRAINER_STEPS)]


def _plan_pixels(tmp, path):
    """The one-process streaming loader's pixel batches over the chunk."""
    loader = port_dl.DataLoader(
        child.StubTokenizer(), path, str(tmp / "ramdisk_plan"), 2, 2, [64**2], [64],
        numb_of_worker_thread=1, queue_get_timeout=5, chunk_number=0, seed=0, context_concatenation_multiplier=3,
    )
    loader._print_debug = False
    loader.prepare_training_dataframe()
    loader.create_training_dataframe()
    loader.dispatch_worker()
    out = []
    while not isinstance(b := loader.grab_next_batch(), str):
        out.append(b["pixel_values"])
    return out


def _wait(procs, deadline):
    """Join the ranks; a rank that exits non-zero, or the deadline, ends the
    world (the rest are killed). Returns the exit codes."""
    while time.monotonic() < deadline and any(p.is_alive() for p in procs):
        if any(p.exitcode not in (None, 0) for p in procs):
            break
        time.sleep(0.2)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(10)
    return [p.exitcode for p in procs]


@pytest.fixture(scope="module")
def world(tmp_path_factory, _one_thread):
    tmp = tmp_path_factory.mktemp("ddp")
    configs = _trainer_configs(tmp)
    layout_batch = synthetic_batch(4, (8, 8), vocab_size=1000, seed=9)
    cases = {"layout": dict(kind="layout", global_batch=8, batch=layout_batch,
                            configs={k: v[0] for k, v in CONFIG_CASES.items()})}
    cases.update(_step_cases())
    cases["jax"], jax_inputs = _jax_case(str(tmp))
    cases["trainer-memory"] = dict(kind="trainer", loader="memory", batches=_memory_batches(),
                                   config_path=configs["ddp_mem"][1])
    cases["trainer-stream"] = dict(kind="trainer", loader="stream", config_path=configs["ddp_stream"][1])
    torch.save({"cases": cases}, str(tmp / "payload.pt"))

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=child.run_rank, args=(r, WORLD, str(tmp)), daemon=True) for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DEADLINE_S
    try:
        # the references, while the ranks run
        refs = {name: child.run_step(case, draws_key="draws_one" if "draws_one" in case else "draws")
                for name, case in cases.items() if name in STEP_CASES}
        refs["jax"] = _run_jax_step(*jax_inputs)
        trainer.main(configs["one_mem"][1], dataloader=InMemoryDataLoader(_memory_batches()), device="cpu")
        trainer.main(configs["one_stream"][1], tokenizer=child.StubTokenizer(), device="cpu")
        refs["plan_pixels"] = _plan_pixels(tmp, configs["one_stream"][1])
    finally:
        codes = _wait(procs, deadline)
    results = {}
    for name in cases:
        for r in range(WORLD):
            pt, err = tmp / f"{name}_{r}.pt", tmp / f"{name}_{r}.err"
            if pt.exists():
                results[(name, r)] = torch.load(str(pt), weights_only=False)
            elif err.exists():
                results[(name, r)] = err.read_text()
    return SimpleNamespace(tmp=tmp, cases=cases, configs=configs, refs=refs, results=results, exit_codes=codes)


def _result(world, name, rank):
    got = world.results.get((name, rank))
    assert got is not None, f"rank {rank} gave no result for {name} (exit codes {world.exit_codes})"
    assert not isinstance(got, str), got  # a rank's traceback
    return got


def test_ranks_exit_cleanly(world):
    assert world.exit_codes == [0] * WORLD


@pytest.mark.parametrize("rank", range(WORLD))
def test_batch_slicing_matches_jax(world, rank, monkeypatch):
    """``process_local_batch_slice`` and ``slice_batch_for_process`` on each
    rank against the JAX functions with the rank's process index."""
    got = _result(world, "layout", rank)
    assert (got["rank"], got["count"]) == (rank, WORLD)
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    monkeypatch.setattr(jax, "process_count", lambda: WORLD)
    case = world.cases["layout"]
    assert got["local_slice"] == jax_distributed.process_local_batch_slice(case["global_batch"])
    want = jax_distributed.slice_batch_for_process(case["batch"])
    for k, v in want.items():
        assert np.array_equal(got["sliced"][k], v) and np.array_equal(got["sliced_torch"][k].numpy(), v), k
        assert v.shape[0] * WORLD == case["batch"][k].shape[0], k


@pytest.mark.parametrize("name", list(CONFIG_CASES))
def test_config_takes_data_parallel_meshes_only(world, name):
    """In a world of two: ``mesh_shape`` None, ``[2, 1]``, an fsdp axis of
    2 or a model_parallel axis of 2 builds a config, and so do
    ``fsdp_shard_params`` and ``tensor_parallel_shard_params``; a mesh that
    is not the world (fsdp and model_parallel axes of 2 together hold four
    ranks), or a global batch that does not split into the ranks' whole
    micro-batches, raises ``ValueError``; ``NotImplementedError`` names a
    ROADMAP item."""
    outcome = CONFIG_CASES[name][1]
    for rank in range(WORLD):
        got = _result(world, "layout", rank)["configs"][name]
        assert got.split(":")[0] == outcome, got
        if outcome == "NotImplementedError":
            assert "item 7" in got


@pytest.mark.parametrize("rank", range(WORLD))
def test_meshes_and_collective_buckets(world, rank):
    """The default mesh is ``(2, 1)`` data-parallel; the hybrid mesh puts
    hosts major on each axis. ``all_reduce_grads_`` sums every dtype and
    odd size and hands back contiguous views 16 bytes apart; ``replicate_``
    gives every rank rank 0's values."""
    got = _result(world, "layout", rank)
    assert got["mesh"] == (WORLD, rank, 1)
    assert got["hybrid"] == ((2, 1, 1), [0, 1], ("data_parallel", "fsdp", "model_parallel"))
    for name, (values, misaligned, contiguous) in got["reduced"].items():
        assert misaligned == 0 and contiguous, name
        assert set(np.ravel(values).tolist()) == {3.0}, name
    assert all(set(np.ravel(v).tolist()) == {1} for v in got["replicated"])


def test_hybrid_rank_layout_interleaves_hosts_and_local_ranks():
    """Each axis is host-major, local-minor, with ranks numbered host by
    host: two hosts of four ranks on a (dcn 2 x ici 2, ici 2) mesh."""
    layout = cd.hybrid_rank_layout((2, 2), (2, 1))
    assert layout.tolist() == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert cd.hybrid_rank_layout((1, 2, 2), (2, 1, 1)).tolist() == [[[0, 1], [2, 3]], [[4, 5], [6, 7]]]
    assert cd.hybrid_rank_layout((2, 2)).tolist() == [[0, 1], [2, 3]]


def _flat(dump, part):
    return {f"{key}/{k}": v for key, tensors in dump[part].items() for k, v in tensors.items()}


def assert_ranks_equal(a, b):
    assert a["loss"] == b["loss"]
    for part in ("params", "ema"):
        fa, fb = _flat(a, part), _flat(b, part)
        assert fa.keys() == fb.keys()
        for k in fa:
            assert torch.equal(fa[k], fb[k]), (part, k)
    for key in a["mu"]:
        for name, m in a["mu"][key].items():
            other = b["mu"][key][name]
            ms, os_ = (m, other) if isinstance(m, tuple) else ((m,), (other,))
            assert all(torch.equal(x, y) for x, y in zip(ms, os_)), (key, name)


def assert_dump_matches(got, want, noise_code=10):
    """``got`` (a rank's step) against ``want`` (the one-process or JAX
    step) to the module's bounds; ``got["before"]`` holds the start."""
    assert np.isfinite(got["loss"])
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"]), (got["loss"], want["loss"])
    for key in ("unet", "text_encoder"):
        flipped = total = 0
        for name, p in got["params"][key].items():
            expected, start = want["params"][key][name], got["before"][key][name]
            np.testing.assert_allclose(p.numpy(), expected.numpy(), atol=PARAM_ATOL, rtol=0, err_msg=name)
            np.testing.assert_allclose(got["ema"][key][name].numpy(), want["ema"][key][name].numpy(),
                                       atol=PARAM_ATOL, rtol=0, err_msg=name)
            flipped += int((np.abs((p - start).numpy() - (expected - start).numpy()) > LR).sum())
            total += p.numel()
        assert flipped <= 1e-3 * total, (key, flipped, total)
        n_codes = n_far = 0
        assert got["mu"][key].keys() == want["mu"][key].keys()
        for name, m in got["mu"][key].items():
            w = want["mu"][key][name]
            if isinstance(m, tuple):
                codes, j_codes = m[0].int(), w[0].int()
                far = (codes - j_codes).abs() > 1
                assert not (far & (torch.maximum(codes.abs(), j_codes.abs()) > noise_code)).any(), name
                n_codes += codes.numel()
                n_far += int(far.sum())
                np.testing.assert_allclose(m[1].numpy(), w[1].numpy(), rtol=1e-2, err_msg=name)
            else:
                np.testing.assert_allclose(m.numpy(), w.numpy(), atol=1e-6, rtol=1e-4, err_msg=name)
        assert n_far <= 1e-4 * max(n_codes, 1), (key, n_far, n_codes)


@pytest.mark.parametrize("name", STEP_CASES)
def test_two_rank_step_matches_the_one_process_step(world, name):
    a, b = _result(world, name, 0), _result(world, name, 1)
    assert_ranks_equal(a, b)
    assert_dump_matches(a, world.refs[name])
    if name == "frozen-text-encoder":
        for k, p in a["params"]["text_encoder"].items():
            assert torch.equal(p, a["before"]["text_encoder"][k]), k
        assert a["mu"]["text_encoder"] == {}


def test_two_rank_step_matches_jax_on_a_2x1_mesh(world):
    a, b = _result(world, "jax", 0), _result(world, "jax", 1)
    assert_ranks_equal(a, b)
    assert_dump_matches(a, world.refs["jax"])


def _checkpoint_close(dir_a, dir_b, steps):
    atol = steps * 2 * LR + 1e-6
    for model in ("unet", "text_encoder"):
        wa, wb = _weights(f"{dir_a}/{model}"), _weights(f"{dir_b}/{model}")
        assert wa.keys() == wb.keys()
        for k in wa:
            np.testing.assert_allclose(wa[k].numpy(), wb[k].numpy(), atol=atol, rtol=0, err_msg=(model, k))


def _losses_close(rows_a, rows_b):
    la, lb = [float(r[2]) for r in rows_a], [float(r[2]) for r in rows_b]
    assert len(la) == len(lb) and np.isfinite(la).all()
    np.testing.assert_allclose(la, lb, rtol=1e-5, atol=0)


@pytest.mark.parametrize("loader", ["memory", "stream"])
def test_two_rank_trainer(world, loader):
    """One chunk of ``trainer.main`` on two ranks: rank 0 alone writes the
    JSON (the backup, once per chunk, once at the end), the probe and the
    chunk checkpoints, ``loss.csv`` (one header, one row a step), the eval
    PNGs, TensorBoard events and the trace; a host's first rank alone
    fetches and deletes the chunks; the ranks' states are bitwise equal at
    the checkpoint, and within the bounds of a one-process run over the
    same global batches."""
    tag = "mem" if loader == "memory" else "stream"
    cfg, path = world.configs[f"ddp_{tag}"]
    one_cfg, _ = world.configs[f"one_{tag}"]
    r0, r1 = (_result(world, f"trainer-{loader}", r) for r in range(WORLD))
    assert r0["digests"] == r1["digests"] and len(r0["digests"]) == 1
    saves = dict(write_model=4, write_train_state=1, json=3, png=int(loader == "memory"))
    for key, n in saves.items():
        assert (r0["calls"][key], r1["calls"][key]) == (n, 0), (key, r0["calls"], r1["calls"])
    rows = _rows(cfg["loss_csv"])
    assert len(rows) == TRAINER_STEPS
    _losses_close(rows, _rows(one_cfg["loss_csv"]))
    final = read_json_file(path)
    assert (final["chunk_number"], final["chunk_steps"], final["master_seed"]) == (1, 1, 1)
    base = cfg["model_path"].split("@")[0]
    assert os.path.isdir(f"{base}@0/{trainer.TRAIN_STATE_SUBDIR}") and not os.path.exists(cfg["test_save_path"])
    _checkpoint_close(f"{base}@0", one_cfg["model_path"].split("@")[0] + "@0", TRAINER_STEPS)
    if loader == "memory":
        assert len(os.listdir(cfg["tensorboard_dir"])) == 1 and len(os.listdir(cfg["profile_trace_dir"])) == 1
        assert os.listdir(os.path.join(cfg["eval_sample_dir"], "step_00000002")) == ["sample_0.png"]
        return
    # the ramdisk: fetched and deleted by rank 0 only, flushed at the end
    assert r1["calls"]["fetch"] == r1["calls"]["delete"] == 0
    assert r0["calls"]["fetch"] >= 1 and r0["calls"]["delete"] >= 1
    assert not os.path.exists(os.path.join(cfg["ramdisk_path"], "chunk_0"))
    # each rank's pixel rows: its half of the one-process loader's batches
    plan = world.refs["plan_pixels"]
    assert len(plan) == TRAINER_STEPS
    for r, got in enumerate((r0, r1)):
        per = plan[0].shape[0] // WORLD
        assert got["pixel_digests"] == [child._digest(b[r * per : (r + 1) * per]) for b in plan], r


def test_two_rank_checkpoint_resumes_in_one_process(world, monkeypatch):
    """The two-rank run's chunk checkpoint (written by rank 0) is the
    ``model_path`` of a one-process ``trainer.main``: its ``train_state/``
    restores bit for bit, and the resumed chunk stays within the bounds of
    the one-process run resumed the same way."""
    restored = []
    restore = trainer.restore_train_state

    def recording_restore(directory, template):
        out = restore(directory, template)
        # read back before the run's rotation deletes the directory
        saved = load_safetensors(os.path.join(directory, "unet_state.safetensors"))
        state = out["unet_state"]
        codes = {n: m.codes for n, m in state.opt_state[1][0].mu_quant.items() if hasattr(m, "codes")}
        restored.append(bool(codes) and all(
            torch.equal(v, saved[f"unet_state/params/{k}"]) for k, v in state.params.items()
        ) and all(torch.equal(c, saved[f"unet_state/opt_state/1/0/mu_quant/{n}/codes"]) for n, c in codes.items()))
        return out

    monkeypatch.setattr(trainer, "restore_train_state", recording_restore)
    for tag in ("ddp_mem", "one_mem"):
        trainer.main(world.configs[tag][1], dataloader=InMemoryDataLoader(_memory_batches()), device="cpu")
    assert restored == [True, True]
    ddp, one = world.configs["ddp_mem"][0], world.configs["one_mem"][0]
    _losses_close(_rows(ddp["loss_csv"]), _rows(one["loss_csv"]))
    _checkpoint_close(ddp["model_path"].split("@")[0] + "@1", one["model_path"].split("@")[0] + "@1", 2 * TRAINER_STEPS)


@pytest.mark.parametrize("env", [dict(WORLD_SIZE="2", RANK="0", LOCAL_RANK="0"), dict(WORLD_SIZE="2", RANK="1")],
                         ids=["torchrun-env", "no-local-rank"])
def test_a_rank_without_a_card_raises(env, monkeypatch):
    """No CPU fallback: under torchrun's environment a rank that finds no
    card raises before it joins a group, and the rank's device does too."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cd.initialize_distributed()
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cd.rank_device(local_rank=0)


def test_a_local_rank_past_the_cards_raises(monkeypatch):
    """One process per card: a ``LOCAL_RANK`` with no card of its own
    raises; it never wraps around to a card another rank has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert cd.rank_device(local_rank=0) == torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="LOCAL_RANK=1 but this host has 1"):
        cd.rank_device(local_rank=1)


def test_one_process_is_a_no_op(monkeypatch):
    """Without torchrun's environment, or with ``world_size=1``, there is
    no group to join: the helpers answer for one process."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert cd.initialize_distributed() is None and cd.initialize_distributed(world_size=1) is None
    assert (cd.process_index(), cd.process_count(), cd.agree_min(5)) == (0, 1, 5)
    batch = {"x": np.arange(4)}
    assert cd.slice_batch_for_process(batch) is batch and cd.process_local_batch_slice(4) == slice(0, 4)
    assert cd.run_on(True, lambda: 7) == 7
    with pytest.raises(KeyError):
        cd.run_on(True, {}.__getitem__, "missing")
