"""``trainer.main`` on two tensor-parallel ranks of the CPU against one
process, checkpoints moved between the two either way, and one step on a
four-rank data x tensor-parallel mesh.

The parent first runs one chunk of ``trainer.main`` in one process (``one``:
2 steps of a global batch of 2 from an in-memory loader, DDIM eval at step
2). Then one two-rank world (``tests/torch_dist_child.py``, mesh ``[1, 1,
2]`` with ``tensor_parallel_shard_params``; each rank fed the whole batch,
the model_parallel ranks of a row block taking the same rows) runs:

- ``tp``: the same chunk, eval included (every rank samples through the
  split modules, rank 0 writes);
- ``tp_from_one``: the second chunk, resumed from a copy of the one-process
  chunk checkpoint (its ``train_state/`` read whole, each rank keeping its
  slices);
- ``tp_stream``: a chunk from the streaming loader (``dataloader=None``)
  over a local chunk directory, every rank reading the whole batches, against
  one process's run over a copy of the chunk.

Meanwhile the parent resumes the one-process run for its second chunk, and
afterwards resumes a copy of the TP chunk checkpoint in one process
(``one_from_tp``). Checks: the TP run's loss rows, checkpoint and eval
images against the one-process run's; every resume restoring the saved
params and codes bit for bit (gathered whole on the ranks), and its rows and
checkpoint against the one-process resume; the TP run's rank 0 alone
writing; its checkpoint files the same as the one-process run's in names,
keys, shapes and dtypes, and its ``unet/`` read by the JAX package's
``hf_io``.

Last, a four-rank world on a ``(2, 1, 2)`` mesh (two data-parallel pairs of
tensor-parallel ranks) takes one step of ``tests/test_torch_port_distributed``'s
plain case, one row a pair: all four gathered dumps bitwise equal, and
rank 0's against the one-process step.

Tolerances: loss rows 1e-5 relative and params n * 2 lr + 1e-6 over n
steps (``tests/test_torch_port_distributed.py``); eval images 1e-5 absolute
(pixels in [0, 1]; the same weights within 2 lr give the same images to f32
rounding through 2 DDIM steps of the tiny models); the step those of
``tests/test_torch_port_train_step.py``.
"""

import os
import shutil
import time

import jax
import numpy as np
import pytest
import torch

import torch_dist_child as child
from stable_diffusion_training_tpu.models import hf_io as jax_hf_io
from stable_diffusion_training_tpu_torch.models.hf_io import jax_params_to_state_dict, load_safetensors
from stable_diffusion_training_tpu_torch.train import trainer
from test_torch_port_distributed import (
    TRAINER_STEPS,
    _checkpoint_close,
    _losses_close,
    _memory_batches,
    _step_cases,
    assert_dump_matches,
    assert_ranks_equal,
)
from test_torch_port_fsdp_trainer import EVAL, _one_process, _resume_config
from test_torch_port_trainer import _local_chunk, _rows, _weights, make_config_dict
from torch_threads import _one_thread  # noqa: F401 (the fixture)

WORLD = 2
MESH = (1, 1, WORLD)
TP = dict(mesh_shape=list(MESH), tensor_parallel_shard_params=True)
DP_TP_MESH = (2, 1, 2)
DEADLINE_S = 300


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_trainer")
    one_cfg, one_path = make_config_dict(tmp, "one", chunk_limit=1, keep_trained_model_buffer=5,
                                         eval_sample_dir=str(tmp / "eval_one"), **EVAL)
    one_images = []
    _one_process(one_path, one_images)
    tp_cfg, tp_path = make_config_dict(tmp, "tp", chunk_limit=1, keep_trained_model_buffer=5,
                                       eval_sample_dir=str(tmp / "eval_tp"), **EVAL, **TP)
    _, from_one_path = _resume_config(tmp, "one", "tp_from_one", **TP)
    cases = {name: dict(kind="trainer", loader="memory", batches=_memory_batches(), config_path=path, mesh=MESH)
             for name, path in (("tp", tp_path), ("tp_from_one", from_one_path))}
    stream = dict(chunk_limit=1, repo={"repo_0": {}}, numb_of_dataloader_worker_thread=1)
    _, stream_path = make_config_dict(tmp, "tp_stream", ramdisk_path=str(tmp / "ramdisk_tp"), **stream, **TP)
    _, one_stream_path = make_config_dict(tmp, "one_stream", ramdisk_path=str(tmp / "ramdisk_one"), **stream)
    _local_chunk(str(tmp / "ramdisk_tp"))
    shutil.copytree(str(tmp / "ramdisk_tp"), str(tmp / "ramdisk_one"))
    cases["tp_stream"] = dict(kind="trainer", loader="stream", config_path=stream_path, mesh=MESH)
    procs = child.start_world(str(tmp), cases, WORLD)
    try:
        one_resumed = _one_process(one_path)  # the one-process run's second chunk
        trainer.main(one_stream_path, tokenizer=child.StubTokenizer(), device="cpu")
    finally:
        codes = child.wait_world(procs, time.monotonic() + DEADLINE_S)
    results = child.world_results(str(tmp), cases, WORLD)
    _, from_tp_path = _resume_config(tmp, "tp", "one_from_tp")
    from_tp_resumed = _one_process(from_tp_path)
    return dict(tmp=tmp, codes=codes, results=results, one=one_cfg, tp=tp_cfg, one_images=one_images,
                one_resumed=one_resumed, from_tp_resumed=from_tp_resumed)


@pytest.fixture(scope="module")
def dp_tp_world(tmp_path_factory):
    """One step on four ranks of a (2, 1, 2) mesh, and its one-process
    reference."""
    tmp = str(tmp_path_factory.mktemp("dp_tp"))
    plain = _step_cases()["plain"]
    cases = {"dp_tp": dict(plain, mesh=DP_TP_MESH, config=dict(mesh_shape=list(DP_TP_MESH),
                                                                tensor_parallel_shard_params=True))}
    procs = child.start_world(tmp, cases, 4)
    try:
        ref = child.run_step(plain)
    finally:
        codes = child.wait_world(procs, time.monotonic() + DEADLINE_S)
    return dict(ref=ref, results=child.world_results(tmp, cases, 4), codes=codes)


def _result(world, name, rank):
    got = world["results"].get((name, rank))
    assert got is not None, f"rank {rank} gave no result for {name} (exit codes {world['codes']})"
    assert not isinstance(got, str), got
    return got


def _run_dir(tmp, tag, chunk):
    return f"{tmp}/{tag}/run@{chunk}"


def test_ranks_exit_cleanly(world):
    assert world["codes"] == [0] * WORLD


def test_tp_trainer_matches_one_process(world):
    """Loss rows and the chunk checkpoint against the one-process run's;
    rank 0 alone writes the checkpoints, the JSON and the eval PNGs."""
    tmp = world["tmp"]
    r0, r1 = (_result(world, "tp", r) for r in range(WORLD))
    for key, n in dict(write_model=4, write_train_state=1, json=3, png=1).items():
        assert (r0["calls"][key], r1["calls"][key]) == (n, 0), (key, r0["calls"], r1["calls"])
    assert len(_rows(world["tp"]["loss_csv"])) == TRAINER_STEPS
    _losses_close(_rows(world["tp"]["loss_csv"]), _rows(world["one"]["loss_csv"])[:TRAINER_STEPS])
    _checkpoint_close(_run_dir(tmp, "tp", 0), _run_dir(tmp, "one", 0), TRAINER_STEPS)
    assert os.listdir(os.path.join(world["tp"]["eval_sample_dir"], "step_00000002")) == ["sample_0.png"]


def test_tp_eval_images_match_one_process(world):
    """Every rank samples (the split modules sum over the axis), with the
    same images; rank 0's against the one-process run's."""
    got, want = _result(world, "tp", 0)["images"], world["one_images"]
    assert _result(world, "tp", 1)["images"] == []  # rank 1 samples, rank 0 alone saves
    assert len(got) == len(want) == 1
    assert got[0].shape == want[0].shape == (1, 32, 32, 3)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)


def test_tp_checkpoint_has_the_one_process_layout(world):
    """The same files, tensor names, shapes and dtypes as the one-process
    chunk checkpoint's."""
    tmp = world["tmp"]
    for sub in ("unet", "text_encoder", "vae", trainer.TRAIN_STATE_SUBDIR):
        a, b = _run_dir(tmp, "tp", 0) + f"/{sub}", _run_dir(tmp, "one", 0) + f"/{sub}"
        assert sorted(os.listdir(a)) == sorted(os.listdir(b)), sub
        for name in os.listdir(a):
            if name.endswith(".safetensors"):
                ta, tb = load_safetensors(os.path.join(a, name)), load_safetensors(os.path.join(b, name))
                assert {k: (v.shape, v.dtype) for k, v in ta.items()} == {k: (v.shape, v.dtype) for k, v in tb.items()}


def test_tp_unet_loads_in_the_jax_package(world):
    ckpt = _run_dir(world["tmp"], "tp", 0)
    got = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, jax_hf_io.load_unet_params(f"{ckpt}/unet")))
    want = _weights(f"{ckpt}/unet")
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_tp_trainer_streams_the_whole_batches(world):
    """From the streaming loader every TP rank reads the same whole
    batches (its row block of one), and the run matches one process's."""
    tmp = world["tmp"]
    r0, r1 = (_result(world, "tp_stream", r) for r in range(WORLD))
    assert r0["pixel_digests"] == r1["pixel_digests"] and len(r0["pixel_digests"]) == TRAINER_STEPS
    rows, one_rows = _rows(str(tmp / "loss_tp_stream.csv")), _rows(str(tmp / "loss_one_stream.csv"))
    assert len(rows) == len(one_rows) == TRAINER_STEPS
    _losses_close(rows, one_rows)
    _checkpoint_close(_run_dir(tmp, "tp_stream", 0), _run_dir(tmp, "one_stream", 0), TRAINER_STEPS)


@pytest.mark.parametrize("tag", ["tp_from_one", "one_from_tp"])
def test_checkpoints_resume_across_worlds(world, tag):
    """A one-process checkpoint resumed on two TP ranks, and a TP checkpoint
    resumed in one process: the saved state restored bit for bit, then rows
    and checkpoint within the bounds of the one-process resume."""
    tmp = world["tmp"]
    if tag == "tp_from_one":
        restored = [_result(world, tag, r)["restored"] for r in range(WORLD)]
        assert restored == [[True]] * WORLD
    else:
        assert world["from_tp_resumed"] == [True]
    assert world["one_resumed"] == [True]
    rows = _rows(str(tmp / f"loss_{tag}.csv"))
    one_rows = _rows(world["one"]["loss_csv"])[TRAINER_STEPS:]
    assert len(rows) == TRAINER_STEPS and len(one_rows) == TRAINER_STEPS
    _losses_close(rows, one_rows)
    _checkpoint_close(_run_dir(tmp, tag, 1), _run_dir(tmp, "one", 1), 2 * TRAINER_STEPS)


def test_dp_tp_step_matches_the_one_process_step(dp_tp_world):
    """Four ranks, two data-parallel pairs of TP ranks: every gathered dump
    bitwise equal (the pairs run the same update on the summed grads), rank
    0's within the step's bounds of the one-process step, every split leaf's
    local momentum its slice."""
    assert dp_tp_world["codes"] == [0] * 4
    got = [dp_tp_world["results"].get(("dp_tp", r)) for r in range(4)]
    for r, dump in enumerate(got):
        assert dump is not None and not isinstance(dump, str), (r, dump)
    for dump in got[1:]:
        assert_ranks_equal(got[0], dump)
    assert_dump_matches(got[0], dp_tp_world["ref"])
    for dump in got:
        assert all(all(v.values()) and v for v in dump["local_slices"].values())
