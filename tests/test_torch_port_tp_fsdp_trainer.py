"""``trainer.main`` on four TP-with-FSDP ranks of the CPU against one process,
and checkpoints moved between the two either way.

The parent first runs one chunk of ``trainer.main`` in one process (``one``:
2 steps of a global batch of 2 from an in-memory loader, DDIM eval at step
2). Then one four-rank world (``tests/torch_dist_child.py``, mesh ``[1, 2,
2]`` with ``tensor_parallel_shard_params`` and ``fsdp_shard_params``; each
fsdp rank fed its row of each batch, the model_parallel ranks of a row the
same row) runs:

- ``tp_fsdp``: the same chunk, eval included (every rank samples through
  the split and sharded modules, rank 0 writes);
- ``tp_fsdp_from_one``: the second chunk, resumed from a copy of the
  one-process chunk checkpoint (its ``train_state/`` read whole, each rank
  keeping its TP slice's fsdp rows).

Meanwhile the parent resumes the one-process run for its second chunk, and
afterwards resumes a copy of the four-rank chunk checkpoint in one process
(``one_from_tp_fsdp``). Checks: the four-rank run's loss rows, checkpoint
and eval image against the one-process run's; every resume restoring the
saved params and codes bit for bit (gathered whole on the ranks), and its
rows and checkpoint against the one-process resume; rank 0 alone writing;
the checkpoint files the same as the one-process run's in names, keys,
shapes and dtypes; the model_parallel pairs' whole leaves checked alike
before the checkpoint (the ranks' state digests at the chunk checkpoint
equal within each pair of fsdp shards).

Tolerances: loss rows 1e-5 relative and params n * 2 lr + 1e-6 over n
steps (``tests/test_torch_port_distributed.py``); eval images 1e-5 absolute
(``tests/test_torch_port_fsdp_trainer.py``).
"""

import os
import time

import numpy as np
import pytest
import torch

import torch_dist_child as child
from stable_diffusion_training_tpu_torch.models.hf_io import load_safetensors
from stable_diffusion_training_tpu_torch.train import trainer
from test_torch_port_distributed import TRAINER_STEPS, _checkpoint_close, _losses_close, _memory_batches
from test_torch_port_fsdp_trainer import EVAL, _one_process, _resume_config
from test_torch_port_trainer import _rows, make_config_dict
from torch_threads import _one_thread  # noqa: F401 (the fixture)

WORLD = 4
MESH = (1, 2, 2)
BOTH = dict(mesh_shape=list(MESH), fsdp_shard_params=True, tensor_parallel_shard_params=True)
DEADLINE_S = 300


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_fsdp_trainer")
    one_cfg, one_path = make_config_dict(tmp, "one", chunk_limit=1, keep_trained_model_buffer=5,
                                         eval_sample_dir=str(tmp / "eval_one"), **EVAL)
    one_images = []
    _one_process(one_path, one_images)
    run_cfg, run_path = make_config_dict(tmp, "tp_fsdp", chunk_limit=1, keep_trained_model_buffer=5,
                                         eval_sample_dir=str(tmp / "eval_tp_fsdp"), **EVAL, **BOTH)
    _, from_one_path = _resume_config(tmp, "one", "tp_fsdp_from_one", **BOTH)
    cases = {name: dict(kind="trainer", loader="memory", batches=_memory_batches(), config_path=path, mesh=MESH)
             for name, path in (("tp_fsdp", run_path), ("tp_fsdp_from_one", from_one_path))}
    procs = child.start_world(str(tmp), cases, WORLD)
    try:
        one_resumed = _one_process(one_path)  # the one-process run's second chunk
    finally:
        codes = child.wait_world(procs, time.monotonic() + DEADLINE_S)
    results = child.world_results(str(tmp), cases, WORLD)
    _, from_run_path = _resume_config(tmp, "tp_fsdp", "one_from_tp_fsdp")
    from_run_resumed = _one_process(from_run_path)
    return dict(tmp=tmp, codes=codes, results=results, one=one_cfg, run=run_cfg, one_images=one_images,
                one_resumed=one_resumed, from_run_resumed=from_run_resumed)


def _result(world, name, rank):
    got = world["results"].get((name, rank))
    assert got is not None, f"rank {rank} gave no result for {name} (exit codes {world['codes']})"
    assert not isinstance(got, str), got
    return got


def _run_dir(tmp, tag, chunk):
    return f"{tmp}/{tag}/run@{chunk}"


def test_ranks_exit_cleanly(world):
    assert world["codes"] == [0] * WORLD


def test_tp_fsdp_trainer_matches_one_process(world):
    """Loss rows and the chunk checkpoint against the one-process run's;
    rank 0 alone writes the checkpoints, the JSON and the eval PNGs."""
    tmp = world["tmp"]
    calls = [_result(world, "tp_fsdp", r)["calls"] for r in range(WORLD)]
    for key, n in dict(write_model=4, write_train_state=1, json=3, png=1).items():
        assert [c[key] for c in calls] == [n, 0, 0, 0], (key, calls)
    assert len(_rows(world["run"]["loss_csv"])) == TRAINER_STEPS
    _losses_close(_rows(world["run"]["loss_csv"]), _rows(world["one"]["loss_csv"])[:TRAINER_STEPS])
    _checkpoint_close(_run_dir(tmp, "tp_fsdp", 0), _run_dir(tmp, "one", 0), TRAINER_STEPS)
    assert os.listdir(os.path.join(world["run"]["eval_sample_dir"], "step_00000002")) == ["sample_0.png"]


def test_tp_fsdp_eval_image_matches_one_process(world):
    """Every rank samples; rank 0 saves, its image the one-process run's."""
    got, want = _result(world, "tp_fsdp", 0)["images"], world["one_images"]
    assert all(_result(world, "tp_fsdp", r)["images"] == [] for r in range(1, WORLD))
    assert len(got) == len(want) == 1
    assert got[0].shape == want[0].shape == (1, 32, 32, 3)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)


def test_model_parallel_pairs_hold_the_same_whole_leaves(world):
    """At the chunk checkpoint each rank's local state differs from the
    others' (its own shards and slices), and the trainer's replica check
    passed on every rank (it raises otherwise): one digest each, four
    distinct."""
    digests = [_result(world, "tp_fsdp", r)["digests"] for r in range(WORLD)]
    assert all(len(d) == 1 for d in digests) and len({d[0] for d in digests}) == WORLD


def test_tp_fsdp_checkpoint_has_the_one_process_layout(world):
    """The same files, tensor names, shapes and dtypes as the one-process
    chunk checkpoint's."""
    tmp = world["tmp"]
    for sub in ("unet", "text_encoder", "vae", trainer.TRAIN_STATE_SUBDIR):
        a, b = _run_dir(tmp, "tp_fsdp", 0) + f"/{sub}", _run_dir(tmp, "one", 0) + f"/{sub}"
        assert sorted(os.listdir(a)) == sorted(os.listdir(b)), sub
        for name in os.listdir(a):
            if name.endswith(".safetensors"):
                ta, tb = load_safetensors(os.path.join(a, name)), load_safetensors(os.path.join(b, name))
                assert {k: (v.shape, v.dtype) for k, v in ta.items()} == {k: (v.shape, v.dtype) for k, v in tb.items()}


@pytest.mark.parametrize("tag", ["tp_fsdp_from_one", "one_from_tp_fsdp"])
def test_checkpoints_resume_across_worlds(world, tag):
    """A one-process checkpoint resumed on four ranks, and a four-rank
    checkpoint resumed in one process: the saved state restored bit for
    bit, then rows and checkpoint within the bounds of the one-process
    resume."""
    tmp = world["tmp"]
    if tag == "tp_fsdp_from_one":
        restored = [_result(world, tag, r)["restored"] for r in range(WORLD)]
        assert restored == [[True]] * WORLD
    else:
        assert world["from_run_resumed"] == [True]
    assert world["one_resumed"] == [True]
    rows = _rows(str(tmp / f"loss_{tag}.csv"))
    one_rows = _rows(world["one"]["loss_csv"])[TRAINER_STEPS:]
    assert len(rows) == TRAINER_STEPS and len(one_rows) == TRAINER_STEPS
    _losses_close(rows, one_rows)
    _checkpoint_close(_run_dir(tmp, tag, 1), _run_dir(tmp, "one", 1), 2 * TRAINER_STEPS)
