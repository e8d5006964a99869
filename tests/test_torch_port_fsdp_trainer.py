"""``trainer.main`` on two FSDP ranks of the CPU against one process, and
checkpoints moved between the two either way.

The parent first runs one chunk of ``trainer.main`` in one process (``one``:
2 steps of a global batch of 2 from an in-memory loader, DDIM eval at step
2). Then one two-rank world (``tests/torch_dist_child.py``, mesh ``[1, 2,
1]`` with ``fsdp_shard_params``; each rank fed its row of each batch) runs:

- ``fsdp``: the same chunk, eval included (every rank samples through the
  sharded modules, rank 0 writes);
- ``fsdp_from_one``: the second chunk, resumed from a copy of the
  one-process chunk checkpoint (its ``train_state/`` read whole, each rank
  keeping its shards).

Meanwhile the parent resumes the one-process run for its second chunk, and
afterwards resumes a copy of the FSDP chunk checkpoint in one process
(``one_from_fsdp``). Checks: the FSDP run's loss rows, checkpoint and eval
images against the one-process run's; every resume restoring the saved
params and codes bit for bit (gathered whole on the ranks), and its rows and
checkpoint against the one-process resume; the FSDP run's rank 0 alone
writing; its checkpoint files the same as the one-process run's in names,
keys, shapes and dtypes, and its ``unet/`` read by the JAX package's
``hf_io``.

Tolerances: loss rows 1e-5 relative and params n * 2 lr + 1e-6 over n
steps (``tests/test_torch_port_distributed.py``); eval images 1e-5 absolute
(pixels in [0, 1]; the same weights within 2 lr give the same images to f32
rounding through 2 DDIM steps of the tiny models).
"""

import json
import os
import shutil
import time

import jax
import numpy as np
import pytest
import torch

import torch_dist_child as child
from stable_diffusion_training_tpu.models import hf_io as jax_hf_io
from stable_diffusion_training_tpu_torch.data import InMemoryDataLoader
from stable_diffusion_training_tpu_torch.models.hf_io import jax_params_to_state_dict, load_safetensors
from stable_diffusion_training_tpu_torch.train import eval_sampler, trainer
from stable_diffusion_training_tpu_torch.utils.json_io import read_json_file
from test_torch_port_distributed import TRAINER_STEPS, _checkpoint_close, _losses_close, _memory_batches
from test_torch_port_trainer import _rows, _weights, make_config_dict
from torch_threads import _one_thread  # noqa: F401 (the fixture)

WORLD = 2
FSDP = dict(mesh_shape=[1, WORLD, 1], fsdp_shard_params=True)
EVAL = dict(eval_sample_interval=2, eval_sample_prompt_ids=[list(range(1, 78))], eval_num_inference_steps=2,
            eval_sample_resolution=32)
DEADLINE_S = 300


def _resume_config(tmp, src_tag, tag, **overrides):
    """A config that resumes the run ``src_tag`` after its first chunk from a
    copy of its chunk checkpoint, in its own directories."""
    src = read_json_file(str(tmp / f"props_{src_tag}.json"))
    shutil.copytree(src["model_path"], str(tmp / tag / "run@0"))
    cfg = {**src, "model_path": str(tmp / tag / "run") + "@0", "test_save_path": str(tmp / tag / "probe"),
           "loss_csv": str(tmp / f"loss_{tag}.csv"), "ramdisk_path": str(tmp / f"ramdisk_{tag}"),
           "eval_sample_interval": 0, **overrides}
    for key in ("mesh_shape", "fsdp_shard_params", "tensor_parallel_shard_params"):
        if key not in overrides:
            cfg.pop(key, None)
    path = str(tmp / f"props_{tag}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return cfg, path


def _one_process(path, images=None):
    """One ``trainer.main`` chunk in this process, recording its eval
    images and whether its restore held the saved state."""
    save_png, restore = eval_sampler.save_png_images, trainer.restore_train_state
    restored = []

    def keep(arr, directory):
        if images is not None:
            images.append(np.asarray(arr).copy())
        return save_png(arr, directory)

    def check(directory, template):
        out = restore(directory, template)
        restored.append(child.restored_as_saved(directory, out))
        return out

    eval_sampler.save_png_images, trainer.restore_train_state = keep, check
    try:
        trainer.main(path, dataloader=InMemoryDataLoader(_memory_batches()), device="cpu")
    finally:
        eval_sampler.save_png_images, trainer.restore_train_state = save_png, restore
    return restored


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp_trainer")
    one_cfg, one_path = make_config_dict(tmp, "one", chunk_limit=1, keep_trained_model_buffer=5,
                                         eval_sample_dir=str(tmp / "eval_one"), **EVAL)
    one_images = []
    _one_process(one_path, one_images)
    fsdp_cfg, fsdp_path = make_config_dict(tmp, "fsdp", chunk_limit=1, keep_trained_model_buffer=5,
                                           eval_sample_dir=str(tmp / "eval_fsdp"), **EVAL, **FSDP)
    _, from_one_path = _resume_config(tmp, "one", "fsdp_from_one", **FSDP)
    cases = {name: dict(kind="trainer", loader="memory", batches=_memory_batches(), config_path=path, mesh=(1, 2, 1))
             for name, path in (("fsdp", fsdp_path), ("fsdp_from_one", from_one_path))}
    procs = child.start_world(str(tmp), cases, WORLD)
    try:
        one_resumed = _one_process(one_path)  # the one-process run's second chunk
    finally:
        codes = child.wait_world(procs, time.monotonic() + DEADLINE_S)
    results = child.world_results(str(tmp), cases, WORLD)
    _, from_fsdp_path = _resume_config(tmp, "fsdp", "one_from_fsdp")
    from_fsdp_resumed = _one_process(from_fsdp_path)
    return dict(tmp=tmp, codes=codes, results=results, one=one_cfg, fsdp=fsdp_cfg, one_images=one_images,
                one_resumed=one_resumed, from_fsdp_resumed=from_fsdp_resumed)


def _result(world, name, rank):
    got = world["results"].get((name, rank))
    assert got is not None, f"rank {rank} gave no result for {name} (exit codes {world['codes']})"
    assert not isinstance(got, str), got
    return got


def _run_dir(tmp, tag, chunk):
    return f"{tmp}/{tag}/run@{chunk}"


def test_ranks_exit_cleanly(world):
    assert world["codes"] == [0] * WORLD


def test_fsdp_trainer_matches_one_process(world):
    """Loss rows and the chunk checkpoint against the one-process run's;
    rank 0 alone writes the checkpoints, the JSON and the eval PNGs."""
    tmp = world["tmp"]
    r0, r1 = (_result(world, "fsdp", r) for r in range(WORLD))
    for key, n in dict(write_model=4, write_train_state=1, json=3, png=1).items():
        assert (r0["calls"][key], r1["calls"][key]) == (n, 0), (key, r0["calls"], r1["calls"])
    assert len(_rows(world["fsdp"]["loss_csv"])) == TRAINER_STEPS
    _losses_close(_rows(world["fsdp"]["loss_csv"]), _rows(world["one"]["loss_csv"])[:TRAINER_STEPS])
    _checkpoint_close(_run_dir(tmp, "fsdp", 0), _run_dir(tmp, "one", 0), TRAINER_STEPS)
    assert os.listdir(os.path.join(world["fsdp"]["eval_sample_dir"], "step_00000002")) == ["sample_0.png"]


def test_fsdp_eval_images_match_one_process(world):
    got, want = _result(world, "fsdp", 0)["images"], world["one_images"]
    assert len(got) == len(want) == 1
    assert got[0].shape == want[0].shape == (1, 32, 32, 3)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)


def test_fsdp_checkpoint_has_the_one_process_layout(world):
    """The same files, tensor names, shapes and dtypes as the one-process
    chunk checkpoint's."""
    tmp = world["tmp"]
    for sub in ("unet", "text_encoder", "vae", trainer.TRAIN_STATE_SUBDIR):
        a, b = _run_dir(tmp, "fsdp", 0) + f"/{sub}", _run_dir(tmp, "one", 0) + f"/{sub}"
        assert sorted(os.listdir(a)) == sorted(os.listdir(b)), sub
        for name in os.listdir(a):
            if name.endswith(".safetensors"):
                ta, tb = load_safetensors(os.path.join(a, name)), load_safetensors(os.path.join(b, name))
                assert {k: (v.shape, v.dtype) for k, v in ta.items()} == {k: (v.shape, v.dtype) for k, v in tb.items()}


def test_fsdp_unet_loads_in_the_jax_package(world):
    ckpt = _run_dir(world["tmp"], "fsdp", 0)
    got = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, jax_hf_io.load_unet_params(f"{ckpt}/unet")))
    want = _weights(f"{ckpt}/unet")
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("tag", ["fsdp_from_one", "one_from_fsdp"])
def test_checkpoints_resume_across_worlds(world, tag):
    """A one-process checkpoint resumed on two FSDP ranks, and an FSDP
    checkpoint resumed in one process: the saved state restored bit for bit,
    then rows and checkpoint within the bounds of the one-process resume."""
    tmp = world["tmp"]
    if tag == "fsdp_from_one":
        restored = [_result(world, tag, r)["restored"] for r in range(WORLD)]
        assert restored == [[True]] * WORLD
    else:
        assert world["from_fsdp_resumed"] == [True]
    assert world["one_resumed"] == [True]
    rows = _rows(str(tmp / f"loss_{tag}.csv"))
    one_rows = _rows(world["one"]["loss_csv"])[TRAINER_STEPS:]
    assert len(rows) == TRAINER_STEPS and len(one_rows) == TRAINER_STEPS
    _losses_close(rows, one_rows)
    _checkpoint_close(_run_dir(tmp, tag, 1), _run_dir(tmp, "one", 1), 2 * TRAINER_STEPS)
