"""The port's trainer (``trainer.main`` on ``tiny`` in f32 on the CPU) along
its other paths, each a run of its own: the streaming loader built from a
chunk directory (its batches bitwise the JAX loader's), eval sampling,
the profiler trace, the options once unported (the slow ones in
``tests/test_torch_port_trainer_options*.py``), SDXL
micro-conditioning over a latent cache, and the command line. The config
and the run helpers are ``tests/test_torch_port_trainer.py``'s; the runs
that share its module-scoped fixture stay there."""

import json
import os

import numpy as np
import pytest
import torch

from stable_diffusion_training_tpu_torch.models.hf_io import load_unet
from stable_diffusion_training_tpu_torch.train import trainer, training_config_from_dict
from test_torch_port_trainer import (
    BATCH, RES, STEPS, _loader, _local_chunk, _rows, _run, _StubTokenizer, _weights, make_config_dict,
)
from torch_threads import _one_thread  # noqa: F401 (the fixture)


def test_trainer_trains_from_a_chunk_directory(tmp_path, monkeypatch):
    """``dataloader=None``: the trainer builds the streaming loader from the
    config and trains a chunk read from ``ramdisk_path``. Finite
    ``loss.csv`` rows and a checkpoint, and the batches it trained on equal,
    bitwise, to the JAX package's loader on the same chunk and seed (one
    worker, its rng's thread id patched in both packages)."""
    import shutil
    import threading
    import types

    from stable_diffusion_training_tpu.data import dataloader as jax_dl
    from stable_diffusion_training_tpu_torch.data import dataloader as port_dl

    for module in (jax_dl, port_dl):
        fake = types.SimpleNamespace(**{k: getattr(threading, k) for k in ("Thread", "Lock", "Event")})
        fake.get_ident = lambda: 4242
        monkeypatch.setattr(module, "threading", fake)
    repo = {"repo_0": {"coma_separated_shuffle": True, "drop_caption_ratio": 0.5}}
    cfg, path = make_config_dict(tmp_path, "dl", chunk_limit=1, repo=repo, numb_of_dataloader_worker_thread=1)
    _local_chunk(cfg["ramdisk_path"])
    # the JAX loader first, on a copy: the trainer deletes its chunks at the end
    jax_ramdisk = str(tmp_path / "jax_ramdisk")
    shutil.copytree(cfg["ramdisk_path"], jax_ramdisk)
    jax_loader = jax_dl.DataLoader(
        _StubTokenizer(), path, jax_ramdisk, BATCH, cfg["repeat_batch"], [RES**2], [RES],
        numb_of_worker_thread=1, queue_get_timeout=5, chunk_number=0, seed=cfg["master_seed"],
        context_concatenation_multiplier=3,
    )
    jax_loader._print_debug = False
    jax_loader.prepare_training_dataframe()
    jax_loader.create_training_dataframe()
    jax_loader.dispatch_worker()
    want = []
    while not isinstance(b := jax_loader.grab_next_batch(), str):
        want.append(b)

    seen = []
    grab = port_dl.DataLoader.grab_next_batch

    def recording_grab(self):
        b = grab(self)
        if isinstance(b, dict):
            seen.append({k: v.copy() for k, v in b.items()})
        return b

    monkeypatch.setattr(port_dl.DataLoader, "grab_next_batch", recording_grab)
    trainer.main(path, dataloader=None, tokenizer=_StubTokenizer(), device="cpu")
    rows = _rows(cfg["loss_csv"])
    assert len(rows) == 2 and all(np.isfinite(float(r[2])) for r in rows)
    assert os.path.isdir(cfg["model_path"].split("@")[0] + "@0/unet")
    assert len(seen) == len(want) == 2
    for got, exp in zip(seen, want):
        assert got.keys() == exp.keys()
        for k in exp:
            assert np.array_equal(got[k], exp[k]), k
    assert not os.path.exists(os.path.join(cfg["ramdisk_path"], "chunk_0"))  # flushed at the end


def test_eval_sample_interval_writes_pngs(tmp_path):
    """``eval_sample_interval=2`` samples after the second step: PNGs of the
    configured size under ``eval_sample_dir/step_00000002/``."""
    from PIL import Image

    eval_dir = tmp_path / "eval"
    cfg, path = make_config_dict(
        tmp_path, "ev", chunk_limit=1, eval_sample_interval=2, eval_sample_dir=str(eval_dir),
        eval_sample_prompt_ids=[list(range(1, 78)), list(range(100, 177))], eval_num_inference_steps=2,
        eval_sample_resolution=32,
    )
    _run(path)
    assert sorted(os.listdir(eval_dir)) == ["step_00000002"]
    pngs = sorted(os.listdir(eval_dir / "step_00000002"))
    assert pngs == ["sample_0.png", "sample_1.png"]
    with Image.open(eval_dir / "step_00000002" / "sample_0.png") as im:
        assert im.size == (32, 32) and im.mode == "RGB"


def test_profile_trace_dir_writes_a_trace(tmp_path):
    """``profile_trace_dir``: a Chrome trace of the first steps, with the
    train step's ops in it."""
    trace_dir = tmp_path / "trace"
    _, path = make_config_dict(tmp_path, "pr", chunk_limit=1, profile_trace_dir=str(trace_dir))
    _run(path)
    traces = sorted(trace_dir.glob("trace_*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)


# the options' cases, by id; each file runs whole on one worker (``--dist
# loadfile``), so the slow ones are split over this file,
# ``test_torch_port_trainer_options.py``, ``_options_tp.py`` and
# ``_options_polyphase.py``
OPTIONS = {
    "mesh": (dict(mesh_shape=[1, 2]), (ValueError, "the process group has 1")),  # a model_parallel axis of 2 ranks
    "fsdp": (dict(fsdp_shard_params=True), None),  # ported: one process trains as the default does
    "tensor-parallel": (dict(tensor_parallel_shard_params=True), None),  # ported: likewise
    # ported: fsdp and model_parallel axes together hold four ranks
    "tensor-parallel-with-fsdp": (dict(mesh_shape=[1, 2, 2], tensor_parallel_shard_params=True),
                                  (ValueError, "the process group has 1")),
    "polyphase": (dict(vae_polyphase_downsample=True), "trains"),  # ported: the encode's sums in another order
}
OPTIONS_BY_FILE = {
    "trainer_paths": ("mesh", "tensor-parallel-with-fsdp"),
    "trainer_options": ("fsdp",),
    "trainer_options_tp": ("tensor-parallel",),
    "trainer_options_polyphase": ("polyphase",),
}
assert sorted(sum(OPTIONS_BY_FILE.values(), ())) == sorted(OPTIONS)


def options_params(ids):
    """``parametrize`` arguments for the options ``ids``."""
    return dict(argnames="overrides,error", argvalues=[OPTIONS[i] for i in ids], ids=list(ids))


@pytest.mark.parametrize(**options_params(OPTIONS_BY_FILE["trainer_paths"]))
def test_options_not_ported_raise(tmp_path, overrides, error):
    check_option(tmp_path, overrides, error)


def check_option(tmp_path, overrides, error):
    """Every option of the JAX package's config is ported: a mesh of more
    ranks than the process group stops the trainer with its size (a
    model_parallel axis of 2, fsdp and model_parallel axes of 2 together).
    ``fsdp_shard_params`` and ``tensor_parallel_shard_params`` in one
    process (no axis to shard over) train bitwise as the default does: the
    same loss rows and the same checkpoint. ``vae_polyphase_downsample``
    trains from the same VAE parameters, its encode summing the taps in
    another order: loss rows within 1e-5 relative, the same VAE export."""
    cfg, path = make_config_dict(tmp_path, "o", chunk_limit=1, **overrides)
    if isinstance(error, tuple):
        with pytest.raises(error[0], match=error[1]):
            trainer.main(path, dataloader=_loader(), device="cpu")
        return
    base_cfg, base_path = make_config_dict(tmp_path, "default", chunk_limit=1)
    for p in (path, base_path):
        trainer.main(p, dataloader=_loader(), device="cpu")
    got_rows, want_rows = ([float(r[2]) for r in _rows(c["loss_csv"])] for c in (cfg, base_cfg))
    if error == "trains":
        np.testing.assert_allclose(got_rows, want_rows, rtol=1e-5, atol=0)
        vae = (_weights(os.path.join(c["model_path"].split("@")[0] + "@0", "vae")) for c in (cfg, base_cfg))
        got, want = vae
        assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
        return
    assert got_rows == want_rows
    for model in ("unet", "text_encoder"):
        got = _weights(os.path.join(cfg["model_path"].split("@")[0] + "@0", model))
        want = _weights(os.path.join(base_cfg["model_path"].split("@")[0] + "@0", model))
        assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want), model


def test_sdxl_micro_conditioning_trains_from_a_latent_cache(tmp_path):
    """``sdxl_micro_conditioning=True`` (which raised before SDXL training
    was ported) builds a config, and ``trainer.main`` trains ``tiny_sdxl``
    over a ``CachedLatentLoader`` whose shards carry the moments, tower 2's
    pooled embeds and the time ids, and the frozen towers' context: finite
    rows, a chunk checkpoint whose UNet has the ``text_time`` add-embedding,
    and its ``train_state/``."""
    from stable_diffusion_training_tpu_torch.data import precompute_latent_cache
    from stable_diffusion_training_tpu_torch.models import (
        AutoencoderKL, CLIPTextModel, CLIPTextModelWithProjection, configs, random_init_,
    )

    cfg, path = make_config_dict(
        tmp_path, "xl", model_family="tiny_sdxl", chunk_limit=1, use_latent_cache=True,
        sdxl_micro_conditioning=True, cached_text_context=True, train_text_encoder=False,
    )
    assert training_config_from_dict(cfg).sdxl_micro_conditioning
    gen = torch.Generator().manual_seed(0)
    vae, te1, te2 = (random_init_(cls(**c, device="cpu"), gen) for cls, c in (
        (AutoencoderKL, configs.TINY_VAE), (CLIPTextModel, configs.TINY_CLIP),
        (CLIPTextModelWithProjection, configs.TINY_CLIP_PROJ)))
    # tiny_sdxl's UNet is tower 1's width: a tower-1 context, tower 2's pooled embeds
    loader = precompute_latent_cache(_loader(), vae, str(tmp_path / "cache"), text_encoder_2=te2,
                                     text_encoder=te1, concat_count=3, context_use_tower_2=False)
    trainer.main(path, dataloader=loader, device="cpu")
    rows = _rows(cfg["loss_csv"])
    assert len(rows) == STEPS and all(np.isfinite(float(r[2])) for r in rows)
    ckpt = str(tmp_path / "xl" / "run") + "@0"
    assert load_unet(f"{ckpt}/unet", device="cpu").addition_embed_type == "text_time"
    assert "add_embedding.linear_1.weight" in _weights(f"{ckpt}/unet")
    assert os.path.isdir(f"{ckpt}/{trainer.TRAIN_STATE_SUBDIR}")


def test_command_line_runs_the_trainer(tmp_path):
    """``python -m stable_diffusion_training_tpu_torch.training cfg.json``
    reads and backs up the config and builds the streaming loader from it
    (its ramdisk appears), then stops at the device: the command line runs
    on the card, with no CPU fallback."""
    import subprocess
    import sys

    _, path = make_config_dict(tmp_path, "cli")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "stable_diffusion_training_tpu_torch.training", path],
        cwd=repo, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr and "resolve_device" in proc.stderr
    assert os.path.exists(tmp_path / "backup_props_cli.json")
    assert os.path.isdir(tmp_path / "ramdisk")
