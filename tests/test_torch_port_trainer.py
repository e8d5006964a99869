"""The port's trainer (``python -m stable_diffusion_training_tpu_torch.training``)
on the CPU: ``trainer.main`` in-process on ``tiny`` in f32 with an injected
``InMemoryDataLoader``, held to what ``tests/test_trainer.py`` checks of the
JAX trainer, plus the pieces both packages share.

- Artifacts: the mutated JSON (``chunk_number``, ``chunk_steps``,
  ``master_seed``, ``model_path``), the backup, ``loss.csv`` (header,
  newline-prefixed finite rows), probe deletion, rotation, the EMA
  checkpoints and a checkpoint that the port loads back equal to the state.
- Full-state resume: a run stopped after one chunk and resumed from its
  ``train_state/`` logs the same later losses and ends with the same
  weights as an uninterrupted run, bit for bit.
- Cross-loading: the port's checkpoint loads in the JAX package
  (``hf_io.load_*_params``) with params equal to the port's, bit for bit
  (f32 both ways); a directory the JAX package's ``save_model`` wrote is the
  port trainer's ``model_path``, with equal weights.
- ``all_unique_resolutions``, ``synthetic_batch`` and the TensorBoard event
  file (read back by the JAX package's ``read_event_file``) equal the JAX
  package's.
"""

import json
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from stable_diffusion_training_tpu.data.memory import synthetic_batch as jax_synthetic_batch
from stable_diffusion_training_tpu.models import hf_io as jax_hf_io
from stable_diffusion_training_tpu.train.aot import all_unique_resolutions as jax_all_unique_resolutions
from stable_diffusion_training_tpu.utils.tb_events import read_event_file
from stable_diffusion_training_tpu_torch.data import InMemoryDataLoader, synthetic_batch
from stable_diffusion_training_tpu_torch.models.hf_io import jax_params_to_state_dict, load_unet
from stable_diffusion_training_tpu_torch.train import (
    all_unique_resolutions,
    batch_dispatch_key,
    bucket_train_steps,
    load_models,
    training_config_from_dict,
)
from stable_diffusion_training_tpu_torch.train import trainer
from stable_diffusion_training_tpu_torch.utils.json_io import read_json_file

BATCH, RES, STEPS = 2, 64, 2


def make_config_dict(tmp_path, tag, **overrides):
    """``tests/test_trainer.py``'s config at the port's test size."""
    cfg = {
        "model_path": str(tmp_path / tag / "run") + "@0",
        "test_save_path": str(tmp_path / tag / "probe"),
        "batch_size": BATCH, "learning_rate": 1e-06, "unet_learning_rate": 1e-06,
        "text_encoder_learning_rate": 2.5e-07, "lr_scheduler": "constant",
        "adam_to_lion_scale_factor": 7.0, "compilation_cache_path": str(tmp_path / "cache"),
        "keep_compiled_fn_in_cache": False, "text_encoder_context_window": 77,
        "context_window_concatenation_count": 3, "beta_scheduler": "zero_snr_scaled_linear",
        "prediction_type": "v_prediction", "aot_compile": True, "strip_bos_eos_token": True,
        "offset_noise_magnitude": 0.0, "min_snr_gamma_magnitude": 0.0,
        "perturbation_noise_magnitude": 0.0,
        "excluded_layer_pattern_from_weight_decay": ["bias", "scale", "embedding"],
        "excluded_layer_from_quantization": ["bias", "scale", "embedding"],
        "quantize_unet_state": True, "quantize_text_encoder_state": True,
        "accumulate_unet_ema": True, "accumulate_text_encoder_ema": True, "ema_rate": 0.999,
        "quant_block_size": 16, "image_area_root": [RES], "minimum_axis_length": [RES],
        "master_seed": 0, "chunk_number": 0, "chunk_limit": 2,
        "ramdisk_path": str(tmp_path / "ramdisk"), "repo": {}, "token": None, "repeat_batch": 2,
        "numb_of_prefetched_batch": 1, "numb_of_dataloader_worker_thread": 2,
        "queue_get_timeout": 5, "DEBUG": False, "chunk_steps": 0, "keep_trained_model_buffer": 1,
        "loss_logging_interval": 1, "loss_csv": str(tmp_path / f"loss_{tag}.csv"),
        "model_family": "tiny", "mixed_precision": "float32",
    }
    cfg.update(overrides)
    path = str(tmp_path / f"props_{tag}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return cfg, path


def _loader():
    return InMemoryDataLoader.synthetic(STEPS, BATCH, [(RES, RES)], concat_count=3, vocab_size=1000, seed=0)


def _run(path):
    trainer.main(path, dataloader=_loader(), tokenizer=None, device="cpu")


def _rows(loss_csv):
    with open(loss_csv) as f:
        lines = f.read().splitlines()
    assert lines[0] == "steps, step_size, loss, time, chunk, seed"
    return [line.split(",") for line in lines[1:] if line]


def _weights(directory):
    from stable_diffusion_training_tpu_torch.models.hf_io import load_safetensors

    name = "model.safetensors" if directory.endswith("text_encoder") else "diffusion_pytorch_model.safetensors"
    return load_safetensors(os.path.join(directory, name))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run A: two chunks in one invocation. Run B: one chunk, then a second
    invocation that resumes from the checkpoint's ``train_state/``."""
    tmp_path = tmp_path_factory.mktemp("trainer")
    cfg_a, path_a = make_config_dict(tmp_path, "a", tensorboard_dir=str(tmp_path / "tb"))
    _run(path_a)
    cfg_b, path_b = make_config_dict(tmp_path, "b", chunk_limit=1, keep_trained_model_buffer=5)
    _run(path_b)
    assert os.path.isdir(f"{tmp_path}/b/run@0/{trainer.TRAIN_STATE_SUBDIR}")
    _run(path_b)
    return tmp_path, (cfg_a, path_a), (cfg_b, path_b)


def test_trainer_artifacts(runs):
    tmp_path, (cfg, path), _ = runs
    base = str(tmp_path / "a" / "run")
    final = read_json_file(path)
    assert (final["chunk_number"], final["chunk_steps"], final["master_seed"]) == (2, 2, 1)
    assert final["model_path"] == f"{base}@1"
    assert read_json_file(str(tmp_path / "backup_props_a.json")) == cfg
    rows = _rows(cfg["loss_csv"])
    assert len(rows) == 2 * STEPS  # interval 1: every step of both chunks
    assert all(np.isfinite(float(r[2])) for r in rows)
    assert [int(r[4]) for r in rows] == [0] * STEPS + [1] * STEPS  # the chunk column
    assert not os.path.exists(cfg["test_save_path"]) and not os.path.exists(cfg["test_save_path"] + "-EMA")
    # rotation (buffer 1): @1 and its EMA kept, @0 and its EMA deleted
    assert os.path.isdir(f"{base}@1") and os.path.isdir(f"{base}-EMA@1")
    assert not os.path.isdir(f"{base}@0") and not os.path.isdir(f"{base}-EMA@0")
    for sub in ("unet", "vae", "text_encoder", "scheduler"):
        assert os.path.isdir(f"{base}@1/{sub}"), sub
    with open(f"{base}@1/scheduler/scheduler_config.json") as f:
        scheduler = json.load(f)
    assert (scheduler["beta_schedule"], scheduler["prediction_type"]) == ("scaled_linear", "v_prediction")
    assert os.path.exists(f"{base}@1/model_index.json")
    assert os.path.isdir(f"{base}@1/{trainer.TRAIN_STATE_SUBDIR}")
    # the checkpoint loads back in the port, equal to the state it saved
    # (its train_state/ holds the params as they were, here in f32)
    from stable_diffusion_training_tpu_torch.models.hf_io import load_safetensors, load_text_encoder

    state_dir = f"{base}@1/{trainer.TRAIN_STATE_SUBDIR}"
    for name, loader in (("unet", load_unet), ("text_encoder", load_text_encoder)):
        model = loader(f"{base}@1/{name}", device="cpu")
        saved = load_safetensors(f"{state_dir}/{name}_state.safetensors")
        params = dict(model.named_parameters())
        assert params
        for k, p in params.items():
            assert torch.equal(p, saved[f"{name}_state/params/{k}"]), (name, k)


def test_resume_from_train_state_is_bitwise(runs):
    tmp_path, (cfg_a, _), (cfg_b, path_b) = runs
    rows_a, rows_b = _rows(cfg_a["loss_csv"]), _rows(cfg_b["loss_csv"])
    chunk1 = lambda rows: [r[2] for r in rows if int(r[4]) == 1]
    assert chunk1(rows_a) and chunk1(rows_a) == chunk1(rows_b)
    assert read_json_file(path_b)["model_path"] == str(tmp_path / "b" / "run") + "@1"
    for sub in ("", "-EMA"):
        for model in ("unet", "text_encoder"):
            wa = _weights(f"{tmp_path}/a/run{sub}@1/{model}")
            wb = _weights(f"{tmp_path}/b/run{sub}@1/{model}")
            assert wa.keys() == wb.keys()
            for k in wa:
                assert torch.equal(wa[k], wb[k]), (sub, model, k)


def test_port_checkpoint_loads_in_the_jax_package(runs):
    tmp_path = runs[0]
    ckpt = f"{tmp_path}/a/run@1"
    for name, load in (("unet", jax_hf_io.load_unet_params), ("vae", jax_hf_io.load_vae_params),
                       ("text_encoder", jax_hf_io.load_text_encoder_params)):
        got = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, load(f"{ckpt}/{name}")))
        want = _weights(f"{ckpt}/{name}")
        assert got.keys() == want.keys(), name
        for k in want:
            assert torch.equal(got[k], want[k]), (name, k)


def test_jax_checkpoint_is_the_port_trainers_model_path(tmp_path):
    """The JAX package's ``save_model`` output as ``model_path``: the port
    loads weights equal to the JAX params, and trains a chunk from it."""
    from stable_diffusion_training_tpu.train import TrainingConfig as JaxTrainingConfig
    from stable_diffusion_training_tpu.train import load_models as jax_load_models
    from stable_diffusion_training_tpu.train import save_model as jax_save_model

    cfg, path = make_config_dict(tmp_path, "j", chunk_limit=1)
    j_models = jax_load_models(training_config_from_dict(cfg))
    jax_dir = str(tmp_path / "jax_ckpt")
    jax_save_model(
        {"unet": j_models["unet"]["unet_model"], "vae": j_models["vae"]["vae_model"],
         "text_encoder": j_models["text_encoder"]["text_encoder_model"]},
        None, j_models["unet"]["unet_params"], j_models["text_encoder"]["text_encoder_params"],
        j_models["vae"]["vae_params"], jax_dir,
    )
    port = load_models(training_config_from_dict(dict(cfg, model_path=jax_dir)), device="cpu")
    for key in ("unet", "vae", "text_encoder"):
        want = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, j_models[key][f"{key}_params"]))
        got = port[key][f"{key}_params"]
        assert got.keys() == want.keys(), key
        for k in want:
            assert torch.equal(got[k].detach(), want[k]), (key, k)

    cfg["model_path"] = jax_dir
    with open(path, "w") as f:
        json.dump(cfg, f)
    _run(path)
    final = read_json_file(path)
    assert final["model_path"] == f"{jax_dir}@0" and os.path.isdir(f"{jax_dir}@0/unet")
    assert all(np.isfinite(float(r[2])) for r in _rows(cfg["loss_csv"]))


def test_buckets_and_synthetic_batches_match_jax(tmp_path):
    base = training_config_from_dict(make_config_dict(tmp_path, "r")[0])
    for roots, mins in (([64], [64]), ([512, 768], [256, 512]), ([1024], [512])):
        cfg = base.replace(image_area_root=roots, minimum_axis_length=mins)
        np.testing.assert_array_equal(all_unique_resolutions(cfg), jax_all_unique_resolutions(cfg))
    for args in ((2, (64, 64)), (3, (128, 64))):
        got, want = synthetic_batch(*args, vocab_size=1000, seed=5), jax_synthetic_batch(*args, vocab_size=1000, seed=5)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_step_table_keys_and_unknown_shape(tmp_path):
    """One step per bucket, keyed by the batch shape; an unknown shape is a
    KeyError, as the JAX package's dict of compiled steps."""
    cfg = training_config_from_dict(make_config_dict(tmp_path, "r")[0]).replace(
        image_area_root=[128], minimum_axis_length=[64]
    )
    vae_config = SimpleNamespace(block_out_channels=(32, 64), latent_channels=4)  # the tiny VAE's
    frozen_vae = SimpleNamespace(call=SimpleNamespace(config=vae_config))
    steps = bucket_train_steps(cfg, frozen_vae)
    assert sorted(steps) == sorted((BATCH, 3, int(a), int(b)) for a, b in all_unique_resolutions(cfg))
    batch = {"pixel_values": np.zeros((BATCH, 3, 96, 96), np.float32)}
    with pytest.raises(KeyError):
        steps[batch_dispatch_key(batch)]
    latent = bucket_train_steps(cfg.replace(use_latent_cache=True), frozen_vae)
    assert sorted(latent) == sorted((BATCH, 8, int(a) // 2, int(b) // 2) for a, b in all_unique_resolutions(cfg))
    assert batch_dispatch_key({"latent_moments": np.zeros((BATCH, 8, 64, 64))}) in latent


def test_tensorboard_events_read_back_by_jax(runs):
    tmp_path = runs[0]
    files = sorted((tmp_path / "tb").glob("events.out.tfevents.*"))
    assert len(files) == 1
    events = read_event_file(str(files[0]))
    assert events[0]["file_version"] == "brain.Event:2"
    losses = [e for e in events if e.get("tag") == "train/loss"]
    assert [e["step"] for e in losses] == list(range(1, 2 * STEPS + 1))
    rows = _rows(str(tmp_path / "loss_a.csv"))
    assert [np.float32(e["value"]) for e in losses] == [np.float32(r[2]) for r in rows]


class _StubTokenizer:
    """Whitespace words hashed (crc32) into the tiny CLIP's 1,000 ids."""

    bos_token_id, eos_token_id, pad_token_id = 1, 2, 0
    model_max_length = 77

    def __call__(self, texts, add_special_tokens=False, **kw):
        import zlib

        return {"input_ids": [[3 + zlib.crc32(w.encode()) % 996 for w in t.split()] for t in texts]}

    def save_pretrained(self, directory):  # what a checkpoint keeps of it
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "stub_tokenizer.json"), "w") as f:
            json.dump({"vocab_size": 1000, "bos": 1, "eos": 2, "pad": 0}, f)


def _local_chunk(ramdisk, n=4):
    """``chunk_0/repo_0`` under ``ramdisk``: ``n`` seeded PNGs of several
    aspects that the 64 tier buckets to 64x64, and their CSV."""
    from PIL import Image

    repo_dir = os.path.join(ramdisk, "chunk_0", "repo_0")
    os.makedirs(repo_dir)
    rows = ["filename,caption,image_width,image_height"]
    for i in range(n):
        w, h = ((90, 70), (70, 90), (64, 64), (120, 100))[i % 4]
        arr = np.random.default_rng(i).integers(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(arr).save(os.path.join(repo_dir, f"{i}.png"))
        rows.append(f'{i}.png,"photo {i}, tag a, tag b",{w},{h}')
    with open(os.path.join(repo_dir, "meta.csv"), "w") as f:
        f.write("\n".join(rows))


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


@pytest.mark.parametrize(
    "overrides,item",
    [
        (dict(mesh_shape=[2, 1]), "item 7"),
        (dict(fsdp_shard_params=True), "item 7"),
        (dict(tensor_parallel_shard_params=True), "item 7"),
        (dict(vae_polyphase_downsample=True), "item 9"),
    ],
    ids=["mesh", "fsdp", "tensor-parallel", "polyphase"],
)
def test_options_not_ported_raise(tmp_path, overrides, item):
    """A config that asks the JAX package for a multi-device mesh, sharding
    or the polyphase VAE downsample stops the port's trainer with the
    ROADMAP item instead of training without it."""
    _, path = make_config_dict(tmp_path, "o", **overrides)
    with pytest.raises(NotImplementedError, match=item):
        trainer.main(path, dataloader=_loader(), device="cpu")


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


def test_example_config_and_one_device_mesh_are_accepted():
    """``model_properties_example.json`` (``mesh_shape: null``) and a mesh of
    one device build a config: only what the port lacks raises."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    example = read_json_file(os.path.join(repo, "model_properties_example.json"))
    cfg = training_config_from_dict(example)
    assert cfg.mesh_shape is None and not cfg.fsdp_shard_params
    assert training_config_from_dict(dict(example, mesh_shape=[1, 1, 1])).mesh_shape == [1, 1, 1]


class _FakeLoader:
    def __init__(self, items):
        self.items = list(items)
        self.grabs = 0

    def grab_next_batch(self):
        self.grabs += 1
        return self.items.pop(0) if self.items else "end_of_batch"


def _fake_batch():
    return {
        "pixel_values": np.zeros((2, 3, 8, 8), np.float32),
        "input_ids": np.zeros((6 * 77,), np.int32),
        "attention_mask": np.ones((6 * 77,), np.int32),
    }


@pytest.mark.parametrize(
    "items,total,depth,kinds,grabs",
    [
        ([_fake_batch(), None, _fake_batch(), _fake_batch(), "end_of_batch"], 5, 2,
         ["batch", "none", "batch", "batch", "end_of_batch"], 5),  # None passes through in order
        ([_fake_batch()] * 10, 3, 4, ["batch"] * 3, 3),  # never grabs past total
        ([_fake_batch(), "end_of_batch"], 10, 3, ["batch", "end_of_batch"], 2),  # stops at the end
    ],
    ids=["none-passes-through", "total-caps-grabs", "stops-at-end"],
)
def test_prefetch_stream_matches_the_jax_trainers(items, total, depth, kinds, grabs):
    """``_prefetch_to_device``'s stream, as ``tests/test_trainer.py``
    checks the JAX trainer's: batches come out as torch tensors with ids and
    mask reshaped to the context window."""
    loader = _FakeLoader(items)
    out = list(trainer._prefetch_to_device(loader, total, 77, "cpu", depth=depth))
    assert ["batch" if isinstance(o, dict) else ("none" if o is None else o) for o in out] == kinds
    assert loader.grabs == grabs
    batch = out[0]
    assert isinstance(batch["pixel_values"], torch.Tensor) and batch["input_ids"].shape == (6, 77)
    assert batch["attention_mask"].shape == (6, 77)


def test_run_config_checks_the_bucket_tiers(tmp_path):
    _, path = make_config_dict(tmp_path, "x", image_area_root=[64, 128])
    with pytest.raises(ValueError, match="image_area_root and minimum_axis_length"):
        trainer.load_run_config(path)


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
