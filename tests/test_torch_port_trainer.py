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
  port trainer's ``model_path``, with equal weights
  (``tests/test_torch_port_trainer_jax_checkpoint.py``, run on a worker of
  its own under ``--dist loadfile``).
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
    training_config_from_dict,
)
from stable_diffusion_training_tpu_torch.train import trainer
from stable_diffusion_training_tpu_torch.utils.json_io import read_json_file
from torch_threads import _one_thread  # noqa: F401 (the fixture)

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
