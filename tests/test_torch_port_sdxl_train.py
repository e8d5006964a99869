"""SDXL training in the port against the JAX package's, on the CPU in f32:
the micro-conditioned train step (``pooled_text_embeds`` and ``time_ids``
into the UNet's ``text_time`` add-embedding), its batches from the offline
latent cache, the step table's latent-cache buckets and the trainer. The
dual-tower, refiner and grad-accumulation step cases run from
``tests/test_torch_port_sdxl_train_cached.py``, ``_refiner.py`` and
``_accum.py`` (``CASES_BY_FILE``).

Each step case starts both sides from one state (the JAX package's
``tiny_sdxl``, ``tiny_sdxl_dual`` or ``tiny_sdxl_refiner`` family, crossed
into the port as ``tests/test_torch_port_train_step.py`` does), runs one
step of the jitted JAX ``train_step`` and one of the port's with JAX's own
draws injected, and holds the results to that file's bounds (see its
docstring): loss 1e-5 relative; params and EMA 2 * lr + 1e-6 absolute with
at most 1e-3 of the update signs flipped; momentum codes at most one apart
where |code| > 10 (15 under grad accumulation, whose two micro-batch sums
carry two roundings: ``tests/test_torch_port_train_side_paths.py``) and at
most 1e-4 of them further; scales 1e-2 relative. Two changes, for the
same reason as there: codes may be further than one apart up to |code| 15
in every case ((15/127)^5 ~ 2e-5 of the block's absmax, as under grad
accumulation: the SDXL UNet's two transformer layers and add-embedding add
roundings to every grad; seen: -10 against -12 in one code of 36,864 of
the dual case's mid-block conv); and the momentum of the ``time_emb_proj``
kernels of 32-channel resnets is not compared. Their GroupNorm has one
channel per group and subtracts each channel's mean, which takes away the
per-channel time embedding, so their exact grad is 0 and both sides' grads
are rounding noise (scales ~3e8, seen 1% apart). Their params are held to
the bound of every other. The cases:

- ``in-step-context``: ``tiny_sdxl`` from pixels, tower 1 encoded and
  trained in the step, the pooled embeds and 6 time ids in the batch;
- ``cached-dual-context``: ``tiny_sdxl_dual`` (a 64-wide context, the two
  towers' feature concat) from a cache the port's ``data/latent_cache.py``
  wrote with both towers frozen (moments, pooled embeds, time ids, context);
- ``refiner``: the refiner-shaped UNet (5 time ids, an aesthetic score) from
  cached moments, tower 1 frozen and encoded in the step;
- ``grad-accumulation``: ``tiny_sdxl`` from cached moments in two
  micro-batches, each entry of the batch (pooled embeds and time ids too)
  split along axis 0.

In every case the UNet's ``add_embedding`` params move, on both sides.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_diffusion_training_tpu.models import hf_io as jax_hf_io
from stable_diffusion_training_tpu.train import (
    TrainingConfig as JaxTrainingConfig,
    on_device_model_training_state as jax_training_state,
    train_step as jax_train_step,
)
from stable_diffusion_training_tpu_torch.data import (
    CachedLatentLoader,
    InMemoryDataLoader,
    cache_batches_to_dir,
    precompute_latent_cache,
    sdxl_time_ids,
)
from stable_diffusion_training_tpu_torch.models import (
    AutoencoderKL,
    CLIPTextModelWithProjection,
    configs,
    random_init_,
)
from stable_diffusion_training_tpu_torch.models.hf_io import jax_params_to_state_dict, load_safetensors
from stable_diffusion_training_tpu_torch.train import (
    TrainingConfig,
    bucket_train_steps,
    on_device_model_training_state,
    train_step,
    trainer,
)
from stable_diffusion_training_tpu_torch.train.states import FrozenModel
from test_torch_port_train_step import BATCH, _config, _load_jax_state, assert_step_matches_jax
from test_torch_port_trainer import make_config_dict
from torch_threads import _one_thread  # noqa: F401 (the fixture)

RES, CONCAT = 64, 3
LATENT = RES // 2  # the tiny VAE downsamples once
RNG = jax.random.PRNGKey(11)
STATICS = ("strip_bos_eos_token", "ema_rate", "grad_accumulation_steps", "train_text_encoder")

CASES = {  # id: (family, config overrides, batch source)
    "in-step-context": ("tiny_sdxl", dict(sdxl_micro_conditioning=True), "pixels"),
    "cached-dual-context": (
        "tiny_sdxl_dual",
        dict(sdxl_micro_conditioning=True, use_latent_cache=True, cached_text_context=True,
             train_text_encoder=False),
        "cache-dual",
    ),
    "refiner": (
        "tiny_sdxl_refiner",
        dict(sdxl_micro_conditioning=True, sdxl_time_ids_count=5, use_latent_cache=True,
             train_text_encoder=False),
        "cache-refiner",
    ),
    "grad-accumulation": (
        "tiny_sdxl", dict(sdxl_micro_conditioning=True, use_latent_cache=True, grad_accumulation_steps=2),
        "cache",
    ),
}
# the cases by file: each file runs whole on one worker (``--dist loadfile``),
# so three go to test_torch_port_sdxl_train_cached.py, _refiner.py and
# _accum.py, which import the check
CASES_BY_FILE = {
    "sdxl_train": ("in-step-context",),
    "sdxl_train_cached": ("cached-dual-context",),
    "sdxl_train_refiner": ("refiner",),
    "sdxl_train_accum": ("grad-accumulation",),
}
assert sorted(sum(CASES_BY_FILE.values(), ())) == sorted(CASES)


def _sdxl_config(cls, case):
    family, overrides, _ = CASES[case]
    return _config(cls, "v-zero-snr").replace(model_path=family, model_family=family, **overrides)


def _tower_2(seed=3):
    """A frozen tiny tower 2 (``TINY_CLIP_PROJ``, pooled width 16) with
    seeded weights."""
    te2 = CLIPTextModelWithProjection(**configs.TINY_CLIP_PROJ, device="cpu")
    return random_init_(te2, torch.Generator().manual_seed(seed)).eval()


def _batch(source, port_states, tmp_path):
    """One numpy batch of ``BATCH`` 64x64 images: pixels with the pooled
    embeds and time ids, or a shard of the port's latent cache."""
    pixels = InMemoryDataLoader.synthetic(1, BATCH, [(RES, RES)], concat_count=CONCAT, vocab_size=1000, seed=4)
    batch = dict(pixels.grab_next_batch())
    if source == "pixels":
        rng = np.random.default_rng(5)
        batch["pooled_text_embeds"] = rng.standard_normal((BATCH, 16)).astype(np.float32)
        batch["time_ids"] = sdxl_time_ids(BATCH, (RES, RES), (0, 0), (RES, RES))
        return batch
    kw = dict(text_encoder_2=_tower_2())
    if source == "cache-dual":  # both frozen towers' context
        kw.update(text_encoder=port_states[1].model, concat_count=CONCAT, penultimate=True)
    if source == "cache-refiner":
        kw.update(aesthetic_score=6.0)
    cache_batches_to_dir([batch], port_states[4].call, str(tmp_path / source), **kw)
    loader = CachedLatentLoader(str(tmp_path / source))
    loader.dispatch_worker()
    return loader.grab_next_batch()


def _zero_grad_leaves(unet):
    """The ``time_emb_proj`` kernels whose exact grad is 0: those of resnets
    whose second GroupNorm has one channel per group (its mean subtraction
    removes the time embedding, a per-channel constant)."""
    return {
        f"{name}.time_emb_proj.weight" for name, module in unet.named_modules()
        if hasattr(module, "time_emb_proj") and module.norm2.num_groups == module.norm2.num_channels
    }


def _draws(sample_rng, b):
    """One micro-batch's draws from its ``sample`` key, as the JAX step makes
    them (the VAE eps NHWC, transposed)."""
    eps = jax.random.normal(sample_rng, (b, LATENT, LATENT, 4), dtype=jnp.float32)
    offset_rng, noise_rng, perturb_rng, t_rng = jax.random.split(key=sample_rng, num=4)
    draws = {
        "latent_eps": np.asarray(eps).transpose(0, 3, 1, 2),
        "noise": np.asarray(jax.random.normal(noise_rng, (b, 4, LATENT, LATENT))),
        "noise_offset": np.asarray(jax.random.normal(offset_rng, (b, 4, 1, 1))),
        "perturb_noise": np.asarray(jax.random.normal(perturb_rng, (b, 4, LATENT, LATENT))),
        "timesteps": np.asarray(jax.random.randint(t_rng, (b,), 0, 1000)),
    }
    return {k: torch.tensor(v) for k, v in draws.items()}


def _jax_draws(accum):
    _, sample_rng, _ = jax.random.split(RNG, num=3)
    if accum == 1:
        return _draws(sample_rng, BATCH)
    return [_draws(key, BATCH // accum) for key in jax.random.split(sample_rng, accum)]


@pytest.mark.parametrize("case", CASES_BY_FILE["sdxl_train"])
def test_micro_conditioned_step_matches_jax(case, tmp_path):
    check_micro_conditioned_step(case, tmp_path)


def check_micro_conditioned_step(case, tmp_path):
    """One case's step against the JAX step's, and the add-embedding moved
    on both sides."""
    cfg = _sdxl_config(TrainingConfig, case)
    jax_states = jax_training_state(_sdxl_config(JaxTrainingConfig, case))
    states = on_device_model_training_state(cfg, device="cpu")
    _load_jax_state(states, jax_states, cfg.train_text_encoder)
    before = {
        key: {k: v.detach().clone() for k, v in s.params.items()}
        for key, s in (("unet", states[0]), ("text_encoder", states[1]))
    }
    batch = _batch(CASES[case][2], states, tmp_path)
    assert ("latent_moments" in batch) == cfg.use_latent_cache
    assert ("encoder_hidden_states" in batch) == cfg.cached_text_context
    assert batch["time_ids"].shape == (BATCH, cfg.sdxl_time_ids_count)
    options = dict(strip_bos_eos_token=True, ema_rate=0.999, grad_accumulation_steps=cfg.grad_accumulation_steps,
                   train_text_encoder=cfg.train_text_encoder)

    step = jax.jit(jax_train_step, static_argnames=STATICS)
    j_out = step(*jax_states[:4], {k: jnp.asarray(v) for k, v in batch.items()}, RNG, jax_states[4],
                 jax_states[5], **options)
    out = train_step(*states[:4], {k: torch.tensor(v) for k, v in batch.items()}, None, states[4], states[5],
                     draws=_jax_draws(cfg.grad_accumulation_steps), **options)
    assert_step_matches_jax(out, j_out, before, cfg.train_text_encoder, noise_code=15,
                            noise_leaves=_zero_grad_leaves(states[0].model))

    # the micro-conditioning trained: the add-embedding moved on both sides
    j_prev = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, jax_states[0].params))
    j_after = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, j_out[0].params))
    add = [name for name in before["unet"] if name.startswith("add_embedding.")]
    assert len(add) == 4
    for name in add:
        assert not torch.equal(out[0].params[name], before["unet"][name]), name
        assert not torch.equal(j_after[name], j_prev[name]), name


def test_latent_cache_buckets_key_by_moments_shape():
    """``bucket_train_steps`` keys each latent-cache bucket by its moments'
    shape: SDXL's 1024 tier (the SDXL VAE downsamples 8 times, 4 latent
    channels) holds 1024x1024 as 128x128 and 1152x896 as 144x112; a batch
    from either dispatches to its step, and a pixel batch does not."""
    from stable_diffusion_training_tpu.data.buckets import calculate_resolution_array as jax_buckets
    from stable_diffusion_training_tpu_torch.train import batch_dispatch_key

    cfg = _sdxl_config(TrainingConfig, "cached-dual-context").replace(
        image_area_root=[1024], minimum_axis_length=[512], batch_size=4)
    vae = AutoencoderKL(**configs.SDXL_VAE, device="meta")
    steps = bucket_train_steps(cfg, FrozenModel(call=vae, params=None))
    expected = {(4, 8, int(h) // 8, int(w) // 8) for h, w in jax_buckets(1024**2, 512, 64)}
    assert set(steps) == expected
    assert {(4, 8, 128, 128), (4, 8, 144, 112), (4, 8, 112, 144)} <= set(steps)
    for hw in ((128, 128), (144, 112)):
        assert batch_dispatch_key({"latent_moments": np.zeros((4, 8, *hw), np.float32)}) in steps
    assert batch_dispatch_key({"pixel_values": np.zeros((4, 3, 1152, 896), np.float32)}) not in steps


def test_trainer_trains_sdxl_from_the_latent_cache(tmp_path):
    """``trainer.main`` on ``tiny_sdxl`` over a ``CachedLatentLoader`` (the
    moments, tower 2's pooled embeds and the time ids; tower 1 frozen and
    encoded in the step): finite ``loss.csv`` rows, and the chunk's ``unet/``
    (with its ``add_embedding``) reads in the JAX package's ``hf_io`` equal
    to the port's saved params, bit for bit, and to the trained state's."""
    cfg, path = make_config_dict(
        tmp_path, "sdxl", model_family="tiny_sdxl", chunk_limit=1, use_latent_cache=True,
        sdxl_micro_conditioning=True, train_text_encoder=False,
    )
    pixels = InMemoryDataLoader.synthetic(2, BATCH, [(RES, RES)], concat_count=CONCAT, vocab_size=1000, seed=0)
    vae = random_init_(AutoencoderKL(**configs.TINY_VAE, device="cpu"), torch.Generator().manual_seed(0))
    loader = precompute_latent_cache(pixels, vae, str(tmp_path / "cache"), text_encoder_2=_tower_2())
    trainer.main(path, dataloader=loader, tokenizer=None, device="cpu")

    with open(cfg["loss_csv"]) as f:
        rows = [line.split(",") for line in f.read().splitlines()[1:] if line]
    assert len(rows) == 2 and all(np.isfinite(float(r[2])) for r in rows)
    ckpt = str(tmp_path / "sdxl" / "run") + "@0"
    with open(os.path.join(ckpt, "unet", "config.json")) as f:
        assert json.load(f)["addition_embed_type"] == "text_time"
    got = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, jax_hf_io.load_unet_params(f"{ckpt}/unet")))
    want = load_safetensors(f"{ckpt}/unet/diffusion_pytorch_model.safetensors")
    assert got.keys() == want.keys() and any(k.startswith("add_embedding.") for k in got)
    saved = load_safetensors(f"{ckpt}/{trainer.TRAIN_STATE_SUBDIR}/unet_state.safetensors")
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(want[k], saved[f"unet_state/params/{k}"]), k
