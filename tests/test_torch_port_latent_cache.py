"""The port's offline latent cache (``data/latent_cache.py``) against the JAX
package's, on the CPU in f32.

The tiny VAE, tower 1 (``TINY_CLIP``) and tower 2 (``TINY_CLIP_PROJ``) are
initialised by the JAX package and cross into the port through
``jax_params_to_state_dict`` under ``load_state_dict(strict=True)``; pixels
and ids are made with numpy from a seed. Each function is held to its JAX
counterpart at atol 1e-5 (the models' bar, ``tests/test_torch_port_models.py``:
both sides compute the same f32 forward, summing in other orders); the time
ids, which are arithmetic on integers, exactly; the errors with the JAX
package's messages. Shards written by either package are read by the other's
``CachedLatentLoader``, key for key, with the same dtypes and shapes and
bitwise the arrays the writer saved.
"""

import types

import jax
import numpy as np
import pytest
import torch

from stable_diffusion_training_tpu.data import latent_cache as jax_cache
from stable_diffusion_training_tpu.models import (
    AutoencoderKL as JaxVAE,
    CLIPTextModel as JaxCLIP,
    CLIPTextModelWithProjection as JaxCLIPProj,
    configs as jax_configs,
)
from stable_diffusion_training_tpu_torch.data import InMemoryDataLoader
from stable_diffusion_training_tpu_torch.data import latent_cache as cache
from stable_diffusion_training_tpu_torch.models import (
    AutoencoderKL,
    CLIPTextModel,
    CLIPTextModelWithProjection,
    configs,
)
from stable_diffusion_training_tpu_torch.models.hf_io import jax_params_to_state_dict
from torch_threads import _one_thread  # noqa: F401 (the fixture)

ATOL = 1e-5
CONCAT, WIN = 3, 77


def _port(cls, config, params):
    model = cls(**config, device="cpu")
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def models():
    """``{name: (jax module, jax params, port module)}`` for the VAE and both
    towers, the JAX VAE in the NHWC layout its trainer uses."""
    vae = JaxVAE(**jax_configs.TINY_VAE, data_format="NHWC")
    te1 = JaxCLIP(**jax_configs.TINY_CLIP)
    te2 = JaxCLIPProj(**jax_configs.TINY_CLIP_PROJ)
    params = [m.init(jax.random.PRNGKey(i)) for i, m in enumerate((vae, te1, te2))]
    return {
        "vae": (vae, params[0], _port(AutoencoderKL, configs.TINY_VAE, params[0])),
        "te1": (te1, params[1], _port(CLIPTextModel, configs.TINY_CLIP, params[1])),
        "te2": (te2, params[2], _port(CLIPTextModelWithProjection, configs.TINY_CLIP_PROJ, params[2])),
    }


def _ids(rows, seed=0):
    return np.random.default_rng(seed).integers(0, 1000, (rows, WIN)).astype(np.int32)


def _pixels(batch, res, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (batch, 3, res, res)).astype(np.float32)


@pytest.mark.parametrize(
    "chunk,batch,res",
    [(0, 3, 64), (None, 3, 64), (1, 3, 64), (2, 3, 64), (3, 3, 64)],
    ids=["default-whole", "none", "per-sample", "not-dividing", "whole"],
)
def test_moments_match_jax(models, chunk, batch, res):
    """NCHW ``[mean, logvar]`` at every chunk setting (a chunk that does not
    divide the batch encodes it whole)."""
    jax_vae, params, vae = models["vae"]
    px = _pixels(batch, res)
    want = jax_cache.encode_batch_to_moments(jax_vae, params, px, chunk=chunk)
    got = cache.encode_batch_to_moments(vae, px, chunk=chunk)
    assert got.shape == want.shape == (batch, 8, res // 2, res // 2) and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


class _CountingVAE(torch.nn.Module):
    """A stand-in VAE that records the batch of each encode call (the tiny
    VAE's mid-block attention at 768 px would take tens of GB)."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(()))
        self.calls = []

    def encode(self, x):
        self.calls.append(x.shape[0])
        moments = x[:, :2, ::8, ::8] * self.w
        return types.SimpleNamespace(latent_dist=types.SimpleNamespace(mean=moments[:, :1], logvar=moments[:, 1:]))


@pytest.mark.parametrize(
    "chunk,batch,res,calls",
    [(0, 3, 64, [3]), (0, 2, 768, [1, 1]), (0, 2, 1024, [1, 1]), (0, 4, 768, [1, 1, 1, 1]),
     (2, 4, 768, [2, 2]), (3, 4, 1024, [4]), (None, 2, 1024, [2])],
    ids=["small-whole", "768-per-sample", "1024-per-sample", "768-batch-4", "given-2", "not-dividing", "none"],
)
def test_moments_chunk_rule_is_the_jax_packages(chunk, batch, res, calls):
    """``chunk=0`` encodes per sample at a spatial size >= 768 and the whole
    batch below; a given chunk that does not divide the batch encodes it
    whole (the JAX package's rule, whose ``lax.map`` runs ``batch / chunk``
    encodes of ``chunk`` samples)."""
    vae = _CountingVAE()
    px = _pixels(batch, res)
    out = cache.encode_batch_to_moments(vae, px, chunk=chunk)
    assert vae.calls == calls
    np.testing.assert_array_equal(out, np.concatenate([px[:, :1, ::8, ::8], px[:, 1:2, ::8, ::8]], axis=1))


@pytest.mark.parametrize(
    "args,kw",
    [(((1024, 1024), (0, 0), (1024, 1024)), {}),
     (((1152, 896), (16, 8), (1152, 896)), {}),
     (((1024, 768), (0, 0), (1024, 768)), dict(aesthetic_score=6.0)),
     (((896, 1152), (4, 0), (896, 1152)), dict(aesthetic_score=2.5))],
    ids=["base", "base-crop", "refiner", "refiner-low-score"],
)
def test_sdxl_time_ids_match_jax(args, kw):
    got, want = cache.sdxl_time_ids(3, *args, **kw), jax_cache.sdxl_time_ids(3, *args, **kw)
    assert got.dtype == want.dtype == np.float32 and got.shape == (3, 5 if kw else 6)
    np.testing.assert_array_equal(got, want)


def _jax_context(models, ids, towers, **kw):
    te1, p1, _ = models["te1"]
    extra = dict(text_encoder_2=models["te2"][0], te2_params=models["te2"][1]) if towers == 2 else {}
    return jax_cache.compute_encoder_hidden_states(te1, p1, ids, **extra, **kw)


def _port_context(models, ids, towers, **kw):
    extra = dict(text_encoder_2=models["te2"][2]) if towers == 2 else {}
    return cache.compute_encoder_hidden_states(models["te1"][2], ids, **extra, **kw)


CONTEXT_CASES = {
    "one-tower": (1, {}),
    "one-tower-penultimate": (1, dict(penultimate=True)),
    "one-tower-no-strip": (1, dict(strip_bos_eos_token=False)),
    "two-towers": (2, {}),
    "two-towers-penultimate": (2, dict(penultimate=True)),
    "two-towers-ids-2": (2, dict(input_ids_2="separate")),
}


@pytest.mark.parametrize("case", list(CONTEXT_CASES))
@pytest.mark.parametrize("layout", ["rows", "flat", "nested"])
def test_context_matches_jax(models, case, layout):
    """The cross-attention context, one tower or both (feature concat after
    the window strip), in each id layout: ``(B * concat, win)``, ``(B,
    concat * win)`` and ``(B, concat, win)``."""
    towers, kw = CONTEXT_CASES[case]
    kw = dict(kw)
    ids = _ids(2 * CONCAT)
    if kw.get("input_ids_2") == "separate":
        kw["input_ids_2"] = _ids(2 * CONCAT, seed=1)
    shaped = {"rows": ids, "flat": ids.reshape(2, -1), "nested": ids.reshape(2, CONCAT, WIN)}[layout]
    want = _jax_context(models, shaped, towers, concat_count=CONCAT, **kw)
    got = _port_context(models, shaped, towers, concat_count=CONCAT, **kw)
    tokens = WIN * CONCAT if kw.get("strip_bos_eos_token") is False else (WIN - 2) * CONCAT + 2
    assert got.shape == want.shape == (2, tokens, 32 * towers)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if "ids-2" in case:  # tower 2 read its own ids; tower 1's half is unchanged
        same = _port_context(models, shaped, towers, concat_count=CONCAT)
        np.testing.assert_array_equal(got[..., :32], same[..., :32])
        assert not np.allclose(got[..., 32:], same[..., 32:])


@pytest.mark.parametrize("layout", ["first-window", "flat", "nested"])
def test_pooled_text_embeds_match_jax(models, layout):
    """Tower 2's pooled, projected embeds from each sample's first window:
    ``(B, win)``, ``(B, concat * win)`` and ``(B, concat, win)``."""
    jax_te2, p2, te2 = models["te2"]
    ids = _ids(2 * CONCAT).reshape(2, CONCAT, WIN)
    shaped = {"first-window": ids[:, 0], "flat": ids.reshape(2, -1), "nested": ids}[layout]
    want = jax_cache.compute_pooled_text_embeds(jax_te2, p2, shaped)
    got = cache.compute_pooled_text_embeds(te2, shaped)
    assert got.shape == want.shape == (2, 16)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, cache.compute_pooled_text_embeds(te2, ids[:, 0]), atol=0, rtol=0)


def test_errors_match_jax(models):
    """Ids that do not group into ``concat_count`` windows, and a width that
    is no multiple of the window: the JAX package's errors."""
    te1, p1, port_te1 = models["te1"]
    jax_te2, p2, te2 = models["te2"]
    ids = _ids(5)
    for jax_call, port_call in (
        (lambda: jax_cache.compute_encoder_hidden_states(te1, p1, ids, concat_count=CONCAT),
         lambda: cache.compute_encoder_hidden_states(port_te1, ids, concat_count=CONCAT)),
        (lambda: jax_cache.compute_pooled_text_embeds(jax_te2, p2, np.zeros((2, 100), np.int32)),
         lambda: cache.compute_pooled_text_embeds(te2, np.zeros((2, 100), np.int32))),
    ):
        with pytest.raises(ValueError) as jax_error:
            jax_call()
        with pytest.raises(ValueError) as port_error:
            port_call()
        assert str(port_error.value) == str(jax_error.value)


def _batches(seed):
    loader = InMemoryDataLoader.synthetic(2, 2, [(64, 64)], concat_count=CONCAT, vocab_size=1000, seed=seed)
    return _read(loader)


def _read(loader):
    loader.dispatch_worker()
    out = []
    while not isinstance(batch := loader.grab_next_batch(), str):
        out.append(batch)
    return out


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(towers=1), dict(towers=2), dict(towers=2, context=True),
     dict(towers=2, context=True, context_use_tower_2=False, aesthetic_score=6.0)],
    ids=["moments", "pooled", "pooled-refiner-ids", "dual-context", "tower-1-context-refiner"],
)
def test_caches_cross_read(models, tmp_path, kw):
    """``cache_batches_to_dir`` / ``precompute_latent_cache`` in both
    packages over the same batches: the same files, keys, dtypes and shapes;
    each package's ``CachedLatentLoader`` reads the other's shards bitwise
    as written; the two caches agree to ``ATOL``."""
    kw = dict(kw)
    towers, context = kw.pop("towers", 0), kw.pop("context", False)
    if towers == 1:  # the refiner's 5 ids with the pooled embeds alone
        kw["aesthetic_score"] = 2.5
    jax_kw, port_kw = dict(kw), dict(kw)
    if towers:
        jax_kw.update(text_encoder_2=models["te2"][0], te2_params=models["te2"][1])
        port_kw.update(text_encoder_2=models["te2"][2])
    if context:
        jax_kw.update(text_encoder=models["te1"][0], te_params=models["te1"][1], concat_count=CONCAT)
        port_kw.update(text_encoder=models["te1"][2], concat_count=CONCAT)
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_paths = jax_cache.cache_batches_to_dir(_batches(3), models["vae"][0], models["vae"][1], jax_dir, **jax_kw)
    port_loader = cache.precompute_latent_cache(
        InMemoryDataLoader(_batches(3)), models["vae"][2], port_dir, **port_kw
    )
    assert [p.split("/")[-1] for p in jax_paths] == ["latents_000000.npz", "latents_000001.npz"]
    assert port_loader._bulk_batch_count == 2

    jax_written, port_written = _read(jax_cache.CachedLatentLoader(port_dir)), _read(port_loader)
    from_port, from_jax = _read(cache.CachedLatentLoader(jax_dir)), _read(jax_cache.CachedLatentLoader(jax_dir))
    keys = {"latent_moments", "input_ids", "attention_mask"}
    keys |= {"pooled_text_embeds", "time_ids"} if towers else set()
    keys |= {"encoder_hidden_states"} if context else set()
    for port_b, jax_b, a, b in zip(port_written, from_jax, jax_written, from_port):
        assert set(port_b) == set(jax_b) == keys
        for key in keys:
            assert port_b[key].dtype == jax_b[key].dtype and port_b[key].shape == jax_b[key].shape, key
            np.testing.assert_array_equal(a[key], port_b[key])  # JAX's loader, the port's shard
            np.testing.assert_array_equal(b[key], jax_b[key])  # the port's loader, JAX's shard
            np.testing.assert_allclose(port_b[key], jax_b[key], atol=ATOL, rtol=0, err_msg=key)
    if context:
        width = 64 if kw.get("context_use_tower_2", True) else 32
        assert port_written[0]["encoder_hidden_states"].shape == (2, 227, width)
    if towers:
        assert port_written[0]["time_ids"].shape == (2, 5 if "aesthetic_score" in kw else 6)
