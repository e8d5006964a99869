"""The port's SDXL refiner (img2img) against the JAX package's, on the CPU in
f32.

The tiny refiner family: tower 2 alone (32 channels of context, 16 pooled),
the UNet with 5 time ids, the tiny VAE. Both pipelines get the same weights
(``jax_params_to_state_dict``), the same image and ids; the port gets the
JAX pipeline's two draws (``jax.random.split(prng_seed)``: the latent
sample's eps, drawn in the JAX VAE's NHWC layout, then the noise) through
``sample_eps=`` and ``noise=``. Images within 1e-4, the bar of
``tests/test_torch_port_pipeline.py``. A pipeline with a first tower (the
base checkpoint as img2img) is ``tests/test_torch_port_sdxl_refiner_base.py``
(each file runs whole on one worker under ``--dist loadfile``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_diffusion_training_tpu.diffusion import DDIMScheduler as JaxDDIM
from stable_diffusion_training_tpu.models import (
    AutoencoderKL as JaxVAE,
    CLIPTextModel as JaxCLIP,
    CLIPTextModelWithProjection as JaxCLIPProj,
    UNet2DConditionModel as JaxUNet,
    configs as jax_configs,
)
from stable_diffusion_training_tpu.pipeline import (
    StableDiffusionXLImg2ImgPipeline as JaxRefiner,
    prepare_image as jax_prepare_image,
)
from stable_diffusion_training_tpu_torch.diffusion import DDIMScheduler
from stable_diffusion_training_tpu_torch.models import (
    AutoencoderKL,
    CLIPTextModel,
    CLIPTextModelWithProjection,
    UNet2DConditionModel,
    configs,
)
from stable_diffusion_training_tpu_torch.models.hf_io import jax_params_to_state_dict
from stable_diffusion_training_tpu_torch.pipeline import StableDiffusionXLImg2ImgPipeline, prepare_image
from torch_threads import _one_thread  # noqa: F401 (the fixture)

IMAGE_TOL = 1e-4
SCHEDULER = dict(beta_start=0.00085, beta_end=0.012, beta_schedule="scaled_linear",
                 num_train_timesteps=1000, prediction_type="v_prediction")
GEN_KW = dict(strength=0.5, num_inference_steps=4, guidance_scale=4.0)
TE2 = dict(configs.TINY_CLIP_PROJ, eos_token_id=2)
# a base-style checkpoint driven as img2img: both towers, the base's 6 ids
DUAL_UNET = configs.MODEL_FAMILIES["tiny_sdxl_dual"]["unet"]


def _port(cls, config, params):
    model = cls(**config, device="cpu")
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return model.eval()


def _build(with_tower_1):
    rng = jax.random.PRNGKey(0)
    unet_cfg = DUAL_UNET if with_tower_1 else configs.TINY_SDXL_REFINER_UNET
    nhwc = dict(data_format="NHWC")
    unet = JaxUNet(**unet_cfg, **nhwc)
    vae = JaxVAE(**jax_configs.TINY_VAE, **nhwc)
    te1 = JaxCLIP(**jax_configs.TINY_CLIP) if with_tower_1 else None
    te2 = JaxCLIPProj(**TE2)
    scheduler = JaxDDIM(**SCHEDULER)
    params = {
        "unet": unet.init(rng, batch_size=1, height=8, width=8),
        "vae": vae.init(rng),
        "text_encoder_2": te2.init(jax.random.PRNGKey(2)),
        "scheduler": scheduler.create_state(),
    }
    if with_tower_1:
        params["text_encoder"] = te1.init(jax.random.PRNGKey(1))
    jax_pipe = JaxRefiner(None, None, te1, te2, vae, unet, scheduler,
                          requires_aesthetics_score=not with_tower_1)
    pipe = StableDiffusionXLImg2ImgPipeline(
        _port(CLIPTextModel, configs.TINY_CLIP, params["text_encoder"]) if with_tower_1 else None,
        _port(CLIPTextModelWithProjection, TE2, params["text_encoder_2"]),
        _port(AutoencoderKL, configs.TINY_VAE, params["vae"]),
        _port(UNet2DConditionModel, unet_cfg, params["unet"]),
        DDIMScheduler(**SCHEDULER),
        requires_aesthetics_score=not with_tower_1,
    )
    return jax_pipe, params, pipe


@pytest.fixture(scope="module")
def refiner():
    return _build(with_tower_1=False)


def _inputs(batch=2, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 1000, (batch, 77))
    neg = rng.integers(3, 1000, (batch, 77))
    image = rng.uniform(-1, 1, (batch, 3, 32, 32)).astype(np.float32)
    return ids, neg, image


def _jax_draws(seed, batch, latent_hw=16):
    """The JAX pipeline's two draws for ``PRNGKey(seed)``: the latent
    sample's eps (NHWC there, NCHW here) and the noise (NCHW)."""
    sample_rng, noise_rng = jax.random.split(jax.random.PRNGKey(seed))
    eps = jax.random.normal(sample_rng, (batch, latent_hw, latent_hw, 4), dtype=jnp.float32)
    noise = jax.random.normal(noise_rng, (batch, 4, latent_hw, latent_hw), dtype=jnp.float32)
    return torch.tensor(np.asarray(eps).transpose(0, 3, 1, 2)), torch.tensor(np.asarray(noise))


def _both(jax_pipe, params, pipe, ids, neg, image, seed=1, **kw):
    kw = {**GEN_KW, **kw}
    want = jax_pipe(jnp.asarray(ids), jnp.asarray(image), params, jax.random.PRNGKey(seed),
                    neg_prompt_ids=jnp.asarray(neg), **kw)["images"]
    eps, noise = _jax_draws(seed, ids.shape[0])
    out = pipe(torch.tensor(ids), torch.tensor(image), neg_prompt_ids=torch.tensor(neg),
               sample_eps=eps, noise=noise, **kw)
    assert out["nsfw_content_detected"] is False
    return out["images"].numpy(), np.asarray(want)


@pytest.mark.parametrize("score", [6.0, 1.0])
def test_tiny_refiner_matches_jax(refiner, score):
    """Strength 0.5 at 4 steps: the image encoded, sampled with JAX's eps,
    noised with JAX's noise to ``timesteps[2]``, two CFG steps on tower 2's
    conditioning and 5 time ids, decoded."""
    jax_pipe, params, pipe = refiner
    ids, neg, image = _inputs()
    got, want = _both(jax_pipe, params, pipe, ids, neg, image, aesthetic_score=score)
    assert got.shape == (2, 32, 32, 3) and got.dtype == np.float32
    assert got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, want, atol=IMAGE_TOL, rtol=0)


def test_seeded_draws_are_reproducible(refiner):
    _, _, pipe = refiner
    ids, neg, image = _inputs(batch=1, seed=5)
    kw = dict(neg_prompt_ids=torch.tensor(neg), **GEN_KW)
    a, b, c = (pipe(torch.tensor(ids), torch.tensor(image), generator=torch.Generator().manual_seed(s),
                    **kw)["images"] for s in (7, 7, 8))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.allclose(a, c) and bool(torch.isfinite(a).all())


@pytest.mark.parametrize("requires_aesthetics_score", [True, False])
def test_time_ids_layout_matches_jax(refiner, requires_aesthetics_score):
    """``[h, w, crop_t, crop_l, score]`` with the negative score on the
    negative half, or the base's 6 ids."""
    jax_pipe, _, pipe = refiner
    jax_pipe.requires_aesthetics_score = pipe.requires_aesthetics_score = requires_aesthetics_score
    try:
        got = pipe._time_ids(3, 1024, 512, (8, 16), 6.5, 2.0)
        want = jax_pipe._time_ids(3, 1024, 512, (8, 16), 6.5, 2.0)
    finally:
        jax_pipe.requires_aesthetics_score = pipe.requires_aesthetics_score = True
    assert got.shape == (6, 5 if requires_aesthetics_score else 6) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("strength,steps", [(0.0, 4), (1.5, 4), (-0.1, 4), (0.2, 4), (0.01, 50)])
def test_strength_errors_are_the_jax_packages(refiner, strength, steps):
    jax_pipe, params, pipe = refiner
    ids, neg, image = _inputs(batch=1)
    with pytest.raises(ValueError) as jax_err:
        jax_pipe(jnp.asarray(ids), jnp.asarray(image), params, jax.random.PRNGKey(0),
                 strength=strength, num_inference_steps=steps, neg_prompt_ids=jnp.asarray(neg))
    with pytest.raises(ValueError) as err:
        pipe(torch.tensor(ids), torch.tensor(image), strength=strength, num_inference_steps=steps,
             neg_prompt_ids=torch.tensor(neg))
    assert str(err.value) == str(jax_err.value)


def test_prepare_image_matches_jax():
    u8 = (np.arange(2 * 8 * 8 * 3) % 256).astype(np.uint8).reshape(2, 8, 8, 3)
    f = np.random.default_rng(6).uniform(0, 1, (8, 8, 3)).astype(np.float32)  # one HWC image
    for arr in (u8, f):
        got = prepare_image(arr)
        assert got.dtype == torch.float32 and got.shape[1] == 3
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_prepare_image(arr)))


def test_refiner_needs_negative_ids_without_a_tokenizer(refiner):
    _, _, pipe = refiner
    ids, _, image = _inputs(batch=1)
    with pytest.raises(ValueError, match="neg_prompt_ids"):
        pipe(torch.tensor(ids), torch.tensor(image), **GEN_KW)


def test_checkpoints_round_trip_both_ways(refiner, tmp_path):
    """The JAX refiner's directory (no ``text_encoder/``) loads into the
    port, and the port's into the JAX refiner; images agree each way."""
    jax_pipe, params, pipe = refiner
    jax_pipe.save_pretrained(str(tmp_path / "jax"), params)
    loaded = StableDiffusionXLImg2ImgPipeline.from_pretrained(str(tmp_path / "jax"), device="cpu")
    assert loaded.text_encoder is None and loaded.requires_aesthetics_score
    ids, neg, image = _inputs(seed=8)
    got, want = _both(jax_pipe, params, loaded, ids, neg, image, seed=9)
    np.testing.assert_allclose(got, want, atol=IMAGE_TOL, rtol=0)

    pipe.save_pretrained(str(tmp_path / "port"))
    assert not (tmp_path / "port" / "text_encoder").exists()
    jax_loaded, jax_params = JaxRefiner.from_pretrained(str(tmp_path / "port"))
    assert jax_loaded.text_encoder is None and jax_loaded.requires_aesthetics_score
    got, want = _both(jax_loaded, jax_params, pipe, ids, neg, image, seed=9)
    np.testing.assert_allclose(got, want, atol=IMAGE_TOL, rtol=0)


def test_from_pretrained_needs_cuda_or_an_explicit_cpu(refiner, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the card is present: the default device is valid")
    _, _, pipe = refiner
    pipe.save_pretrained(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StableDiffusionXLImg2ImgPipeline.from_pretrained(str(tmp_path))
