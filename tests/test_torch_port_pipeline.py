"""The port's text-to-image pipeline against the JAX package's, end to end on
the CPU: the tiny model family, the same weights (through
``jax_params_to_state_dict``), the same initial latents and token ids, a few
DDIM steps.

Tolerance 1e-4 on images in [0, 1]: every part agrees to ~1e-6 in f32 (see
the model and scheduler tests), and three CFG steps at guidance 4 plus the
VAE decode amplify that by well under 100x (~4e-6 is seen).
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
    UNet2DConditionModel as JaxUNet,
    configs as jax_configs,
)
from stable_diffusion_training_tpu.pipeline import StableDiffusionPipeline as JaxPipeline
from stable_diffusion_training_tpu_torch.diffusion import DDIMScheduler
from stable_diffusion_training_tpu_torch.models import (
    AutoencoderKL,
    CLIPTextModel,
    UNet2DConditionModel,
    configs,
)
from stable_diffusion_training_tpu_torch.models.hf_io import jax_params_to_state_dict
from stable_diffusion_training_tpu_torch.ops import flash_attention as fa
from stable_diffusion_training_tpu_torch.pipeline import StableDiffusionPipeline
from torch_threads import _one_thread  # noqa: F401 (the fixture)

TOL = 1e-4
# the scheduler the JAX package's checkpoint writer always embeds
SCHEDULER = dict(beta_start=0.00085, beta_end=0.012, beta_schedule="scaled_linear",
                 num_train_timesteps=1000, prediction_type="v_prediction")
GEN_KW = dict(num_inference_steps=3, height=32, width=32, guidance_scale=4.0)


@pytest.fixture(scope="module")
def pipelines():
    rng = jax.random.PRNGKey(0)
    nhwc = dict(data_format="NHWC")
    unet = JaxUNet(**jax_configs.TINY_UNET, **nhwc)
    vae = JaxVAE(**jax_configs.TINY_VAE, **nhwc)
    clip = JaxCLIP(**jax_configs.TINY_CLIP)
    scheduler = JaxDDIM(**SCHEDULER)
    params = {
        "unet": unet.init(rng, batch_size=1, height=8, width=8),
        "vae": vae.init(rng),
        "text_encoder": clip.init(rng),
        "scheduler": scheduler.create_state(),
    }
    jax_pipe = JaxPipeline(None, clip, vae, unet, scheduler)

    def port(cls, cfg, tree):
        model = cls(**cfg, device="cpu")
        model.load_state_dict(jax_params_to_state_dict(tree), strict=True)
        return model.eval()

    pipe = StableDiffusionPipeline(
        port(CLIPTextModel, configs.TINY_CLIP, params["text_encoder"]),
        port(AutoencoderKL, configs.TINY_VAE, params["vae"]),
        port(UNet2DConditionModel, configs.TINY_UNET, params["unet"]),
        DDIMScheduler(**SCHEDULER),
    )
    return jax_pipe, params, pipe


def _inputs(batch=2, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1000, (batch, 77))
    neg = rng.integers(0, 1000, (batch, 77))
    latents = rng.standard_normal((batch, 4, 16, 16)).astype(np.float32)
    return ids, neg, latents


def _jax_images(jax_pipe, params, ids, neg, latents):
    out = jax_pipe(jnp.asarray(ids), params, jax.random.PRNGKey(1), latents=jnp.asarray(latents),
                   neg_prompt_ids=jnp.asarray(neg), **GEN_KW)
    return np.asarray(out["images"])


def _port_images(pipe, ids, neg, latents):
    out = pipe(torch.tensor(ids), latents=torch.tensor(latents), neg_prompt_ids=torch.tensor(neg),
               **GEN_KW)
    assert out["nsfw_content_detected"] is False
    return out["images"].numpy()


def test_tiny_pipeline_matches_jax(pipelines):
    jax_pipe, params, pipe = pipelines
    ids, neg, latents = _inputs()
    fa.reset_launch_counts()
    got = _port_images(pipe, ids, neg, latents)
    assert fa.flash_attention_fwd.launches == 0  # CPU tensors: the plain path
    assert got.shape == (2, 32, 32, 3) and got.dtype == np.float32
    assert got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, _jax_images(jax_pipe, params, ids, neg, latents), atol=TOL, rtol=0)


def test_from_pretrained_reads_a_jax_checkpoint(pipelines, tmp_path):
    """A directory written by the JAX package's ``save_pretrained`` loads into
    the port (safetensors read without the ``safetensors`` package) and gives
    the same images as the port built from the in-memory params."""
    jax_pipe, params, pipe = pipelines
    jax_pipe.save_pretrained(str(tmp_path), params)
    loaded = StableDiffusionPipeline.from_pretrained(str(tmp_path), device="cpu")
    assert loaded.scheduler.config.prediction_type == "v_prediction"
    ids, neg, latents = _inputs(seed=1)
    got = _port_images(loaded, ids, neg, latents)
    np.testing.assert_array_equal(got, _port_images(pipe, ids, neg, latents))
    np.testing.assert_allclose(got, _jax_images(jax_pipe, params, ids, neg, latents), atol=TOL, rtol=0)


def test_jax_reads_the_ports_checkpoint(pipelines, tmp_path):
    """The port's ``save_pretrained`` writes what the JAX package's
    ``from_pretrained`` reads: the same weights, the scheduler as
    configured, the same images."""
    jax_pipe, params, pipe = pipelines
    pipe.save_pretrained(str(tmp_path))
    jax_loaded, jax_params = JaxPipeline.from_pretrained(str(tmp_path))
    assert jax_loaded.scheduler.config.prediction_type == "v_prediction"
    for name in ("unet", "vae", "text_encoder"):
        for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(jax_params[name])[0],
                                     jax.tree_util.tree_flatten_with_path(params[name])[0]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f"{name} {path}")
    ids, neg, latents = _inputs(seed=3)
    np.testing.assert_allclose(_jax_images(jax_loaded, jax_params, ids, neg, latents),
                               _port_images(pipe, ids, neg, latents), atol=TOL, rtol=0)


def test_seeded_noise_is_reproducible(pipelines):
    _, _, pipe = pipelines
    ids, neg, _ = _inputs(batch=1, seed=2)
    kw = dict(neg_prompt_ids=torch.tensor(neg), **GEN_KW)
    a = pipe(torch.tensor(ids), generator=torch.Generator().manual_seed(7), **kw)["images"]
    b = pipe(torch.tensor(ids), generator=torch.Generator().manual_seed(7), **kw)["images"]
    c = pipe(torch.tensor(ids), generator=torch.Generator().manual_seed(8), **kw)["images"]
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.allclose(a, c)
    assert bool(torch.isfinite(a).all())


def test_pipeline_rejects_bad_inputs(pipelines):
    _, _, pipe = pipelines
    ids, neg, _ = _inputs(batch=1)
    with pytest.raises(ValueError, match="neg_prompt_ids"):
        pipe(torch.tensor(ids), **GEN_KW)  # no tokenizer for the empty prompt
    with pytest.raises(ValueError, match="latents shape"):
        pipe(torch.tensor(ids), neg_prompt_ids=torch.tensor(neg),
             latents=torch.zeros(1, 4, 8, 8), **GEN_KW)
    with pytest.raises(ValueError, match="multiples of 8"):
        pipe(torch.tensor(ids), neg_prompt_ids=torch.tensor(neg),
             num_inference_steps=1, height=36, width=32)


def test_from_pretrained_needs_cuda_or_an_explicit_cpu(pipelines, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the card is present: the default device is valid")
    jax_pipe, params, _ = pipelines
    jax_pipe.save_pretrained(str(tmp_path), params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StableDiffusionPipeline.from_pretrained(str(tmp_path))
