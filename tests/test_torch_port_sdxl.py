"""The port's SDXL pieces against the JAX package's, on the CPU in f32.

The SDXL text-to-image pipeline, end to end, with checkpoints read and
written both ways; its pieces, SDXL's second text encoder
(``CLIPTextModelWithProjection``), the UNet's ``text_time``
micro-conditioning (the base's 6 time ids and the refiner's 5) and
``DDIMScheduler.add_noise``, are ``tests/test_torch_port_sdxl_unet.py``
(each file runs whole on one worker under ``--dist loadfile``). Weights come from the JAX
side's ``init`` and cross through ``jax_params_to_state_dict`` under
``load_state_dict(strict=True)``; inputs are made with numpy from a seed.

Tolerances: models atol 1e-5 (the bar of ``tests/test_torch_port_models.py``);
images 1e-4 (the bar of ``tests/test_torch_port_pipeline.py``: three CFG
steps at guidance 4 and the VAE decode amplify the models' ~1e-6).
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
from stable_diffusion_training_tpu.pipeline import StableDiffusionXLPipeline as JaxSDXLPipeline
from stable_diffusion_training_tpu_torch.diffusion import DDIMScheduler
from stable_diffusion_training_tpu_torch.models import (
    AutoencoderKL,
    CLIPTextModel,
    CLIPTextModelWithProjection,
    UNet2DConditionModel,
    configs,
)
from stable_diffusion_training_tpu_torch.models.hf_io import jax_params_to_state_dict
from stable_diffusion_training_tpu_torch.ops import flash_attention as fa
from stable_diffusion_training_tpu_torch.pipeline import StableDiffusionXLPipeline
from torch_threads import _one_thread  # noqa: F401 (the fixture)

ATOL = 1e-5
IMAGE_TOL = 1e-4
SCHEDULER = dict(beta_start=0.00085, beta_end=0.012, beta_schedule="scaled_linear",
                 num_train_timesteps=1000, prediction_type="v_prediction")
GEN_KW = dict(num_inference_steps=3, height=32, width=32, guidance_scale=4.0)
# SDXL's text_encoder_2 config pools at the argmax of the ids (eos_token_id 2)
TE2 = dict(configs.TINY_CLIP_PROJ, eos_token_id=2)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _port(cls, config, params, **kw):
    model = cls(**config, device="cpu", **kw)
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def pipelines():
    """The tiny dual-tower family (context 32 + 32 = the UNet's 64, pooled
    16): the JAX pipeline with NHWC models, the port's on the same weights."""
    family = configs.MODEL_FAMILIES["tiny_sdxl_dual"]
    rng = jax.random.PRNGKey(0)
    nhwc = dict(data_format="NHWC")
    unet = JaxUNet(**family["unet"], **nhwc)
    vae = JaxVAE(**jax_configs.TINY_VAE, **nhwc)
    te1 = JaxCLIP(**jax_configs.TINY_CLIP)
    te2 = JaxCLIPProj(**TE2)
    scheduler = JaxDDIM(**SCHEDULER)
    params = {
        "unet": unet.init(rng, batch_size=1, height=8, width=8),
        "vae": vae.init(rng),
        "text_encoder": te1.init(jax.random.PRNGKey(1)),
        "text_encoder_2": te2.init(jax.random.PRNGKey(2)),
        "scheduler": scheduler.create_state(),
    }
    jax_pipe = JaxSDXLPipeline(None, None, te1, te2, vae, unet, scheduler)
    pipe = StableDiffusionXLPipeline(
        _port(CLIPTextModel, family["text_encoder"], params["text_encoder"]),
        _port(CLIPTextModelWithProjection, TE2, params["text_encoder_2"]),
        _port(AutoencoderKL, family["vae"], params["vae"]),
        _port(UNet2DConditionModel, family["unet"], params["unet"]),
        DDIMScheduler(**SCHEDULER),
    )
    return jax_pipe, params, pipe


def _inputs(batch=2, seed=0):
    rng = np.random.default_rng(seed)
    ids = [rng.integers(3, 1000, (batch, 77)) for _ in range(4)]  # prompt, negative, prompt 2, negative 2
    return ids, rng.standard_normal((batch, 4, 16, 16)).astype(np.float32)


def _jax_images(jax_pipe, params, ids, latents, **kw):
    names = ("neg_prompt_ids", "prompt_2_ids", "neg_prompt_2_ids")
    out = jax_pipe(jnp.asarray(ids[0]), params, jax.random.PRNGKey(1), latents=jnp.asarray(latents),
                   **{n: jnp.asarray(i) for n, i in zip(names, ids[1:]) if i is not None}, **GEN_KW, **kw)
    return np.asarray(out["images"])


def _port_images(pipe, ids, latents, **kw):
    names = ("neg_prompt_ids", "prompt_2_ids", "neg_prompt_2_ids")
    out = pipe(torch.tensor(ids[0]), latents=torch.tensor(latents),
               **{n: torch.tensor(i) for n, i in zip(names, ids[1:]) if i is not None}, **GEN_KW, **kw)
    assert out["nsfw_content_detected"] is False
    return out["images"].numpy()


@pytest.mark.parametrize("second_prompts", [True, False], ids=["four-prompts", "defaults"])
def test_tiny_sdxl_pipeline_matches_jax(pipelines, second_prompts):
    """The same latents and ids for both prompts and both negatives; or
    only the first pair, the second defaulting to it on both sides."""
    jax_pipe, params, pipe = pipelines
    ids, latents = _inputs()
    if not second_prompts:
        ids[2] = ids[3] = None
    fa.reset_launch_counts()
    got = _port_images(pipe, ids, latents)
    assert fa.flash_attention_fwd.launches == 0  # CPU tensors: the plain path
    assert got.shape == (2, 32, 32, 3) and got.dtype == np.float32
    assert got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, _jax_images(jax_pipe, params, ids, latents), atol=IMAGE_TOL, rtol=0)


def test_sdxl_pipeline_pieces(pipelines):
    """The CFG order ``[negative, text]``, the 2048-style channel concat of
    both towers' penultimate layers, tower 2's pooled embedding, and the
    ``(2B, 6)`` time ids against the JAX pipeline's."""
    jax_pipe, params, pipe = pipelines
    ids, _ = _inputs(seed=1)
    context, pooled = pipe.encode_prompt(*(torch.tensor(i) for i in ids))
    j_text = jax_pipe._encode_prompt_pair(jnp.asarray(ids[0]), jnp.asarray(ids[2]), params)
    j_neg = jax_pipe._encode_prompt_pair(jnp.asarray(ids[1]), jnp.asarray(ids[3]), params)
    assert context.shape == (4, 77, 64) and pooled.shape == (4, 16)
    np.testing.assert_allclose(context.numpy(), np.concatenate([j_neg[0], j_text[0]]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(pooled.numpy(), np.concatenate([j_neg[1], j_text[1]]), atol=ATOL, rtol=0)
    time_ids = pipe._time_ids(2, 1024, 768, (16, 8))
    assert time_ids.dtype == torch.float32
    np.testing.assert_array_equal(time_ids.numpy(), np.tile([[1024, 768, 16, 8, 1024, 768]], (4, 1)))


def test_sdxl_pipeline_needs_negative_ids_without_a_tokenizer(pipelines):
    _, _, pipe = pipelines
    ids, latents = _inputs(batch=1)
    with pytest.raises(ValueError, match="neg_prompt_ids"):
        pipe(torch.tensor(ids[0]), latents=torch.tensor(latents), **GEN_KW)


def test_from_pretrained_reads_a_jax_sdxl_checkpoint(pipelines, tmp_path):
    """A directory the JAX pipeline's ``save_pretrained`` wrote loads into
    the port and gives the same images as the port built in memory."""
    jax_pipe, params, pipe = pipelines
    jax_pipe.save_pretrained(str(tmp_path), params)
    loaded = StableDiffusionXLPipeline.from_pretrained(str(tmp_path), device="cpu")
    assert loaded.tokenizer is None and loaded.tokenizer_2 is None
    assert loaded.text_encoder_2.config.eos_token_id == 2
    ids, latents = _inputs(seed=2)
    got = _port_images(loaded, ids, latents)
    np.testing.assert_array_equal(got, _port_images(pipe, ids, latents))
    np.testing.assert_allclose(got, _jax_images(jax_pipe, params, ids, latents), atol=IMAGE_TOL, rtol=0)


def test_jax_reads_the_ports_sdxl_checkpoint(pipelines, tmp_path):
    """The reverse: the port's ``save_pretrained`` directory loads into the
    JAX pipeline (its own key folding included) with the same weights."""
    jax_pipe, params, pipe = pipelines
    pipe.save_pretrained(str(tmp_path))
    for sub in ("unet", "vae", "text_encoder", "text_encoder_2", "scheduler", "model_index.json"):
        assert (tmp_path / sub).exists(), sub
    jax_loaded, jax_params = JaxSDXLPipeline.from_pretrained(str(tmp_path))
    for name in ("unet", "vae", "text_encoder", "text_encoder_2"):
        for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(jax_params[name])[0],
                                     jax.tree_util.tree_flatten_with_path(params[name])[0]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f"{name} {path}")
    ids, latents = _inputs(seed=3)
    np.testing.assert_allclose(_jax_images(jax_loaded, jax_params, ids, latents), _port_images(pipe, ids, latents),
                               atol=IMAGE_TOL, rtol=0)
    again = StableDiffusionXLPipeline.from_pretrained(str(tmp_path), device="cpu")
    for (name, a), b in zip(pipe.unet.state_dict().items(), again.unet.state_dict().values()):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=name)


def test_from_pretrained_needs_cuda_or_an_explicit_cpu(pipelines, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the card is present: the default device is valid")
    _, _, pipe = pipelines
    pipe.save_pretrained(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StableDiffusionXLPipeline.from_pretrained(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CLIPTextModelWithProjection(**configs.TINY_CLIP_PROJ)
