"""The port's in-loop eval sampler (``train/eval_sampler.py``) against the
JAX package's, on the CPU in f32.

Both samplers get the same weights (the JAX side's ``init``, crossed with
``jax_params_to_state_dict``), the same prompt ids and the same config;
the port gets the JAX sampler's draws for the step
(``jax.random.fold_in(rng, step)``: the initial latents, or img2img's
eps and noise from its ``split``) through ``maybe_sample``'s seams. SDXL's
tower 2 is read by both from ``model_path/text_encoder_2``, written once.

Tolerance: images within 1e-5 in f32 (``IMAGE_TOL``): two DDIM steps at
guidance 2; the models agree to ~1e-6 (``tests/test_torch_port_models.py``).
The PNGs are 8-bit roundings of those images: at most one level apart.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from stable_diffusion_training_tpu.models import (
    AutoencoderKL as JaxVAE,
    CLIPTextModel as JaxCLIP,
    CLIPTextModelWithProjection as JaxCLIPProj,
    UNet2DConditionModel as JaxUNet,
    configs as jax_configs,
)
from stable_diffusion_training_tpu.train.eval_sampler import EvalSampler as JaxEvalSampler
from stable_diffusion_training_tpu_torch.models import (
    AutoencoderKL,
    CLIPTextModel,
    CLIPTextModelWithProjection,
    UNet2DConditionModel,
    configs,
    hf_io,
)
from stable_diffusion_training_tpu_torch.models.hf_io import jax_params_to_state_dict
from stable_diffusion_training_tpu_torch.train import eval_sampler as port_eval
from stable_diffusion_training_tpu_torch.train.eval_sampler import EvalSampler

IMAGE_TOL = 1e-5
SEED, STEP = 3, 4
EVAL = dict(eval_sample_interval=2, eval_num_inference_steps=2, eval_guidance_scale=2.0,
            eval_sample_resolution=32, beta_scheduler="scaled_linear", prediction_type="v_prediction",
            mixed_precision="float32")


def _port(cls, config, params):
    model = cls(**config, device="cpu")
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return model.train()  # as the trainer holds them: the sampler switches to eval and back


def _ids(batch=2, seed=0):
    return np.random.default_rng(seed).integers(3, 1000, (batch, 77)).tolist()


def _families(name):
    fam = jax_configs.MODEL_FAMILIES[name]
    rng = jax.random.PRNGKey(0)
    nhwc = dict(data_format="NHWC")
    unet, vae = JaxUNet(**fam["unet"], **nhwc), JaxVAE(**fam["vae"], **nhwc)
    te = JaxCLIP(**fam["text_encoder"])
    params = {"unet": unet.init(rng, batch_size=1, height=8, width=8), "vae": vae.init(rng),
              "text_encoder": te.init(jax.random.PRNGKey(1))}
    jax_models = {"unet": unet, "vae": vae, "text_encoder": te}
    port_models = {
        "unet": _port(UNet2DConditionModel, configs.MODEL_FAMILIES[name]["unet"], params["unet"]),
        "vae": _port(AutoencoderKL, configs.MODEL_FAMILIES[name]["vae"], params["vae"]),
        "text_encoder": _port(CLIPTextModel, configs.TINY_CLIP, params["text_encoder"]),
    }
    return jax_models, params, port_models


def _tower_2_dir(tmp_path):
    """``model_path`` holding ``text_encoder_2/`` (tiny, SDXL's argmax
    pooling), written by the port and read by both samplers."""
    cfg = dict(configs.TINY_CLIP_PROJ, eos_token_id=2)
    params = JaxCLIPProj(**jax_configs.TINY_CLIP_PROJ).init(jax.random.PRNGKey(2))
    te2 = CLIPTextModelWithProjection(**cfg, device="cpu")
    te2.load_state_dict(jax_params_to_state_dict(params), strict=True)
    model_dir = tmp_path / "model"
    hf_io.save_text_encoder(te2, str(model_dir / "text_encoder_2"))
    return str(model_dir)


def _jax_images(sampler, params):
    """The JAX sampler's call at STEP and the f32 images it wrote."""
    captured = {}
    to_pil = sampler._pipe.numpy_to_pil

    def capture(arr):
        captured["images"] = np.asarray(arr)
        return to_pil(arr)

    sampler._pipe.numpy_to_pil = capture
    out = sampler.maybe_sample(STEP, params["unet"], params["text_encoder"], params["vae"], jax.random.PRNGKey(SEED))
    return out, captured["images"]


def _port_images(sampler, monkeypatch, **draws):
    captured = {}
    save = port_eval.save_png_images

    def capture(images, directory):
        captured["images"] = np.asarray(images)
        return save(images, directory)

    monkeypatch.setattr(port_eval, "save_png_images", capture)
    out = sampler.maybe_sample(STEP, **draws)
    return out, captured["images"]


def _assert_same(port_out, port_images, jax_out, jax_images, n):
    assert port_images.shape == jax_images.shape == (n, 32, 32, 3)
    np.testing.assert_allclose(port_images, jax_images, atol=IMAGE_TOL, rtol=0)
    assert os.path.basename(port_out) == os.path.basename(jax_out) == f"step_{STEP:08d}"
    for i in range(n):
        with Image.open(os.path.join(port_out, f"sample_{i}.png")) as a, \
                Image.open(os.path.join(jax_out, f"sample_{i}.png")) as b:
            diff = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
            assert a.mode == b.mode == "RGB" and diff.max() <= 1


def _latents(n, hw=16):
    rng = jax.random.fold_in(jax.random.PRNGKey(SEED), STEP)
    return torch.tensor(np.asarray(jax.random.normal(rng, (n, 4, hw, hw), dtype=jnp.float32)))


@pytest.mark.parametrize("family", ["tiny", "tiny_sdxl_dual"])
def test_text_to_image_matches_jax(tmp_path, monkeypatch, family):
    """SD (``tiny``: ``StableDiffusionPipeline``) and SDXL
    (``tiny_sdxl_dual``: both towers, tower 2 eval-only from the checkpoint
    directory, 6 time ids): the same images from the same initial latents,
    the models put back in train mode."""
    jax_models, params, port_models = _families(family)
    model_path = _tower_2_dir(tmp_path) if family != "tiny" else family
    base = dict(EVAL, model_path=model_path, model_family=family, eval_sample_prompt_ids=_ids(), master_seed=SEED)
    jax_sampler = JaxEvalSampler(dict(base, eval_sample_dir=str(tmp_path / "jax")), jax_models, None)
    sampler = EvalSampler(dict(base, eval_sample_dir=str(tmp_path / "port")), port_models, None, device="cpu")
    assert sampler.active and type(sampler._pipe).__name__ == type(jax_sampler._pipe).__name__
    jax_out, jax_images = _jax_images(jax_sampler, params)
    port_out, port_images = _port_images(sampler, monkeypatch, latents=_latents(2))
    _assert_same(port_out, port_images, jax_out, jax_images, 2)
    assert all(m.training for m in port_models.values())
    assert sampler.maybe_sample(STEP + 1) is None  # off the interval


def test_refiner_img2img_matches_jax(tmp_path, monkeypatch):
    """A refiner UNet (5 time ids) with ``eval_sample_images``: the
    images prepared from the PNG, refined at strength 0.5 of 4 steps with
    JAX's eps and noise."""
    fam = jax_configs.MODEL_FAMILIES["tiny_sdxl_refiner"]
    rng = jax.random.PRNGKey(0)
    nhwc = dict(data_format="NHWC")
    unet, vae = JaxUNet(**fam["unet"], **nhwc), JaxVAE(**fam["vae"], **nhwc)
    params = {"unet": unet.init(rng, batch_size=1, height=8, width=8), "vae": vae.init(rng)}
    port_models = {"unet": _port(UNet2DConditionModel, configs.TINY_SDXL_REFINER_UNET, params["unet"]),
                   "vae": _port(AutoencoderKL, configs.TINY_VAE, params["vae"]), "text_encoder": None}
    image = tmp_path / "base.png"
    Image.fromarray(np.random.default_rng(7).integers(0, 256, (40, 40, 3), dtype=np.uint8)).save(image)
    base = dict(EVAL, model_path=_tower_2_dir(tmp_path), model_family="tiny_sdxl_refiner", sdxl_time_ids_count=5,
                eval_sample_images=[str(image)], eval_refine_strength=0.5, eval_num_inference_steps=4,
                eval_sample_prompt_ids=_ids(), master_seed=SEED)
    jax_sampler = JaxEvalSampler(dict(base, eval_sample_dir=str(tmp_path / "jax")),
                                 {"unet": unet, "vae": vae, "text_encoder": None}, None)
    sampler = EvalSampler(dict(base, eval_sample_dir=str(tmp_path / "port")), port_models, None, device="cpu")
    assert sampler._img2img and jax_sampler._img2img
    np.testing.assert_array_equal(sampler._init_image.numpy(), np.asarray(jax_sampler._init_image))
    sample_rng, noise_rng = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(SEED), STEP))
    eps = np.asarray(jax.random.normal(sample_rng, (2, 16, 16, 4), dtype=jnp.float32)).transpose(0, 3, 1, 2)
    noise = np.asarray(jax.random.normal(noise_rng, (2, 4, 16, 16), dtype=jnp.float32))
    jax_params = dict(params, text_encoder=None)
    jax_out, jax_images = _jax_images(jax_sampler, jax_params)
    port_out, port_images = _port_images(sampler, monkeypatch, sample_eps=torch.tensor(eps), noise=torch.tensor(noise))
    _assert_same(port_out, port_images, jax_out, jax_images, 2)


def test_disabled_for_a_refiner_without_images():
    """As ``tests/test_sdxl_e2e.py`` checks the JAX sampler: a refiner UNet
    and no ``eval_sample_images`` turns sampling off (there is no
    text-to-image path) instead of failing mid-run."""
    unet = UNet2DConditionModel(**configs.TINY_SDXL_REFINER_UNET, device="cpu")
    sampler = EvalSampler(
        {"eval_sample_interval": 2, "eval_sample_prompt_ids": [[1] * 77], "model_path": "tiny_sdxl_refiner",
         "model_family": "tiny_sdxl_refiner", "sdxl_time_ids_count": 5},
        {"unet": unet, "vae": None, "text_encoder": None}, tokenizer=None, device="cpu",
    )
    assert not sampler.active and sampler.maybe_sample(2) is None


def test_pngs_draws_and_scalar(tmp_path):
    """Without injected latents the draws come from the run's seed and the
    step: the same step repeats its images, another step differs. PNGs land
    under ``step_<N>/`` and the mean goes to ``eval/sample_mean``."""

    class Writer:
        active = True

        def __init__(self):
            self.scalars = []

        def scalar(self, tag, value, step):
            self.scalars.append((tag, value, step))

    jax_models, params, port_models = _families("tiny")
    writer = Writer()
    cfg = dict(EVAL, model_path="tiny", eval_sample_prompt_ids=_ids(1), master_seed=SEED,
               eval_sample_dir=str(tmp_path / "ev"))
    sampler = EvalSampler(cfg, port_models, None, writer, device="cpu")
    dirs = [sampler.maybe_sample(step) for step in (2, 2, 4)]
    read = [np.asarray(Image.open(os.path.join(d, "sample_0.png"))) for d in dirs]
    assert dirs[0] == dirs[1] == str(tmp_path / "ev" / "step_00000002") and dirs[2].endswith("step_00000004")
    assert np.array_equal(read[0], read[1]) and not np.array_equal(read[0], read[2])
    assert [(t, s) for t, _, s in writer.scalars] == [("eval/sample_mean", 2), ("eval/sample_mean", 2),
                                                     ("eval/sample_mean", 4)]
    assert all(0.0 <= v <= 1.0 for _, v, _ in writer.scalars)
