"""The port's in-loop eval sampler on a refiner (img2img from
``eval_sample_images``) against the JAX package's, on the CPU in f32. The
config, draws, helpers and the 1e-5 image bound are
``tests/test_torch_port_eval_sampler.py``'s (its docstring says why)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from PIL import Image

from stable_diffusion_training_tpu.models import AutoencoderKL as JaxVAE, UNet2DConditionModel as JaxUNet
from stable_diffusion_training_tpu.models import configs as jax_configs
from stable_diffusion_training_tpu.train.eval_sampler import EvalSampler as JaxEvalSampler
from stable_diffusion_training_tpu_torch.models import AutoencoderKL, UNet2DConditionModel, configs
from stable_diffusion_training_tpu_torch.train.eval_sampler import EvalSampler
from test_torch_port_eval_sampler import (
    EVAL, SEED, STEP, _assert_same, _ids, _jax_images, _port, _port_images, _tower_2_dir,
)
from torch_threads import _one_thread  # noqa: F401 (the fixture)


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
