"""A checkpoint that the JAX package's ``save_model`` wrote is the port
trainer's ``model_path`` (``trainer.main`` on ``tiny`` in f32 on the CPU):
weights equal to the JAX params, bit for bit, and a chunk trained from it.
The config and run helpers are ``tests/test_torch_port_trainer.py``'s."""

import json
import os

import jax
import numpy as np
import torch

from stable_diffusion_training_tpu_torch.models.hf_io import jax_params_to_state_dict
from stable_diffusion_training_tpu_torch.train import load_models, training_config_from_dict
from stable_diffusion_training_tpu_torch.utils.json_io import read_json_file
from test_torch_port_trainer import _rows, _run, make_config_dict
from torch_threads import _one_thread  # noqa: F401 (the fixture)


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
