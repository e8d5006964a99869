"""The port's SDXL pieces against the JAX package's, on the CPU in f32:
SDXL's second text encoder (``CLIPTextModelWithProjection``), the UNet's
``text_time`` micro-conditioning (the base's 6 time ids and the refiner's
5) and ``DDIMScheduler.add_noise``. Weights come from the JAX side's
``init`` and cross through ``jax_params_to_state_dict`` under
``load_state_dict(strict=True)``; inputs are made with numpy from a seed.
Tolerances and helpers are ``tests/test_torch_port_sdxl.py``'s (models atol
1e-5, the bar of ``tests/test_torch_port_models.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_diffusion_training_tpu.diffusion import DDIMScheduler as JaxDDIM
from stable_diffusion_training_tpu.models import (
    CLIPTextModelWithProjection as JaxCLIPProj,
    UNet2DConditionModel as JaxUNet,
    configs as jax_configs,
)
from stable_diffusion_training_tpu_torch.diffusion import DDIMScheduler
from stable_diffusion_training_tpu_torch.models import CLIPTextModelWithProjection, UNet2DConditionModel, configs
from stable_diffusion_training_tpu_torch.models import hf_io
from test_torch_port_sdxl import ATOL, SCHEDULER, _port, _rand
from torch_threads import _one_thread  # noqa: F401 (the fixture)


@pytest.fixture(scope="module")
def te2_params():
    return JaxCLIPProj(**jax_configs.TINY_CLIP_PROJ).init(jax.random.PRNGKey(3))


def test_configs_are_the_jax_packages():
    for name in ("sdxl", "sdxl_refiner", "tiny_sdxl", "tiny_sdxl_dual", "tiny_sdxl_refiner"):
        assert configs.MODEL_FAMILIES[name] == jax_configs.MODEL_FAMILIES[name]


@pytest.mark.parametrize("eos_token_id", [2, 999, 49407], ids=["legacy-argmax", "eos-match", "eos-absent"])
def test_text_encoder_2_matches_jax(te2_params, eos_token_id):
    """``text_embeds`` (pooled at EOS, projected), the last and the
    penultimate hidden state. With eos_token_id 49407 (CLIP's EOT, outside
    the tiny vocabulary) no id matches and both pool at position 0."""
    cfg = dict(configs.TINY_CLIP_PROJ, eos_token_id=eos_token_id)
    ids = np.random.default_rng(eos_token_id).integers(3, 990, (3, 77))
    ids[0, 6] = ids[0, 50] = 999  # two EOS tokens: the first pools
    ids[1, 76] = 999
    expected = JaxCLIPProj(**cfg)(jnp.asarray(ids), params=te2_params, output_hidden_states=True)
    clip = _port(CLIPTextModelWithProjection, cfg, te2_params)
    with torch.no_grad():
        got = clip(torch.tensor(ids), output_hidden_states=True)
    assert got.text_embeds.shape == (3, cfg["projection_dim"])
    for a, b in ((got.text_embeds, expected.text_embeds), (got[0], expected[0]),
                 (got.last_hidden_state, expected.last_hidden_state),
                 (got.hidden_states[-2], expected.hidden_states[-2])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0)
    assert len(got.hidden_states) == len(expected.hidden_states)


def test_text_encoder_2_param_paths_are_the_jax_trees(te2_params):
    """Each torch parameter's path in the JAX tree and its layout: the
    tower under ``text_model``, ``text_projection`` at the top."""
    clip = _port(CLIPTextModelWithProjection, configs.TINY_CLIP_PROJ, te2_params)
    jax_leaves = {
        tuple(k.key for k in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(te2_params)[0]
    }
    paths = hf_io.jax_param_paths(clip)
    assert {path for path, _ in paths.values()} == set(jax_leaves)
    for name, param in clip.named_parameters():
        path, perm = paths[name]
        value = param.detach().permute(*perm) if perm else param.detach()
        np.testing.assert_array_equal(value.numpy(), jax_leaves[path], err_msg=name)


def _added(batch, n_ids, pooled_dim, seed):
    rng = np.random.default_rng(seed)
    ids = rng.choice([0.0, 32.0, 512.0, 1024.0, 6.0], (batch, n_ids)).astype(np.float32)
    return {"text_embeds": _rand((batch, pooled_dim), seed + 1), "time_ids": ids}


UNETS = {
    "base": (configs.TINY_SDXL_UNET, 6),
    "dual": (configs.MODEL_FAMILIES["tiny_sdxl_dual"]["unet"], 6),
    "refiner": (configs.TINY_SDXL_REFINER_UNET, 5),
}


@pytest.mark.parametrize("name", list(UNETS))
def test_tiny_sdxl_unet_matches_jax(name):
    """``text_time``: the sinusoid of each time id, after the pooled text
    embedding, through ``add_embedding`` into the time embedding; the
    refiner's 5 ids take the same code at 2560-style widths."""
    cfg, n_ids = UNETS[name]
    jax_unet = JaxUNet(**cfg)
    params = jax_unet.init(jax.random.PRNGKey(1), batch_size=1, height=8, width=8)
    unet = _port(UNet2DConditionModel, cfg, params)
    pooled = cfg["projection_class_embeddings_input_dim"] - n_ids * cfg["addition_time_embed_dim"]
    sample, ctx = _rand((2, 4, 8, 8), 2), _rand((2, 77, cfg["cross_attention_dim"]), 3)
    t = np.array([10, 700], dtype=np.int32)
    added = _added(2, n_ids, pooled, 4)
    expected = jax_unet.apply(params, jnp.asarray(sample), jnp.asarray(t), jnp.asarray(ctx),
                              added_cond_kwargs={k: jnp.asarray(v) for k, v in added.items()})
    with torch.no_grad():
        got = unet(torch.tensor(sample), torch.tensor(t), torch.tensor(ctx),
                   added_cond_kwargs={k: torch.tensor(v) for k, v in added.items()})
    assert got.shape == (2, 4, 8, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), atol=ATOL, rtol=0)
    # the micro-conditioning moves the output
    added["time_ids"] = added["time_ids"] + 64.0
    with torch.no_grad():
        moved = unet(torch.tensor(sample), torch.tensor(t), torch.tensor(ctx),
                     added_cond_kwargs={k: torch.tensor(v) for k, v in added.items()})
    assert not torch.allclose(moved, got)


def test_text_time_unet_needs_added_cond_kwargs():
    unet = UNet2DConditionModel(**configs.TINY_SDXL_UNET, device="cpu")
    assert "add_embedding.linear_1.weight" in unet.state_dict()
    with pytest.raises(ValueError, match="requires added_cond_kwargs"):
        unet(torch.zeros(1, 4, 8, 8), torch.tensor([1]), torch.zeros(1, 77, 32))
    with pytest.raises(ValueError, match="addition_embed_type"):
        UNet2DConditionModel(**dict(configs.TINY_SDXL_UNET, addition_embed_type="text"), device="cpu")


@pytest.mark.parametrize("t", [0, 1, 499, 999])
def test_ddim_add_noise_matches_jax(t):
    jax_sched = JaxDDIM(**SCHEDULER)
    sched = DDIMScheduler(**SCHEDULER)
    x0, noise = _rand((2, 4, 8, 8), 5), _rand((2, 4, 8, 8), 6)
    steps = np.array([t, 999 - t], dtype=np.int32)
    expected = jax_sched.add_noise(jax_sched.create_state(), jnp.asarray(x0), jnp.asarray(noise),
                                   jnp.asarray(steps))
    got = sched.add_noise(sched.create_state(), torch.tensor(x0), torch.tensor(noise),
                          torch.tensor(steps, dtype=torch.long))
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), atol=1e-6, rtol=0)
