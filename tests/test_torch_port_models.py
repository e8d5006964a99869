"""The port's SD1.5 models against the JAX package's, on the CPU in f32.

Weights come from the JAX side's ``init`` and cross through
``jax_params_to_state_dict`` under ``load_state_dict(strict=True)``; inputs
are made with numpy from a seed. Tolerance: atol 1e-5, the bar of
``tests/test_torch_golden_full.py`` (f32 convolutions and norms summed in
other orders).
"""

import gc
import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_diffusion_training_tpu.models import (
    AutoencoderKL as JaxVAE,
    CLIPTextModel as JaxCLIP,
    CLIPTextModelWithProjection as JaxCLIPProj,
    UNet2DConditionModel as JaxUNet,
    configs as jax_configs,
)
from stable_diffusion_training_tpu.models.clip import _pool_eos as jax_pool_eos
from stable_diffusion_training_tpu.models.hf_io import flax_params_to_torch_state_dict
from stable_diffusion_training_tpu.models.vae import (
    DiagonalGaussianDistribution as JaxGaussian,
)
from stable_diffusion_training_tpu_torch.models import (
    AutoencoderKL,
    CLIPTextModel,
    CLIPTextModelWithProjection,
    DiagonalGaussianDistribution,
    UNet2DConditionModel,
    configs,
    random_init_,
)
from stable_diffusion_training_tpu_torch.models import hf_io
from stable_diffusion_training_tpu_torch.models.hf_io import jax_params_to_state_dict

ATOL = 1e-5


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def tiny_params():
    rng = jax.random.PRNGKey(0)
    return {
        "unet": JaxUNet(**jax_configs.TINY_UNET).init(rng, batch_size=1, height=8, width=8),
        "vae": JaxVAE(**jax_configs.TINY_VAE).init(rng),
        "text_encoder": JaxCLIP(**jax_configs.TINY_CLIP).init(rng),
    }


def _port(cls, config, params, **kw):
    model = cls(**config, device="cpu", **kw)
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return model.eval()


def test_configs_are_the_jax_packages():
    for name in ("sd15", "tiny"):
        assert configs.MODEL_FAMILIES[name] == jax_configs.MODEL_FAMILIES[name]


@pytest.mark.parametrize("backend", ["auto", "flash", "xla"])
def test_tiny_unet_matches_jax(tiny_params, backend):
    """Every backend on CPU tensors is the plain path; "flash" goes through
    the kernel's wrapper, which takes its plain version for CPU tensors."""
    unet = _port(UNet2DConditionModel, configs.TINY_UNET, tiny_params["unet"],
                 attention_backend=backend)
    sample, ctx = _rand((2, 4, 8, 8), 1), _rand((2, 77, 32), 2)
    t = np.array([10, 500], dtype=np.int32)
    expected = JaxUNet(**jax_configs.TINY_UNET).apply(
        tiny_params["unet"], jnp.asarray(sample), jnp.asarray(t), jnp.asarray(ctx)
    )
    with torch.no_grad():
        got = unet(torch.tensor(sample), torch.tensor(t), torch.tensor(ctx))
    assert got.shape == (2, 4, 8, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), atol=ATOL, rtol=0)


def test_tiny_unet_scalar_timestep(tiny_params):
    unet = _port(UNet2DConditionModel, configs.TINY_UNET, tiny_params["unet"])
    sample, ctx = torch.tensor(_rand((2, 4, 8, 8), 3)), torch.tensor(_rand((2, 77, 32), 4))
    with torch.no_grad():
        a = unet(sample, torch.tensor(321), ctx)
        b = unet(sample, torch.tensor([321, 321]), ctx)
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_tiny_vae_encode_decode_match_jax(tiny_params):
    jax_vae = JaxVAE(**jax_configs.TINY_VAE)
    vae = _port(AutoencoderKL, configs.TINY_VAE, tiny_params["vae"])
    image, latents = _rand((2, 3, 32, 32), 5), _rand((2, 4, 16, 16), 6)
    j_dist = jax_vae.encode(jnp.asarray(image), tiny_params["vae"]).latent_dist
    j_dec = jax_vae.decode(jnp.asarray(latents), tiny_params["vae"]).sample
    with torch.no_grad():
        dist = vae.encode(torch.tensor(image)).latent_dist
        dec = vae.decode(torch.tensor(latents)).sample
    for got, expected in ((dist.mean, j_dist.mean), (dist.logvar, j_dist.logvar),
                          (dist.std, j_dist.std), (dist.kl(), j_dist.kl()), (dec, j_dec)):
        np.testing.assert_allclose(got.numpy(), np.asarray(expected), atol=ATOL, rtol=1e-5)
    assert dec.shape == (2, 3, 32, 32)


def test_diagonal_gaussian_matches_jax():
    moments = _rand((2, 8, 4, 4), 7, scale=10.0)  # logvar beyond the clip range
    j = JaxGaussian(jnp.asarray(moments), axis=1)
    t = DiagonalGaussianDistribution(torch.tensor(moments), dim=1)
    for got, expected in ((t.logvar, j.logvar), (t.std, j.std), (t.var, j.var),
                          (t.mode(), j.mode()), (t.kl(), j.kl())):
        np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-6, atol=0)
    gen = torch.Generator().manual_seed(0)
    draw = t.sample(gen)
    assert draw.shape == t.mean.shape and bool(torch.isfinite(draw).all())


def test_tiny_clip_matches_jax(tiny_params):
    jax_clip = JaxCLIP(**jax_configs.TINY_CLIP)
    clip = _port(CLIPTextModel, configs.TINY_CLIP, tiny_params["text_encoder"])
    ids = np.random.default_rng(8).integers(0, 1000, (2, 77))
    expected = jax_clip(jnp.asarray(ids), params=tiny_params["text_encoder"],
                        output_hidden_states=True)
    with torch.no_grad():
        out = clip(torch.tensor(ids), output_hidden_states=True)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(expected[0]), atol=ATOL, rtol=0)
    assert len(out.hidden_states) == len(expected.hidden_states)
    np.testing.assert_allclose(
        out.hidden_states[-1].numpy(), np.asarray(expected.hidden_states[-1]), atol=ATOL, rtol=0
    )


@pytest.mark.parametrize("projection", [False, True], ids=["no-projection", "projection"])
def test_tiny_gelu_clip_matches_jax(projection):
    """The exact-erf ``gelu`` tower (SD2.1's OpenCLIP ViT-H, SDXL's tower 2)
    at tiny width, with and without a projection, as the JAX package's
    ``tests/test_models.py`` builds it: every hidden state, the pooled
    output and the projected ``text_embeds``."""
    cfg = dict(configs.TINY_CLIP, hidden_act="gelu", eos_token_id=999,
               **({"projection_dim": 16} if projection else {}))
    jax_cls, cls = (JaxCLIPProj, CLIPTextModelWithProjection) if projection else (JaxCLIP, CLIPTextModel)
    jax_clip = jax_cls(**cfg)
    params = jax_clip.init(jax.random.PRNGKey(4))
    clip = _port(cls, cfg, params)
    ids = np.random.default_rng(12).integers(0, 999, (2, 77))
    ids[:, 40] = 999
    expected = jax_clip(jnp.asarray(ids), params=params, output_hidden_states=True)
    with torch.no_grad():
        out = clip(torch.tensor(ids), output_hidden_states=True)
    assert len(out.hidden_states) == len(expected.hidden_states)
    for got, want in zip(out.hidden_states, expected.hidden_states):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(expected[0]), atol=ATOL, rtol=0)
    pooled = out.text_embeds if projection else out.pooler_output
    want = expected.text_embeds if projection else jax_pool_eos(expected[0], jnp.asarray(ids), 999)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("eos_token_id", [999, 2], ids=["eos-match", "legacy-argmax"])
def test_clip_pooling_matches_jax(tiny_params, eos_token_id):
    """``_pool_eos``: the first EOS match, or (eos_token_id == 2, SDXL's
    text_encoder_2 config) the argmax of the ids."""
    jax_clip = JaxCLIP(**jax_configs.TINY_CLIP)
    clip = _port(CLIPTextModel, dict(configs.TINY_CLIP, eos_token_id=eos_token_id),
                 tiny_params["text_encoder"])
    ids = np.random.default_rng(9).integers(0, 990, (3, 77))
    ids[0, 5] = ids[0, 40] = 999  # two EOS tokens: the first one pools
    ids[1, 76] = 999
    last = jax_clip(jnp.asarray(ids), params=tiny_params["text_encoder"])[0]
    expected = jax_pool_eos(last, jnp.asarray(ids), eos_token_id)
    with torch.no_grad():
        got = clip(torch.tensor(ids)).pooler_output
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), atol=ATOL, rtol=0)


def _shape_tree(tree):
    """Zero-copy stand-ins with a param tree's shapes (no weights in memory)."""
    return jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), tree
    )


def test_sd15_state_dict_keys_match_jax_mapping():
    """At full SD1.5 size the port's state dict has the JAX mapping's keys
    and shapes (UNet and VAE: diffusers names; CLIP: transformers names),
    checked on shapes alone: the JAX params are traced, the port is built on
    the meta device."""
    rng = jax.random.PRNGKey(0)
    unet = JaxUNet(**jax_configs.SD15_UNET)
    vae = JaxVAE(**jax_configs.SD_VAE)
    clip = JaxCLIP(**jax_configs.CLIP_VIT_L)
    jax_trees = {
        "unet": jax.eval_shape(lambda: unet.init(rng, batch_size=1, height=8, width=8)),
        "vae": jax.eval_shape(lambda: vae.init(rng, resolution=16)),
        "text_encoder": jax.eval_shape(lambda: clip.init(rng)),
    }
    ports = {
        "unet": UNet2DConditionModel(**configs.SD15_UNET, device="meta"),
        "vae": AutoencoderKL(**configs.SD_VAE, device="meta"),
        "text_encoder": CLIPTextModel(**configs.CLIP_VIT_L, device="meta"),
    }
    for name, tree in jax_trees.items():
        tree = _shape_tree(tree)
        jax_keys = set(flax_params_to_torch_state_dict(tree))
        if name == "text_encoder":  # the JAX package's checkpoint writer re-keys CLIP
            jax_keys = {
                f"text_model.embeddings.{k}" if k.startswith(("token_", "position_"))
                else f"text_model.encoder.{k}" if k.startswith("layers.")
                else f"text_model.{k}"
                for k in jax_keys
            }
        port_sd = ports[name].state_dict()
        assert set(port_sd) == jax_keys, name
        converted = jax_params_to_state_dict(tree)
        assert {k: tuple(v.shape) for k, v in converted.items()} == {
            k: tuple(v.shape) for k, v in port_sd.items()
        }, name


def _write_safetensors(path, tensors):
    """The format's layout: u64 header length, JSON header, raw tensors."""
    header, chunks, offset = {}, [], 0
    for key, t in tensors.items():
        data = t.contiguous().numpy().tobytes()
        header[key] = {"dtype": "F32", "shape": list(t.shape),
                       "data_offsets": [offset, offset + len(data)]}
        chunks.append(data)
        offset += len(data)
    blob = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)) + blob + b"".join(chunks))


def test_load_vae_reads_newer_diffusers_attention_names(tmp_path):
    """Newer diffusers checkpoints name the VAE mid-block attention
    ``to_q/to_k/to_v/to_out.0``; the loader maps them onto the legacy
    ``query/key/value/proj_attn`` and the weights arrive unchanged."""
    vae = random_init_(AutoencoderKL(**configs.TINY_VAE, device="cpu"),
                       torch.Generator().manual_seed(4))
    newer = {".query.": ".to_q.", ".key.": ".to_k.", ".value.": ".to_v.",
             ".proj_attn.": ".to_out.0."}
    state = {}
    for key, value in vae.state_dict().items():
        for old, new in newer.items():
            key = key.replace(old, new)
        state[key] = value
    assert any(".to_out.0." in k for k in state)
    vae.save_config(str(tmp_path))
    _write_safetensors(tmp_path / "diffusion_pytorch_model.safetensors", state)
    loaded = hf_io.load_vae(str(tmp_path), device="cpu")
    for (name, a), b in zip(vae.state_dict().items(), loaded.state_dict().values()):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=name)


def test_random_init_is_seeded():
    a = UNet2DConditionModel(**configs.TINY_UNET, device="cpu")
    b = UNet2DConditionModel(**configs.TINY_UNET, device="cpu")
    random_init_(a, torch.Generator().manual_seed(3))
    random_init_(b, torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(pa, pb, atol=0, rtol=0, msg=name)


def test_models_build_in_bf16():
    unet = UNet2DConditionModel(**configs.TINY_UNET, device="cpu", dtype=torch.bfloat16)
    assert unet.dtype == torch.bfloat16
    with torch.no_grad():
        out = unet(torch.randn(1, 4, 8, 8, dtype=torch.bfloat16), torch.tensor([5]),
                   torch.randn(1, 77, 32, dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())


def test_entry_points_need_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("the card is present: the default device is valid")
    for cls, cfg in ((UNet2DConditionModel, configs.TINY_UNET),
                     (AutoencoderKL, configs.TINY_VAE), (CLIPTextModel, configs.TINY_CLIP)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(**cfg)


@pytest.mark.slow  # ~GFLOP-scale f32 forwards, as in test_torch_golden_full
def test_sd15_full_unet_forward_matches_jax():
    rng = jax.random.PRNGKey(0)
    jax_unet = JaxUNet(**jax_configs.SD15_UNET)
    params = jax_unet.init(rng, batch_size=1, height=32, width=32)
    unet = _port(UNet2DConditionModel, configs.SD15_UNET, params)
    sample, ctx = _rand((1, 4, 32, 32), 10), _rand((1, 77, 768), 11, scale=0.3)
    t = np.array([421], dtype=np.int32)
    expected = np.asarray(jax_unet.apply(params, jnp.asarray(sample), jnp.asarray(t), jnp.asarray(ctx)))
    del params
    gc.collect()
    with torch.no_grad():
        got = unet(torch.tensor(sample), torch.tensor(t), torch.tensor(ctx)).numpy()
    np.testing.assert_allclose(got, expected, atol=1e-5, rtol=1e-4)


@pytest.mark.slow  # 2.6 B parameters: ~10 GB of f32 weights on each side
def test_sdxl_full_unet_forward_matches_jax():
    """SDXL's UNet at full width (2048-channel context, 10-layer
    transformers, ``text_time`` with 6 ids) on a 16x16 latent. The port's
    model takes the converted tensors as its parameters (built on the meta
    device, ``assign=True``), so the weights are held twice, not three
    times."""
    rng = jax.random.PRNGKey(0)
    jax_unet = JaxUNet(**jax_configs.SDXL_UNET)
    params = jax_unet.init(rng, batch_size=1, height=16, width=16)
    sample, ctx = _rand((1, 4, 16, 16), 12), _rand((1, 77, 2048), 13, scale=0.3)
    added = {"text_embeds": _rand((1, 1280), 14, scale=0.3),
             "time_ids": np.array([[1024, 1024, 0, 0, 1024, 1024]], dtype=np.float32)}
    t = np.array([421], dtype=np.int32)
    expected = np.asarray(jax_unet.apply(
        params, jnp.asarray(sample), jnp.asarray(t), jnp.asarray(ctx),
        added_cond_kwargs={k: jnp.asarray(v) for k, v in added.items()},
    ))
    state = jax_params_to_state_dict(params)
    del params
    gc.collect()
    unet = UNet2DConditionModel(**configs.SDXL_UNET, device="meta")
    unet.load_state_dict(state, strict=True, assign=True)
    del state
    with torch.no_grad():
        got = unet.eval()(torch.tensor(sample), torch.tensor(t), torch.tensor(ctx),
                          added_cond_kwargs={k: torch.tensor(v) for k, v in added.items()}).numpy()
    np.testing.assert_allclose(got, expected, atol=1e-5, rtol=1e-4)


@pytest.mark.slow  # 865 M parameters: ~3.5 GB of f32 weights on each side
def test_sd21_full_unet_forward_matches_jax():
    """SD2.1's UNet at full width (linear projections, heads of 64 at every
    level, a 1024-wide context) on a 24x24 latent."""
    rng = jax.random.PRNGKey(0)
    jax_unet = JaxUNet(**jax_configs.SD21_UNET)
    params = jax_unet.init(rng, batch_size=1, height=24, width=24)
    sample, ctx = _rand((1, 4, 24, 24), 15), _rand((1, 77, 1024), 16, scale=0.3)
    t = np.array([421], dtype=np.int32)
    expected = np.asarray(jax_unet.apply(params, jnp.asarray(sample), jnp.asarray(t), jnp.asarray(ctx)))
    state = jax_params_to_state_dict(params)
    del params
    gc.collect()
    unet = UNet2DConditionModel(**configs.SD21_UNET, device="meta")
    unet.load_state_dict(state, strict=True, assign=True)
    del state
    with torch.no_grad():
        got = unet.eval()(torch.tensor(sample), torch.tensor(t), torch.tensor(ctx)).numpy()
    np.testing.assert_allclose(got, expected, atol=1e-5, rtol=1e-4)
