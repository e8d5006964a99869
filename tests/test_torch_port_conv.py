"""The port's polyphase stride-2 conv (``ops/conv.py``) against the JAX
package's, mirroring ``tests/test_conv.py``.

The same numpy inputs (NHWC and HWIO for JAX, NCHW and OIHW for the port)
go through both packages: the polyphase form and the plain stride-2 form,
both paddings (asymmetric ``(0, 1)``, the VAE encoder's; symmetric ``(1,
1)``, the UNet's), f32 and bf16, non-square spatial dims and Cin != Cout;
the edge rows that hit the padding; the shapes it refuses; the grads; and
the tiny VAE encoder with ``polyphase_downsample=True`` against the JAX
encoder with it and against its own default form.

Tolerances: f32 1e-5 (the JAX test's); bf16 the JAX test's bound between
the two forms (rtol 1.6e-2, atol 1e-3: one bf16 ulp of the four f32
partials' split).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_diffusion_training_tpu.models import AutoencoderKL as JaxVAE, configs as jax_configs
from stable_diffusion_training_tpu.ops import conv as jax_conv
from stable_diffusion_training_tpu_torch.models import AutoencoderKL, configs
from stable_diffusion_training_tpu_torch.models.hf_io import jax_params_to_state_dict
from stable_diffusion_training_tpu_torch.ops.conv import polyphase_stride2_conv, stride2_conv_reference
from torch_threads import _one_thread  # noqa: F401 (the fixture)

ATOL = 1e-5
BF16 = dict(rtol=1.6e-2, atol=1e-3)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(x_nhwc, k_hwio, dtype=torch.float32):
    """The inputs for the port (NCHW, OIHW, ``dtype``) and for JAX."""
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    port = (torch.tensor(x_nhwc).permute(0, 3, 1, 2).to(dtype), torch.tensor(k_hwio).permute(3, 2, 0, 1).to(dtype))
    return port, (jnp.asarray(x_nhwc).astype(jdtype), jnp.asarray(k_hwio).astype(jdtype))


def _nchw(y):
    return np.asarray(jnp.asarray(y, jnp.float32)).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("asymmetric", [True, False])
@pytest.mark.parametrize("shape,cout", [((2, 8, 12, 4), 6), ((1, 64, 64, 8), 8)])
def test_polyphase_matches_jax_f32(asymmetric, shape, cout):
    (x, k), (jx, jk) = _both(_rand(shape, 0), _rand((3, 3, shape[-1], cout), 1))
    poly = polyphase_stride2_conv(x, k, asymmetric)
    ref = stride2_conv_reference(x, k, asymmetric)
    assert poly.shape == ref.shape == (shape[0], cout, shape[1] // 2, shape[2] // 2)
    np.testing.assert_allclose(poly.numpy(), _nchw(jax_conv.polyphase_stride2_conv(jx, jk, asymmetric)),
                               atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(ref.numpy(), _nchw(jax_conv.stride2_conv_reference(jx, jk, asymmetric)),
                               atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(poly.numpy(), ref.numpy(), atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("asymmetric", [True, False])
def test_polyphase_matches_jax_bf16(asymmetric):
    (x, k), (jx, jk) = _both(_rand((2, 16, 16, 8), 2), _rand((3, 3, 8, 8), 3), torch.bfloat16)
    poly = polyphase_stride2_conv(x, k, asymmetric)
    assert poly.dtype == torch.bfloat16
    want = jax_conv.polyphase_stride2_conv(jx, jk, asymmetric)
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(poly.float().numpy(), _nchw(want), **BF16)
    np.testing.assert_allclose(poly.float().numpy(), stride2_conv_reference(x, k, asymmetric).float().numpy(), **BF16)


def test_polyphase_edge_rows_hit_padding():
    """Ones in, ones kernel: interior outputs see all 9 taps, the padded
    edge fewer, exactly as the JAX form and the stride-2 form count them."""
    for asym in (True, False):
        (x, k), (jx, jk) = _both(np.ones((1, 6, 6, 1), np.float32), np.ones((3, 3, 1, 1), np.float32))
        y = polyphase_stride2_conv(x, k, asym)[0, 0].numpy()
        np.testing.assert_array_equal(y, stride2_conv_reference(x, k, asym)[0, 0].numpy())
        np.testing.assert_array_equal(y, _nchw(jax_conv.polyphase_stride2_conv(jx, jk, asym))[0, 0])
        if asym:  # the last row and column lose the di = 2 taps
            assert y[0, 0] == 9 and y[-1, -1] == 4
        else:  # the first row and column lose the di = 0 taps
            assert y[1, 1] == 9 and y[0, 0] == 4


@pytest.mark.parametrize("x_shape,k_shape", [((1, 2, 7, 8), (2, 2, 3, 3)), ((1, 2, 8, 8), (2, 2, 5, 5))],
                         ids=["odd-height", "5x5-kernel"])
def test_polyphase_rejects_bad_shapes(x_shape, k_shape):
    with pytest.raises(ValueError):
        polyphase_stride2_conv(torch.ones(x_shape), torch.ones(k_shape))


def test_polyphase_grads_match_jax_and_the_stride2_form():
    """d sum(y) / d (x, kernel) through the polyphase form: the stride-2
    form's and the JAX polyphase form's."""
    (x, k), (jx, jk) = _both(_rand((1, 8, 8, 4), 4), _rand((3, 3, 4, 4), 5))
    grads = {}
    for name, fn in (("poly", polyphase_stride2_conv), ("ref", stride2_conv_reference)):
        xs, ks = x.clone().requires_grad_(), k.clone().requires_grad_()
        fn(xs, ks).sum().backward()
        grads[name] = (xs.grad, ks.grad)
    jgx, jgk = jax.grad(lambda a, b: jnp.sum(jax_conv.polyphase_stride2_conv(a, b)), argnums=(0, 1))(jx, jk)
    want = (_nchw(jgx), np.asarray(jgk).transpose(3, 2, 0, 1))
    for got, ref, j in zip(grads["poly"], grads["ref"], want):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL, rtol=1e-5)
        np.testing.assert_allclose(got.numpy(), j, atol=ATOL, rtol=1e-5)


def test_vae_encoder_polyphase_matches_jax_and_the_default():
    """The tiny VAE with ``polyphase_downsample=True``: the same parameter
    names and shapes as the default form; its encode within 1e-5 of the JAX
    encoder's with the flag and of its own default form's; the saved config
    leaves the run-time flag out."""
    params = JaxVAE(**jax_configs.TINY_VAE).init(jax.random.PRNGKey(0), resolution=16)
    state = jax_params_to_state_dict(params)
    poly = AutoencoderKL(**configs.TINY_VAE, device="cpu", polyphase_downsample=True)
    plain = AutoencoderKL(**configs.TINY_VAE, device="cpu")
    assert {k: v.shape for k, v in poly.state_dict().items()} == {k: v.shape for k, v in plain.state_dict().items()}
    for model in (poly, plain):
        model.load_state_dict(state, strict=True)
    assert sum(m.polyphase for m in poly.modules() if hasattr(m, "polyphase")) == 1
    image = _rand((2, 3, 16, 16), 7)
    jax_poly = JaxVAE(**jax_configs.TINY_VAE, polyphase_downsample=True)
    want = jax_poly.encode(jnp.asarray(image), params).latent_dist
    with torch.no_grad():
        got = poly.encode(torch.tensor(image)).latent_dist
        default = plain.encode(torch.tensor(image)).latent_dist
    for a, b in ((got.mean, want.mean), (got.logvar, want.logvar)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=1e-5)
    for a, b in ((got.mean, default.mean), (got.logvar, default.logvar)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=1e-5)
    assert "polyphase_downsample" not in poly.config
