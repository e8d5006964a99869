"""The port's ``fused_lion8bit_update`` (K6 narrow, K7 wide) against the JAX
package's, on the CPU.

On the CPU the entry takes its plain version (``lion8bit_update_reference``),
which ``chip_smoke.py`` holds the CUDA kernel against on the card. The JAX
side runs the Pallas kernels as ``tests/test_lion_kernel.py`` runs them
(``interpret=True``). Inputs come from numpy with a seed: a momentum
quantized with the JAX package's own ``_quantize`` and a grad.

Bounds, and why (``ROADMAP.md`` Queue 3 records these XLA differences):
- update signs: equal. The dequantized momentum is the JAX package's bit
  for bit (same op order, no fused multiply-adds), and so is the direction.
- codes: at most one apart, counted. XLA's f32 pow differs from torch's by
  an ulp on some inputs, which moves a code by one where 127 |x|^(1/5) sits
  at a rounding boundary.
- scales: 1e-6 relative. The interpret-mode lowering fuses
  ``(1 - b2) g + b2 mu`` into one FMA where the port rounds both products,
  which can move a block's absmax, hence its scale, by an ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_diffusion_training_tpu.ops.lion_kernel import _quantize as jax_quantize
from stable_diffusion_training_tpu.ops.lion_kernel import fused_lion8bit_update as jax_fused
from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk
from torch_threads import _one_thread  # noqa: F401 (the fixture)


def _leaf(n, bs, seed=0, zero_blocks=0):
    """A grad and a quantized momentum of ``n`` elements, numpy; the first
    ``zero_blocks`` blocks of both are zero."""
    rng = np.random.RandomState(seed)
    g = rng.randn(n).astype(np.float32) * 1e-3
    mu = rng.randn(n).astype(np.float32) * 1e-4
    g[: zero_blocks * bs] = 0.0
    mu[: zero_blocks * bs] = 0.0
    blocks = jnp.asarray(mu).reshape(-1, bs)
    absmax = jnp.max(jnp.abs(blocks), axis=-1, keepdims=True)
    scales = 1 / jnp.where(absmax <= 0, 1.0, absmax)
    codes = jax_quantize(blocks * scales)
    return g, np.asarray(codes), np.asarray(scales)


def _compare(g, codes, scales, layout, mu_scale_dtype=torch.float32, jax_dtype=jnp.float32, **kw):
    j_upd, j_codes, j_scales = jax_fused(
        jnp.asarray(g), jnp.asarray(codes), jnp.asarray(scales).astype(jax_dtype),
        b1=0.9, b2=0.99, mu_scale_dtype=jax_dtype, interpret=True, layout=layout, **kw,
    )
    codes_t = torch.tensor(codes)
    scales_t = torch.tensor(scales).to(mu_scale_dtype)
    before = codes_t.clone(), scales_t.clone()
    upd, new_codes, new_scales = lk.fused_lion8bit_update(
        torch.tensor(g), codes_t, scales_t, 0.9, 0.99, mu_scale_dtype=mu_scale_dtype,
        layout=layout, **kw,
    )
    # functional: the inputs are unchanged
    assert torch.equal(codes_t, before[0]) and torch.equal(scales_t, before[1])
    assert upd.shape == g.shape and upd.dtype == torch.float32
    assert new_codes.shape == codes.shape and new_codes.dtype == torch.int8
    assert new_scales.shape == (codes.shape[0], 1) and new_scales.dtype == mu_scale_dtype
    np.testing.assert_array_equal(upd.numpy(), np.asarray(j_upd))
    diff = np.abs(new_codes.numpy().astype(np.int32) - np.asarray(j_codes).astype(np.int32))
    assert diff.max() <= 1
    np.testing.assert_allclose(
        new_scales.float().numpy(), np.asarray(j_scales.astype(jnp.float32)), rtol=1e-6, atol=0
    )
    return int((diff > 0).sum())


@pytest.mark.parametrize(
    "layout,bs", [("narrow", 16), ("narrow", 64), ("narrow", 128), ("wide", 16), ("wide", 64)]
)
@pytest.mark.parametrize("n", [2048, 32000])
def test_fused_entry_matches_jax(layout, bs, n):
    n = n // bs * bs
    g, codes, scales = _leaf(n, bs)
    off = _compare(g, codes, scales, layout)
    assert off <= 1e-3 * n, off  # codes one apart are rare


@pytest.mark.parametrize("n_blocks", [13, 257])  # rows of 128 lanes that do not fill
def test_wide_ragged_block_counts_match_jax(n_blocks):
    bs = 16
    g, codes, scales = _leaf(n_blocks * bs, bs, seed=1)
    _compare(g, codes, scales, "wide", rows_per_tile=8)


@pytest.mark.parametrize("layout", ["narrow", "wide"])
def test_zero_block_guard_matches_jax(layout):
    """All-zero momentum blocks (code 3) under a zero grad, as
    ``tests/test_lion_kernel.py`` runs them: finite, and as the JAX entry."""
    bs = 16
    g, codes, scales = _leaf(64 * bs, bs, seed=2, zero_blocks=5)
    _compare(g, codes, scales, layout)
    upd, _, new_scales = lk.fused_lion8bit_update(
        torch.tensor(g), torch.tensor(codes), torch.tensor(scales), layout=layout
    )
    assert torch.isfinite(new_scales).all() and torch.isfinite(upd).all()


def test_bf16_scales_match_jax():
    """``mu_scale_dtype=bfloat16``: scales upcast going in, cast coming out."""
    g, codes, scales = _leaf(4096, 16, seed=3)
    _compare(g, codes, scales, "narrow", mu_scale_dtype=torch.bfloat16, jax_dtype=jnp.bfloat16)


def test_wide_rejects_what_the_jax_entry_rejects():
    for bs, compander, match in ((128, "exact", "block_size < 128"), (16, "fast", "wide")):
        args = (torch.zeros(bs), torch.zeros(1, bs, dtype=torch.int8), torch.ones(1, 1))
        with pytest.raises(ValueError, match=match):
            lk.fused_lion8bit_update(*args, layout="wide", compander=compander)
        with pytest.raises(ValueError, match=match):
            jax_fused(*(jnp.asarray(a.numpy()) for a in args), interpret=True, layout="wide",
                      compander=compander)
    with pytest.raises(ValueError, match="layout"):
        lk.fused_lion8bit_update(torch.zeros(16), torch.zeros(1, 16, dtype=torch.int8),
                                 torch.ones(1, 1), layout="transposed")
