"""The port's flash-attention forward against the JAX package's Pallas
kernel, run as the JAX tests run it on the CPU (interpret mode).

On the CPU the port's wrapper takes its plain version
(``flash_attention_fwd_reference``), so these tests hold that plain version,
which ``chip_smoke.py`` holds the CUDA kernel against on the card, to the
TPU kernel's numerics. lse layout: the TPU kernel returns ``(B*H, Sq_pad,
1)`` with Sq padded to its block; the port returns ``(B*H, Sq)``, which is
``lse_jax[:, :Sq, 0]``.

The f32 CUDA kernels' own order of operations (64- or 128-key tiles, S
summed over 64-column chunks of D, base-2 online softmax) has its
plain-torch model in the module, ``flash_attention_fwd_f32_model``, held
here against the Pallas kernel at 1e-5; ``forward_route``, the kernel a CUDA
tensor takes, reads only dtype, head dim and alignment and is checked on
CPU tensors.

Tolerances: f32, 2e-5 on O and lse (the two sides sum the same f32 products
in other orders; the JAX tests use 2e-5 between the kernel and its jnp
reference). bf16: the TPU kernel casts the unnormalised P to bf16 and
divides at the end, the plain version casts the normalised P, and O is
rounded to bf16, so O agrees to a few bf16 ulps (2e-2 at |O| <= 1); lse is
f32 from exact bf16 products (1e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_diffusion_training_tpu.ops import flash_attention as jax_fa
from stable_diffusion_training_tpu.ops.attention import (
    dot_product_attention as jax_dot_product_attention,
)
from stable_diffusion_training_tpu_torch.ops import flash_attention as fa
from stable_diffusion_training_tpu_torch.ops.attention import (
    FLASH_MIN_KEY,
    attention,
    dot_product_attention,
)
from torch_threads import _one_thread  # noqa: F401 (the fixture)

TOL = {"float32": dict(o=2e-5, lse=2e-5), "bfloat16": dict(o=2e-2, lse=1e-4)}


def _qkv(bh, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal((bh, s, d)).astype(np.float32) for s in (sq, sk, sk)
    )


def _jax(x, dtype):
    return jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def _torch(x, dtype):
    return torch.tensor(x).to(getattr(torch, dtype))


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize(
    "bh,sq,sk,d,scale,dtype",
    [
        pytest.param(2, 256, 256, 40, None, "float32", id="equal-d40"),
        pytest.param(3, 200, 77, 64, None, "float32", id="ragged-cross-d64"),
        pytest.param(2, 130, 300, 40, None, "float32", id="ragged-multiblock-d40"),
        pytest.param(1, 96, 160, 512, None, "float32", id="vae-d512"),
        pytest.param(2, 128, 128, 64, 0.05, "float32", id="custom-scale"),
        pytest.param(2, 200, 130, 40, None, "bfloat16", id="bf16-d40"),
        pytest.param(1, 96, 160, 512, None, "bfloat16", id="bf16-d512"),
    ],
)
def test_plain_version_matches_jax_kernel(bh, sq, sk, d, scale, dtype):
    q, k, v = _qkv(bh, sq, sk, d)
    s = d**-0.5 if scale is None else scale
    o_j, lse_j = jax_fa._flash_fwd_impl(
        _jax(q, dtype), _jax(k, dtype), _jax(v, dtype), s, 128, 128, True
    )
    assert lse_j.shape == (bh, -(-sq // 128) * 128, 1)
    o_t, lse_t = fa.flash_attention_fwd(_torch(q, dtype), _torch(k, dtype), _torch(v, dtype), scale)
    assert o_t.dtype == getattr(torch, dtype) and o_t.shape == (bh, sq, d)
    assert lse_t.dtype == torch.float32 and lse_t.shape == (bh, sq)
    tol = TOL[dtype]
    np.testing.assert_allclose(o_t.float().numpy(), _f32(o_j), atol=tol["o"], rtol=0)
    np.testing.assert_allclose(lse_t.numpy(), _f32(lse_j)[:, :sq, 0], atol=tol["lse"], rtol=0)


@pytest.mark.parametrize(
    "bh,sq,sk,d",
    [
        pytest.param(2, 200, 300, 40, id="d40"),
        pytest.param(2, 130, 190, 36, id="d36-padded-to-40"),
        pytest.param(3, 129, 65, 64, id="d64-one-key-past-a-tile"),
        pytest.param(1, 96, 160, 512, id="d512"),
        pytest.param(2, 70, 100, 160, id="d160-ragged-chunk"),
        pytest.param(2, 300, 200, 80, id="d80-mid"),
        pytest.param(2, 170, 130, 128, id="d128-mid"),
        pytest.param(3, 97, 257, 84, id="d84-mid-padded-to-96"),
    ],
)
def test_f32_kernel_model_matches_jax_kernel(bh, sq, sk, d):
    """``flash_attention_fwd_f32_model``, the f32 kernels' order of
    operations (64-key tiles and all of D in one pass up to D = 128, 128-key
    tiles and S summed over 64-column chunks of D above, base-2 online
    softmax with the scale folded in), against the Pallas kernel in
    interpret mode at query and key counts off both sides' tiles; f32, 1e-5
    on O and lse."""
    q, k, v = _qkv(bh, sq, sk, d, seed=6)
    s = d**-0.5
    o_j, lse_j = jax_fa._flash_fwd_impl(_jax(q, "float32"), _jax(k, "float32"), _jax(v, "float32"), s, 128, 128, True)
    o_t, lse_t = fa.flash_attention_fwd_f32_model(torch.tensor(q), torch.tensor(k), torch.tensor(v), s)
    assert o_t.dtype == lse_t.dtype == torch.float32
    assert o_t.shape == (bh, sq, d) and lse_t.shape == (bh, sq)
    np.testing.assert_allclose(o_t.numpy(), _f32(o_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse_t.numpy(), _f32(lse_j)[:, :sq, 0], atol=1e-5, rtol=0)


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("d", [8, 36, 40, 64, 80, 128, 512, 30])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_routes_by_dtype_and_head_dim(dtype, d, aligned):
    """``forward_route``, the choice ``flash_attention_fwd`` (and its C
    entry) makes for CUDA tensors: bf16 with D % 8 == 0 a tensor-core kernel,
    narrow up to D = 64, mid above up to 128 (SD1.5's heads of 80) and wide
    above that; f32 with D % 4 == 0 the f32 kernels, mid (``f32_mid``) at
    64 < D <= 128 and narrow or wide (``f32``) elsewhere;
    the rest (bf16 D = 36 or 30, f32 D = 30, any unaligned base) the older
    CUDA-core kernel. It reads dtype, head dim and alignment only, so it is
    checked on CPU tensors."""
    dt = getattr(torch, dtype)
    if aligned:
        x = torch.zeros(2, 16, d, dtype=dt)
    else:  # a view one element in
        x = torch.zeros(2 * 16 * d + 1, dtype=dt)[1:].view(2, 16, d)
    if not aligned:
        route = "cuda_cores"
    elif dtype == "bfloat16":
        route = "cuda_cores" if d % 8 else ("tma_narrow" if d <= 64 else "tma_mid" if d <= 128 else "tma_wide")
    else:
        route = "cuda_cores" if d % 4 else ("f32_mid" if 64 < d <= 128 else "f32")
    assert fa.forward_route(x, x, x) == route
    assert route in fa.FWD_ROUTES


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bshd_matches_jax(dtype):
    """The public ``(B, S, H, D)`` entry: head folding and unfolding."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 150, 3, 40)).astype(np.float32)
    k = rng.standard_normal((2, 90, 3, 40)).astype(np.float32)
    v = rng.standard_normal((2, 90, 3, 40)).astype(np.float32)
    expected = jax_fa.flash_attention(
        _jax(q, dtype), _jax(k, dtype), _jax(v, dtype), block_q=128, block_k=128,
        interpret=True,
    )
    got = fa.flash_attention(_torch(q, dtype), _torch(k, dtype), _torch(v, dtype))
    np.testing.assert_allclose(got.float().numpy(), _f32(expected), atol=TOL[dtype]["o"], rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_dot_product_attention_matches_jax(masked):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 33, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 77, 4, 16)).astype(np.float32)
    v = rng.standard_normal((2, 77, 4, 16)).astype(np.float32)
    mask = None
    if masked:
        mask = np.where(rng.random((2, 1, 33, 77)) < 0.3, -1e9, 0.0).astype(np.float32)
    expected = jax_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=None if mask is None else jnp.asarray(mask),
    )
    got = dot_product_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        mask=None if mask is None else torch.tensor(mask),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), atol=2e-6, rtol=0)


@pytest.mark.parametrize("backend", ["auto", "flash", "xla", "xla_remat"])
def test_cpu_tensors_never_launch_the_kernel(backend):
    """Long unmasked keys on CPU tensors: every backend computes the plain
    numerics and the kernel's launch count stays 0."""
    rng = np.random.default_rng(5)
    q = torch.tensor(rng.standard_normal((1, 64, 2, 8)).astype(np.float32))
    k = torch.tensor(rng.standard_normal((1, FLASH_MIN_KEY, 2, 8)).astype(np.float32))
    v = torch.tensor(rng.standard_normal((1, FLASH_MIN_KEY, 2, 8)).astype(np.float32))
    fa.reset_launch_counts()
    got = attention(q, k, v, backend=backend)
    assert fa.flash_attention_fwd.launches == 0
    assert fa.flash_attention_fwd.launches_by_shape == {}
    torch.testing.assert_close(got, dot_product_attention(q, k, v), atol=2e-6, rtol=0)


def test_cuda_cores_wrapper_rejects_cpu_tensors():
    """``flash_attention_fwd_cuda_cores`` launches the older kernel: a CPU
    tensor is an error there (``flash_attention_fwd`` takes the plain
    version for it)."""
    x = torch.zeros(1, 8, 40)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fa.flash_attention_fwd_cuda_cores(x, x, x, 0.1)


def test_tma_wide_wrapper_rejects_cpu_tensors():
    """``flash_attention_fwd_tma_wide`` launches the wide tensor-core kernel,
    which route ``tma_mid`` replaced at 64 < D <= 128: a CPU tensor is an
    error there."""
    x = torch.zeros(1, 8, 80, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fa.flash_attention_fwd_tma_wide(x, x, x, 0.1)


def test_f32_wide_wrapper_rejects_cpu_tensors():
    """``flash_attention_fwd_f32_wide`` launches the wide f32 kernel, which
    route ``f32_mid`` replaced at 64 < D <= 128: a CPU tensor is an error
    there."""
    x = torch.zeros(1, 8, 80)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fa.flash_attention_fwd_f32_wide(x, x, x, 0.1)


def test_unknown_backend_raises():
    x = torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError, match="unknown attention backend"):
        attention(x, x, x, backend="sdpa")


@pytest.mark.parametrize(
    "make,error",
    [
        (lambda: (torch.zeros(2, 8, 1, 40),) * 3, ValueError),  # 4-D
        (lambda: (torch.zeros(2, 8, 40, dtype=torch.float16),) * 3, TypeError),
        (lambda: (torch.zeros(2, 40, 8).transpose(1, 2),) * 3, ValueError),  # strided
        (lambda: (torch.zeros(2, 8, 640),) * 3, ValueError),  # D > 512
        (lambda: (torch.zeros(2, 8, 40), torch.zeros(2, 8, 40), torch.zeros(2, 9, 40)), ValueError),
        (lambda: (torch.zeros(2, 8, 40), torch.zeros(2, 8, 40, dtype=torch.bfloat16),
                  torch.zeros(2, 8, 40)), TypeError),
    ],
    ids=["rank", "dtype", "contiguity", "head-dim", "kv-shape", "mixed-dtype"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(make, error):
    with pytest.raises(error):
        fa.flash_attention_fwd(*make())
