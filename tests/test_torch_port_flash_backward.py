"""The port's flash-attention backward against the JAX package's, on the CPU.

The JAX side is ``jax.vjp`` of ``flash_attention(..., interpret=True)``, its
custom VJP running the Pallas ``_bwd_dq_kernel``/``_bwd_dkv_kernel`` as
``tests/test_flash_attention.py`` runs them. On the CPU the port's wrappers
take the plain versions, so these tests hold ``flash_attention_bwd_reference``
(which ``chip_smoke.py`` holds the CUDA kernels against on the card) and the
``FlashAttention`` autograd Function's grads to the TPU kernels' numerics.

Tolerance: f32, 1e-5 absolute on dQ, dK and dV (of magnitude ~1). Both sides
form the same f32 products and sums in other orders, and JAX pads the
sequences to its 128-row blocks with masked columns.

The fused CUDA kernels (bf16 on the card, D <= 64 and 64 < D <= 128) sum
dQ over blocks of ``FUSED_BWD_KEYS`` keys into one f32 buffer and scale and
round it once at the end. ``test_fused_kernel_order_matches_jax_vjp`` holds
a model of that summation order, written out in plain torch inside the
test, to the JAX package; it runs none of the port's backward code. The
kernels themselves are held on the card against
``flash_attention_bwd_reference``
(``chip_smoke.py``, ``tests/test_torch_port_cuda.py``), which the tests here
hold against the JAX package. The fused f32 kernel's order of operations
(key block by key block, dQ partials summed in key-block order) has its
plain-torch model in the module, ``flash_attention_bwd_f32_fused_model``,
held here against the JAX package the same way.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_diffusion_training_tpu.ops import flash_attention as jax_fa
from stable_diffusion_training_tpu.ops.attention import attention as jax_attention
from stable_diffusion_training_tpu_torch.ops import flash_attention as fa

# the module, not the ``attention`` function the package exports under its name
attention_mod = importlib.import_module("stable_diffusion_training_tpu_torch.ops.attention")

ATOL = 1e-5
SHAPES = [  # (B, Sq, Sk, H, D)
    pytest.param(1, 256, 256, 2, 40, id="d40"),
    pytest.param(2, 200, 130, 2, 40, id="ragged-sk-lt-sq-d40"),
    pytest.param(1, 150, 300, 1, 64, id="ragged-sk-gt-sq-d64"),
    pytest.param(1, 96, 77, 3, 36, id="cross-d36"),
    # the wide-head fused kernel's head dims (SD1.5's 640-channel level has
    # heads of 80), counts off its 64-query tiles and 128-key blocks
    pytest.param(2, 200, 330, 1, 80, id="ragged-sk-gt-sq-d80"),
    pytest.param(1, 150, 70, 2, 128, id="ragged-sk-lt-sq-d128"),
]


def _inputs(b, sq, sk, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, sq, h, d)).astype(np.float32),
        rng.standard_normal((b, sk, h, d)).astype(np.float32),
        rng.standard_normal((b, sk, h, d)).astype(np.float32),
        rng.standard_normal((b, sq, h, d)).astype(np.float32),
    )


def _jax_grads(q, k, v, do):
    fn = lambda q, k, v: jax_fa.flash_attention(q, k, v, block_q=128, block_k=128, interpret=True)
    o, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(o), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _fold(x):
    b, s, h, d = x.shape
    return torch.tensor(x).permute(0, 2, 1, 3).reshape(b * h, s, d).contiguous()


def _unfold(x, b, h):
    bh, s, d = x.shape
    return x.reshape(b, h, s, d).permute(0, 2, 1, 3).numpy()


@pytest.mark.parametrize("b,sq,sk,h,d", SHAPES)
def test_plain_backward_matches_jax_vjp(b, sq, sk, h, d):
    q, k, v, do = _inputs(b, sq, sk, h, d)
    _, expected = _jax_grads(q, k, v, do)
    q3, k3, v3, do3 = (_fold(x) for x in (q, k, v, do))
    scale = d**-0.5
    o3, lse = fa.flash_attention_fwd(q3, k3, v3, scale)
    delta = (do3 * o3).sum(-1)
    grads = fa.flash_attention_bwd_reference(q3, k3, v3, do3, lse, delta, scale)
    assert [g.shape for g in grads] == [q3.shape, k3.shape, v3.shape]
    for got, want in zip(grads, expected):
        np.testing.assert_allclose(_unfold(got, b, h), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("b,sq,sk,h,d", SHAPES)
def test_autograd_function_grads_match_jax_vjp(b, sq, sk, h, d):
    """The public ``(B, S, H, D)`` entry through ``FlashAttention``: O, and
    the grads autograd gets from its backward."""
    q, k, v, do = _inputs(b, sq, sk, h, d, seed=1)
    o_j, expected = _jax_grads(q, k, v, do)
    tensors = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    o = fa.flash_attention(*tensors)
    np.testing.assert_allclose(o.detach().numpy(), o_j, atol=2e-5, rtol=0)
    o.backward(torch.tensor(do))
    for t, want in zip(tensors, expected):
        np.testing.assert_allclose(t.grad.numpy(), want, atol=ATOL, rtol=0)


def _fused_order_backward(q3, k3, v3, do3, lse, delta, scale, keys=fa.FUSED_BWD_KEYS):
    """The fused kernel's arithmetic in plain torch: per block of ``keys``
    keys, P and dS in f32 and the block's dQ partial (dS rounded to K's
    dtype) added into one f32 buffer, which is scaled and rounded to Q's
    dtype once at the end; the block's dK and dV over all queries."""
    qf, kf, vf, dof = (t.float() for t in (q3, k3, v3, do3))
    acc = torch.zeros_like(qf)
    dks, dvs = [], []
    for k0 in range(0, k3.shape[1], keys):
        kb, vb = kf[:, k0:k0 + keys], vf[:, k0:k0 + keys]
        p = torch.exp(torch.matmul(qf, kb.transpose(-1, -2)) * scale - lse[..., None])
        ds = p * (torch.matmul(dof, vb.transpose(-1, -2)) - delta[..., None])
        acc += torch.matmul(ds.to(k3.dtype).float(), kb)
        dvs.append(torch.matmul(p.to(do3.dtype).float().transpose(-1, -2), dof))
        dks.append(scale * torch.matmul(ds.to(q3.dtype).float().transpose(-1, -2), qf))
    return (scale * acc).to(q3.dtype), torch.cat(dks, 1).to(k3.dtype), torch.cat(dvs, 1).to(v3.dtype)


@pytest.mark.parametrize("dtype,atol", [("float32", ATOL), ("bfloat16", 1e-2)])
def test_fused_kernel_order_matches_jax_vjp(dtype, atol):
    """Sq and Sk off the kernel's tiles (Sk = 300: key blocks of 128, 128
    and 44; Sq = 200: a ragged 128-query tile of the D <= 64 kernel, a
    ragged 64-query tile of the wide-head one), at D = 40 and at D = 80,
    which the wide-head kernel takes (its dQ, too, is added into the f32
    buffer once per block of ``FUSED_BWD_KEYS`` keys). f32: 1e-5 as above;
    bf16: 1e-2 at grads ~1, as ``test_bf16_backward_rounds_p_and_ds`` (the
    JAX kernel also rounds dQ once, from its f32 scratch)."""
    for b, sq, sk, h, d in ((1, 200, 300, 2, 40), (1, 200, 300, 1, 80)):
        q, k, v, do = _inputs(b, sq, sk, h, d, seed=4)
        jdt = getattr(jnp, dtype)
        fn = lambda q, k, v: jax_fa.flash_attention(q, k, v, block_q=128, block_k=128, interpret=True)
        _, vjp = jax.vjp(fn, *(jnp.asarray(x).astype(jdt) for x in (q, k, v)))
        expected = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(do).astype(jdt))]
        q3, k3, v3, do3 = (_fold(x).to(getattr(torch, dtype)) for x in (q, k, v, do))
        scale = d**-0.5
        o3, lse = fa.flash_attention_fwd(q3, k3, v3, scale)
        delta = (do3.float() * o3.float()).sum(-1)
        grads = _fused_order_backward(q3, k3, v3, do3, lse, delta, scale)
        for got, want in zip(grads, expected):
            assert got.dtype == getattr(torch, dtype)
            np.testing.assert_allclose(_unfold(got.float(), b, h), want, atol=atol, rtol=0, err_msg=f"D = {d}")


def test_f32_fused_kernel_order_matches_jax_vjp():
    """The fused f32 kernel's order model (``flash_attention_bwd_f32_fused_model``)
    against ``jax.vjp`` in interpret mode, with Sq and Sk off the kernel's
    tiles (Sk = 300: key blocks of 128, 128 and 44, the last one inside its
    first 64-key half; Sq = 200: a ragged 64-query tile) at D = 40 and 36
    (the kernel pads 36 to 40); f32, 1e-5 as above."""
    for b, sq, sk, h, d in ((1, 200, 300, 2, 40), (1, 100, 130, 3, 36)):
        q, k, v, do = _inputs(b, sq, sk, h, d, seed=5)
        _, expected = _jax_grads(q, k, v, do)
        q3, k3, v3, do3 = (_fold(x) for x in (q, k, v, do))
        scale = d**-0.5
        o3, lse = fa.flash_attention_fwd(q3, k3, v3, scale)
        delta = (do3 * o3).sum(-1)
        grads = fa.flash_attention_bwd_f32_fused_model(q3, k3, v3, do3, lse, delta, scale)
        for got, want in zip(grads, expected):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(_unfold(got, b, h), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize(
    "dtype,d,route",
    [("float32", 40, "f32_fused"), ("float32", 64, "f32_fused"), ("float32", 36, "f32_fused"),
     ("float32", 8, "f32_fused"), ("float32", 128, "cuda_cores"), ("float32", 30, "cuda_cores"),
     ("bfloat16", 40, "fused"), ("bfloat16", 64, "fused"), ("bfloat16", 36, "cuda_cores"),
     ("bfloat16", 80, "fused_wide"), ("bfloat16", 96, "fused_wide"), ("bfloat16", 128, "fused_wide"),
     ("bfloat16", 136, "cuda_cores")],
)
def test_backward_routes_by_dtype_and_head_dim(dtype, d, route):
    """``backward_route``, the choice ``flash_attention_bwd`` makes for CUDA
    tensors: f32 with D % 4 == 0 and D <= 64 takes the fused f32 kernel,
    bf16 with D % 8 == 0 the fused tensor-core kernel at D <= 64 and its
    wide-head counterpart at 64 < D <= 128, and the rest (bf16 D = 36 and
    136, f32 D = 128) the CUDA-core pair. The choice reads dtype, head dim
    and alignment only, so it is checked on CPU tensors."""
    x = torch.zeros(2, 16, d, dtype=getattr(torch, dtype))
    assert fa.backward_route(x, x, x, x) == route
    assert fa.takes_f32_fused_backward(x, x, x, x) == (route == "f32_fused")
    assert fa.takes_fused_backward(x, x, x, x) == (route == "fused")
    assert fa.takes_fused_wide_backward(x, x, x, x) == (route == "fused_wide")
    # an unaligned base (a view one element in) leaves the fused kernels
    y = torch.zeros(2 * 16 * d + 1, dtype=x.dtype)[1:].view(2, 16, d)
    assert fa.backward_route(y, y, y, y) == "cuda_cores"


def test_bf16_backward_rounds_p_and_ds():
    """bf16: P is rounded to dO's dtype before P^T dO and dS to K's/Q's
    before the dQ/dK products (1e-2 at grads ~1: a few bf16 ulps of the
    f32-accumulated sums, as in the forward's bf16 bound)."""
    b, sq, sk, h, d = 1, 130, 90, 2, 40
    q, k, v, do = _inputs(b, sq, sk, h, d, seed=2)
    bf = jnp.bfloat16
    fn = lambda q, k, v: jax_fa.flash_attention(q, k, v, block_q=128, block_k=128, interpret=True)
    _, vjp = jax.vjp(fn, *(jnp.asarray(x).astype(bf) for x in (q, k, v)))
    expected = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(do).astype(bf))]
    tensors = [torch.tensor(x).bfloat16().requires_grad_() for x in (q, k, v)]
    fa.flash_attention(*tensors).backward(torch.tensor(do).bfloat16())
    for t, want in zip(tensors, expected):
        assert t.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(t.grad.float().numpy(), want, atol=1e-2, rtol=0)


@pytest.mark.parametrize(
    "sq,sk,masked",
    [(2048, 77, False), (1024, 227, False), (1500, 77, False), (1024, 77, True), (256, 77, False)],
    ids=["chunked", "one-chunk", "ragged-chunks", "masked", "short-query"],
)
def test_xla_remat_route_matches_jax(sq, sk, masked):
    """``"xla_remat"``: query chunks of ``QUERY_CHUNK`` recomputed in the
    backward; forward and grads equal the JAX route's (same f32 math in
    another order: 1e-5)."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, sq, 2, 8)).astype(np.float32)
    k = rng.standard_normal((1, sk, 2, 8)).astype(np.float32)
    v = rng.standard_normal((1, sk, 2, 8)).astype(np.float32)
    do = rng.standard_normal((1, sq, 2, 8)).astype(np.float32)
    mask = np.where(rng.random((1, 1, sq, sk)) < 0.2, -1e9, 0.0).astype(np.float32) if masked else None
    fn = lambda q, k, v: jax_attention(q, k, v, mask=None if mask is None else jnp.asarray(mask), backend="xla_remat")
    o_j, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    expected = vjp(jnp.asarray(do))
    tensors = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    o = attention_mod.attention(
        *tensors, mask=None if mask is None else torch.tensor(mask), backend="xla_remat"
    )
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_j), atol=ATOL, rtol=0)
    o.backward(torch.tensor(do))
    for t, want in zip(tensors, expected):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_auto_policy_is_the_jax_packages():
    """``"auto"`` on CPU tensors: long queries take ``xla_remat``, short ones
    ``xla`` (flash needs CUDA tensors), as the JAX package picks off the TPU."""
    picked = []
    real = attention_mod._remat_attention

    def spy(*args):
        picked.append(args[0].shape[1])
        return real(*args)

    attention_mod._remat_attention = spy
    try:
        for sq in (attention_mod.REMAT_MIN_QUERY - 1, attention_mod.REMAT_MIN_QUERY, 2 * attention_mod.QUERY_CHUNK):
            x = torch.zeros(1, sq, 1, 8, requires_grad=True)
            attention_mod.attention(x, x[:, :77], x[:, :77])
    finally:
        attention_mod._remat_attention = real
    assert picked == [attention_mod.REMAT_MIN_QUERY] + [attention_mod.QUERY_CHUNK] * 2


def test_backward_kernel_wrappers_reject_cpu_tensors():
    """The backward kernels' wrappers launch them: a CPU tensor is an error there
    (``flash_attention_bwd`` is the entry that takes the plain version)."""
    x = torch.zeros(1, 8, 40)
    lse = torch.zeros(1, 8)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fa.flash_attention_bwd_dq(x, x, x, x, lse, lse, 0.1)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fa.flash_attention_bwd_dkv(x, x, x, x, lse, lse, 0.1)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fa.flash_attention_bwd_fused(x, x, x, x, lse, lse, 0.1)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fa.flash_attention_bwd_f32_fused(x, x, x, x, lse, lse, 0.1)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fa.flash_attention_bwd_fused_wide(torch.zeros(1, 8, 80), torch.zeros(1, 8, 80), torch.zeros(1, 8, 80),
                                          torch.zeros(1, 8, 80), lse, lse, 0.1)
    with pytest.raises(ValueError, match="dO must be"):
        fa.flash_attention_bwd(x, x, x, torch.zeros(1, 8, 40, dtype=torch.bfloat16), lse, lse, 0.1)
