"""The CUDA kernels against their plain versions, on the card.

These cases need an NVIDIA GPU and nvcc and skip elsewhere. The file imports
no JAX, so it also runs on a machine with the card and no JAX installed:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

(``tests/conftest.py`` imports JAX; ``--noconftest`` leaves it out.)

Flash attention, forward (K1) and backward (K2 dQ and K3 dK/dV, fused into
one tensor-core kernel for bf16 with D % 8 == 0 and D <= 64, and into one
CUDA-core kernel for f32 with D % 4 == 0 and D <= 64): shapes cover the
kernels behind each entry point, tensor cores for bf16 with D % 8 == 0
(D <= 64 forward and backward, the forward's wide-head kernel for D = 80,
128, 160, 512), CUDA cores for the f32 forward, the f32 backward at D <= 64
(fused) and above (the dQ and dK/dV pair), and the bf16 backward at D = 36
and above D = 64 (the pair); and the edges: one query and one key, a single
ragged key tile, a last key tile of one key, and at the main path's D = 40
and 512 query and key counts that are no multiple of the kernels' tiles.
The fused bf16 backward adds dQ across key blocks in an order that changes
from run to run: dK and dV repeat bitwise, dQ within a bf16 ulp. The fused
f32 backward sums its dQ partials in key-block order: all three repeat
bitwise. 8-bit Lion (K4 single leaf, K5 many leaves, and the
functional entry: K6 narrow, K7 wide) at block sizes 1 to 128 (128 on the
cooperative variant): update signs and scales equal to the plain version's,
codes at most one apart (CUDA's powf and torch's pow may differ by an ulp). Tolerances are those of
``chip_smoke.py``. The fault this slice repaired is covered too: grads flow
through the flash route on CUDA tensors.
"""

import numpy as np
import pytest
import torch

from stable_diffusion_training_tpu_torch.ops import flash_attention as fa
from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk
from stable_diffusion_training_tpu_torch.ops.attention import attention

TOL = {"float32": dict(o=1e-4, lse=1e-4, grad=1e-4, grad_fro=1e-5),
       "bfloat16": dict(o=1e-2, lse=1e-3, grad=1e-2, grad_fro=3.9e-3)}
# Backward errors are relative to the tensor's max |grad| (and Frobenius
# norm). Where the grads cancel to ~0 (one key: dS = dP - delta), both sides
# are f32 rounding of unit-scale terms, so the scale never drops below 0.1.
GRAD_SCALE_FLOOR = 0.1
SHAPES = [(4, 300, 300, 40), (2, 257, 129, 64), (3, 100, 70, 36), (2, 130, 190, 80),
          (1, 70, 100, 160), (1, 200, 333, 512), (3, 1, 1, 8), (2, 33, 5, 24),
          (1, 17, 2049, 128), (3, 4000, 3900, 40), (2, 1000, 4100, 512)]


# (fused bf16, fused f32, dQ, dK/dV) launches of one backward call, by route
ROUTE_LAUNCHES = {"fused": (1, 0, 0, 0), "f32_fused": (0, 1, 0, 0), "cuda_cores": (0, 0, 1, 1)}


def _bwd_launches():
    return (fa.flash_attention_bwd_fused.launches, fa.flash_attention_bwd_f32_fused.launches,
            fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False


def _qkv(bh, sq, sk, d, dtype, seed=7):
    rng = np.random.default_rng(seed)
    return [
        torch.tensor(rng.standard_normal((bh, s, d)), dtype=torch.float32).to(getattr(torch, dtype)).cuda()
        for s in (sq, sk, sk, sq)
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,sq,sk,d", SHAPES)
def test_cuda_kernel_matches_plain_version(bh, sq, sk, d, dtype):
    _need_cuda()
    q, k, v, _ = _qkv(bh, sq, sk, d, dtype)
    fa.reset_launch_counts()
    o, lse = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == 1
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, d**-0.5)
    tol = TOL[dtype]
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol["o"], rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=tol["lse"], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,sq,sk,d", SHAPES)
def test_backward_kernels_match_plain_version(bh, sq, sk, d, dtype):
    _need_cuda()
    q, k, v, do = _qkv(bh, sq, sk, d, dtype, seed=8)
    scale = d**-0.5
    o, lse = fa.flash_attention_fwd(q, k, v, scale)
    delta = (do.float() * o.float()).sum(-1)
    fa.reset_launch_counts()
    grads = fa.flash_attention_bwd(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()
    route = fa.backward_route(q, k, v, do)
    fused_route, align = ("fused", 8) if dtype == "bfloat16" else ("f32_fused", 4)
    assert route == (fused_route if d <= 64 and d % align == 0 else "cuda_cores")
    assert _bwd_launches() == ROUTE_LAUNCHES[route]
    expected = fa.flash_attention_bwd_reference(q, k, v, do, lse, delta, scale)
    for name, got, want in zip(("dq", "dk", "dv"), grads, expected):
        assert got.dtype == want.dtype and got.shape == want.shape, name
        got, want = got.float(), want.float()
        bound = TOL[dtype]["grad"] * max(GRAD_SCALE_FLOOR, want.abs().max().item())
        torch.testing.assert_close(got, want, atol=bound, rtol=0, msg=name)
        fro_scale = max(want.norm().item(), GRAD_SCALE_FLOOR * want.numel() ** 0.5)
        assert (got - want).norm().item() <= TOL[dtype]["grad_fro"] * fro_scale, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grads_flow_through_the_flash_route(dtype):
    """q/k/v grads through ``attention(..., backend="flash")`` on CUDA tensors
    are not None and match the plain route's (the forward kernel alone left
    its output without a grad_fn)."""
    _need_cuda()
    rng = np.random.default_rng(9)
    make = lambda s: torch.tensor(rng.standard_normal((2, s, 4, 40)), dtype=torch.float32).to(getattr(torch, dtype)).cuda()
    q, k, v, do = make(300), make(250), make(250), make(300)
    results = []
    for backend in ("flash", "xla"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fa.reset_launch_counts()
        out = attention(*leaves, backend=backend)
        out.backward(do)
        assert all(t.grad is not None for t in leaves), backend
        launched = (fa.flash_attention_fwd.launches, *_bwd_launches())
        by_route = (1, *ROUTE_LAUNCHES["fused" if dtype == "bfloat16" else "f32_fused"])
        assert launched == (by_route if backend == "flash" else (0, 0, 0, 0, 0)), backend
        results.append([t.grad.float() for t in leaves])
    for got, want in zip(*results):
        torch.testing.assert_close(got, want, atol=TOL[dtype]["grad"], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,sk,d", [(64, 4096, 4096, 40), (3, 4000, 3900, 40), (2, 257, 129, 64)])
def test_fused_backward_repeats(bh, sq, sk, d):
    """The same inputs twice through the fused kernel: dK and dV bitwise
    equal (each block sums its own queries in one order); dQ's f32 sums over
    key blocks may land in another order, which after rounding to bf16 moves
    an element by at most one ulp (2^-7 relative, of the largest |dQ|)."""
    _need_cuda()
    q, k, v, do = _qkv(bh, sq, sk, d, "bfloat16", seed=10)
    scale = d**-0.5
    o, lse = fa.flash_attention_fwd(q, k, v, scale)
    delta = (do.float() * o.float()).sum(-1)
    first = fa.flash_attention_bwd_fused(q, k, v, do, lse, delta, scale)
    second = fa.flash_attention_bwd_fused(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()
    assert torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])
    dq1, dq2 = first[0].float(), second[0].float()
    assert (dq1 - dq2).abs().max().item() <= 2.0**-7 * dq1.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,sk,d", [(8, 4096, 4096, 40), (3, 4000, 3900, 40), (4, 3000, 2100, 64), (2, 33, 5, 24)])
def test_f32_fused_backward_repeats(bh, sq, sk, d):
    """The same inputs twice through the fused f32 kernel: dQ, dK and dV
    bitwise equal (dQ's partials are summed in key-block order)."""
    _need_cuda()
    q, k, v, do = _qkv(bh, sq, sk, d, "float32", seed=11)
    scale = d**-0.5
    o, lse = fa.flash_attention_fwd(q, k, v, scale)
    delta = (do * o).sum(-1)
    first = fa.flash_attention_bwd_f32_fused(q, k, v, do, lse, delta, scale)
    second = fa.flash_attention_bwd_f32_fused(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_f32_fused_backward_takes_only_its_route():
    """The fused f32 wrapper raises on what it does not take (bf16, D > 64,
    D % 4 != 0); ``flash_attention_bwd`` sends those elsewhere."""
    _need_cuda()
    for dtype, d in (("bfloat16", 40), ("float32", 128), ("float32", 30)):
        q, k, v, do = _qkv(1, 64, 64, d, dtype)
        lse = torch.zeros(1, 64, device="cuda")
        assert not fa.takes_f32_fused_backward(q, k, v, do)
        with pytest.raises(ValueError, match="flash_attention_bwd_f32_fused takes"):
            fa.flash_attention_bwd_f32_fused(q, k, v, do, lse, lse, 0.1)


@pytest.mark.cuda
def test_fused_backward_takes_only_its_route():
    """The fused wrapper raises on what it does not take (f32, D % 8 != 0,
    D > 64) rather than computing it; ``flash_attention_bwd`` sends those to
    the CUDA-core kernels."""
    _need_cuda()
    for dtype, d in (("float32", 40), ("bfloat16", 36), ("bfloat16", 80)):
        q, k, v, do = _qkv(1, 64, 64, d, dtype)
        lse = torch.zeros(1, 64, device="cuda")
        assert not fa.takes_fused_backward(q, k, v, do)
        with pytest.raises(ValueError, match="flash_attention_bwd_fused takes"):
            fa.flash_attention_bwd_fused(q, k, v, do, lse, lse, 0.1)


def _lion_leaves(sizes, bs, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    grads, codes, scales = [], [], []
    for n in sizes:
        grads.append((torch.randn(n, generator=gen, device="cuda") * 1e-3).to(dtype))
        c, s = lk.block_quantize(torch.randn(n, generator=gen, device="cuda") * 1e-4, bs)
        codes.append(c)
        scales.append(s)
    return grads, codes, scales


@pytest.mark.cuda
@pytest.mark.parametrize("compander", ["exact", "fast"])
@pytest.mark.parametrize("bs,dtype", [(16, torch.bfloat16), (8, torch.float32), (64, torch.bfloat16),
                                      (32, torch.float32), (1, torch.bfloat16), (2, torch.float32),
                                      (4, torch.bfloat16), (128, torch.bfloat16), (128, torch.float32)])
def test_lion_kernel_matches_plain_version(bs, dtype, compander):
    _need_cuda()
    sizes = [bs * 100003, bs * 3, bs, bs * 4096]
    grads, codes, scales = _lion_leaves(sizes, bs, dtype, seed=bs)
    expected = [lk.lion8bit_update_reference(g, c, s, compander=compander) for g, c, s in zip(grads, codes, scales)]
    lk.reset_launch_counts()
    single = [(c.clone(), s.clone()) for c, s in zip(codes, scales)]
    upd_single = [lk.lion8bit_update_(g, c, s, compander=compander) for g, (c, s) in zip(grads, single)]
    multi = [(c.clone(), s.clone()) for c, s in zip(codes, scales)]
    upd_multi = lk.lion8bit_update_multi_(grads, [c for c, _ in multi], [s for _, s in multi], compander=compander)
    torch.cuda.synchronize()
    assert lk.lion8bit_update_.launches == len(sizes) and lk.lion8bit_update_multi_.launches == 1
    for (e_upd, e_codes, e_scales), u1, u2, (c1, s1), (c2, s2) in zip(expected, upd_single, upd_multi, single, multi):
        for u, c, s in ((u1, c1, s1), (u2, c2, s2)):
            assert u.dtype == dtype
            torch.testing.assert_close(u, e_upd, atol=0, rtol=0)
            torch.testing.assert_close(s, e_scales, atol=0, rtol=0)
            assert int((c.int() - e_codes.int()).abs().max()) <= 1


@pytest.mark.cuda
def test_cuda_tensor_never_takes_the_plain_version():
    """A CUDA tensor the kernel does not take raises; it is not sent to the
    plain version."""
    _need_cuda()
    x = torch.zeros(2, 8, 40, dtype=torch.float16, device="cuda")
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(x, x, x)
    g = torch.zeros(12, device="cuda")
    with pytest.raises(ValueError, match="block sizes"):
        lk.lion8bit_update_(g, torch.zeros(1, 12, dtype=torch.int8, device="cuda"),
                            torch.ones(1, device="cuda"))
    with pytest.raises(ValueError, match="block sizes"):
        lk.fused_lion8bit_update(g, torch.zeros(1, 12, dtype=torch.int8, device="cuda"),
                                 torch.ones(1, 1, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "layout,bs,dtype",
    [("narrow", 16, torch.bfloat16), ("narrow", 128, torch.bfloat16), ("narrow", 128, torch.float32),
     ("wide", 4, torch.bfloat16), ("wide", 16, torch.bfloat16), ("wide", 16, torch.float32)],
)
def test_fused_entry_matches_plain_version(layout, bs, dtype):
    """K6 and K7 through ``fused_lion8bit_update`` on a ragged block count:
    functional (inputs unchanged), counted once by layout and shape."""
    _need_cuda()
    n_blocks = 100003
    (grad,), (codes,), (scales,) = _lion_leaves([bs * n_blocks], bs, dtype, seed=bs + 1)
    e_upd, e_codes, e_scales = lk.lion8bit_update_reference(grad, codes, scales)
    codes_in, scales_in = codes.clone(), scales[:, None].clone()
    lk.reset_launch_counts()
    upd, new_codes, new_scales = lk.fused_lion8bit_update(grad, codes_in, scales_in, layout=layout)
    torch.cuda.synchronize()
    assert lk.fused_lion8bit_update.launches_by_shape == {
        (layout, n_blocks, bs, str(dtype).replace("torch.", "")): 1
    }
    assert torch.equal(codes_in, codes) and torch.equal(scales_in[:, 0], scales)
    assert upd.dtype == dtype and upd.shape == grad.shape and new_scales.shape == (n_blocks, 1)
    torch.testing.assert_close(upd, e_upd, atol=0, rtol=0)
    torch.testing.assert_close(new_scales[:, 0], e_scales, atol=0, rtol=0)
    assert int((new_codes.int() - e_codes.int()).abs().max()) <= 1
