"""The CUDA kernels against their plain versions, on the card.

These cases need an NVIDIA GPU and nvcc and skip elsewhere. The file imports
no JAX, so it also runs on a machine with the card and no JAX installed:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

(``tests/conftest.py`` imports JAX; ``--noconftest`` leaves it out.)

Flash attention, forward (K1: the route ``forward_route`` names, whose
counter alone moves; the f32 kernels repeat bitwise; the older CUDA-core
kernel on every route's inputs through ``flash_attention_fwd_cuda_cores``)
and backward (K2 dQ and K3 dK/dV, fused into
one tensor-core kernel for bf16 with D % 8 == 0 and D <= 64, into its
wide-head counterpart for 64 < D <= 128, and into one CUDA-core kernel for
f32 with D % 4 == 0 and D <= 64): shapes cover the
kernels behind each entry point, tensor cores for bf16 with D % 8 == 0
(D <= 64 forward and backward, the forward's wide-head kernel for D = 80,
128, 160, 512), CUDA cores for the f32 forward, the f32 backward at D <= 64
(fused) and above (the dQ and dK/dV pair), the bf16 backward at D = 72
(padded to 80), 80, 96 and 128 (the wide-head kernel) and at D = 36, 160
and 512 (the pair); and
the edges: one query and one key, a single
ragged key tile, a last key tile of one key, and at the main path's D = 40
and 512 query and key counts that are no multiple of the kernels' tiles;
and the SDXL serving shapes, with one full-width SDXL UNet call counted.
The fused bf16 backward adds dQ across key blocks in an order that changes
from run to run: dK and dV repeat bitwise, dQ within a bf16 ulp. The fused
f32 backward sums its dQ partials in key-block order: all three repeat
bitwise. 8-bit Lion (the leaf table over grads in torch layout; the stream
kernel behind K4's single leaf, K5's many leaves and the functional entry,
K6 narrow and K7 wide) at block sizes 1 to 128, bf16 and f32 grads, both
companders: update signs and scales equal to the plain version's, codes at
most one apart (CUDA's powf and torch's pow may differ by an ulp) and,
between the leaf table and the stream kernel, equal; both kernels' codes
bitwise the plain version's (torch's pow on CUDA is powf) over every code
and scale and over grads at every code's rounding boundary; the stream
kernel on ragged tails, leaves shorter than one tile and leaves off
16-byte boundaries (its plain-load tiles), on lists long enough that each
CTA walks its ring of stages several times, and refusing a tile other
than its own; a
leaf the table cannot take goes the single-leaf route, counted there; a
table of more leaves than one launch holds and more than 2^31 elements
(SDXL's scale) takes two launches.
The backward at SDXL training's shapes (D = 64 over 4,096 and 4,032 tokens)
is held to its plain version on both fused routes. Tolerances are those of
``chip_smoke.py``. The fault this slice repaired is covered too: grads flow
through the flash route on CUDA tensors.
"""

import numpy as np
import pytest
import torch

from stable_diffusion_training_tpu_torch.ops import flash_attention as fa
from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk
from stable_diffusion_training_tpu_torch.ops.attention import attention
from torch_threads import _one_thread  # noqa: F401 (the fixture)

TOL = {"float32": dict(o=1e-4, lse=1e-4, grad=1e-4, grad_fro=1e-5),
       "bfloat16": dict(o=1e-2, lse=1e-3, grad=1e-2, grad_fro=3.9e-3)}
# Backward errors are relative to the tensor's max |grad| (and Frobenius
# norm). Where the grads cancel to ~0 (one key: dS = dP - delta), both sides
# are f32 rounding of unit-scale terms, so the scale never drops below 0.1.
GRAD_SCALE_FLOOR = 0.1
SHAPES = [(4, 300, 300, 40), (2, 257, 129, 64), (3, 100, 70, 36), (2, 130, 190, 80),
          (1, 70, 100, 160), (1, 200, 333, 512), (3, 1, 1, 8), (2, 33, 5, 24),
          (1, 17, 2049, 128), (3, 4000, 3900, 40), (2, 1000, 4100, 512), (2, 333, 200, 96),
          (1, 130, 129, 72)]


# (fused bf16, fused bf16 wide heads, fused f32, dQ, dK/dV) launches of one
# backward call, by route
ROUTE_LAUNCHES = {"fused": (1, 0, 0, 0, 0), "fused_wide": (0, 1, 0, 0, 0), "f32_fused": (0, 0, 1, 0, 0),
                  "cuda_cores": (0, 0, 0, 1, 1)}


def _bwd_launches():
    return (fa.flash_attention_bwd_fused.launches, fa.flash_attention_bwd_fused_wide.launches,
            fa.flash_attention_bwd_f32_fused.launches, fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches)


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
    # only the counter of the inputs' route moved: f32 always takes the f32
    # kernels here (D % 4 == 0, fresh aligned tensors; the mid one at
    # 64 < D <= 128), bf16 the tensor cores unless D % 8 != 0
    route = fa.forward_route(q, k, v)
    assert route == (("f32_mid" if 64 < d <= 128 else "f32") if dtype == "float32" else "cuda_cores" if d % 8 else
                     "tma_narrow" if d <= 64 else "tma_mid" if d <= 128 else "tma_wide")
    assert fa.flash_attention_fwd.launches_by_route == {route: 1}
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, d**-0.5)
    tol = TOL[dtype]
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol["o"], rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=tol["lse"], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,sk,d", [(64, 4096, 4096, 40), (3, 4000, 3900, 40), (2, 1000, 4100, 512),
                                        (1, 200, 333, 512), (2, 33, 5, 24), (64, 2704, 2704, 80),
                                        (3, 1000, 1100, 96), (2, 1500, 1300, 128)])
def test_f32_forward_repeats(bh, sq, sk, d):
    """The same inputs twice through the f32 forward kernels: O and lse
    bitwise equal (every sum runs in one fixed order); the mid kernel at
    SD1.5's (64, 2704, 80) and at D = 96 and 128 off its tiles."""
    _need_cuda()
    q, k, v, _ = _qkv(bh, sq, sk, d, "float32", seed=12)
    assert fa.forward_route(q, k, v) == ("f32_mid" if 64 < d <= 128 else "f32")
    first = fa.flash_attention_fwd(q, k, v)
    second = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,sk,d,route", [(20, 4096, 4096, 64, "tma_narrow"), (24, 4096, 4096, 64, "tma_narrow"),
                                              (1, 16384, 16384, 512, "tma_wide")])
def test_sdxl_shapes_match_plain_version(bh, sq, sk, d, route):
    """K1 in bf16 at the SDXL serving shapes: the 64x64-latent
    self-attention of the base (10 heads, CFG batch 2) and of the refiner
    (12 heads), D = 64; the VAE mid-block at 1024x1024 (16,384 keys)."""
    _need_cuda()
    q, k, v, _ = _qkv(bh, sq, sk, d, "bfloat16", seed=14)
    assert fa.forward_route(q, k, v) == route
    fa.reset_launch_counts()
    o, lse = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches_by_route == {route: 1}
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, d**-0.5)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=TOL["bfloat16"]["o"], rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=TOL["bfloat16"]["lse"], rtol=0)


@pytest.mark.cuda
def test_sdxl_unet_call_launches_k1_at_its_shape():
    """One full-width SDXL base UNet call in bf16 on 128x128 latents, CFG
    batch 2: K1 runs 10 times (4 down and 6 up self-attentions of the 64x64
    level) at (20, 4096, 64) on the narrow tensor-core kernel; the 32x32
    level and the cross-attention take the plain path."""
    _need_cuda()
    from stable_diffusion_training_tpu_torch.models import UNet2DConditionModel, configs, random_init_

    gen = torch.Generator(device="cuda").manual_seed(0)
    unet = random_init_(UNet2DConditionModel(**configs.SDXL_UNET, device="cuda", dtype=torch.bfloat16), gen)
    bf16 = dict(device="cuda", dtype=torch.bfloat16)
    sample = torch.randn(2, 4, 128, 128, generator=gen, **bf16)
    ctx = torch.randn(2, 77, 2048, generator=gen, **bf16)
    added = {"text_embeds": torch.randn(2, 1280, generator=gen, **bf16),
             "time_ids": torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]] * 2, device="cuda")}
    fa.reset_launch_counts()
    with torch.no_grad():
        out = unet(sample, torch.tensor([500, 500], device="cuda"), ctx, added_cond_kwargs=added)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches_by_route == {"tma_narrow": 10}
    assert fa.flash_attention_fwd.launches_by_shape == {(20, 4096, 4096, 64, "bfloat16", "tma_narrow"): 10}
    assert out.shape == (2, 4, 128, 128) and bool(torch.isfinite(out).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,sq,sk,d", [(4, 300, 300, 40), (1, 200, 333, 512), (3, 100, 70, 36)])
def test_cuda_cores_forward_matches_plain_version(bh, sq, sk, d, dtype):
    """The older CUDA-core forward, which the routes above replaced where
    they apply, on inputs of every route (``flash_attention_fwd_cuda_cores``
    launches it whatever ``forward_route`` says)."""
    _need_cuda()
    q, k, v, _ = _qkv(bh, sq, sk, d, dtype, seed=13)
    fa.reset_launch_counts()
    o, lse = fa.flash_attention_fwd_cuda_cores(q, k, v, d**-0.5)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd_cuda_cores.launches == 1 and fa.flash_attention_fwd.launches == 0
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, d**-0.5)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=TOL[dtype]["o"], rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=TOL[dtype]["lse"], rtol=0)


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
    if dtype == "bfloat16":
        want = "cuda_cores" if d % 8 or d > 128 else "fused" if d <= 64 else "fused_wide"
    else:
        want = "f32_fused" if d <= 128 and d % 4 == 0 else "cuda_cores"
    assert route == want
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
        assert launched == (by_route if backend == "flash" else (0,) * 6), backend
        results.append([t.grad.float() for t in leaves])
    for got, want in zip(*results):
        torch.testing.assert_close(got, want, atol=TOL[dtype]["grad"], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,sk,d", [(64, 4096, 4096, 40), (3, 4000, 3900, 40), (2, 257, 129, 64),
                                        (64, 2704, 2704, 80), (3, 1000, 1100, 80), (2, 70, 390, 128)])
def test_fused_backward_repeats(bh, sq, sk, d):
    """The same inputs twice through the fused kernel (the wide-head one
    above D = 64; SD1.5's 640-channel level at 832x832 is (64, 2704, 80)):
    dK and dV bitwise equal (each block sums its own queries in one order);
    dQ's f32 sums over key blocks may land in another order, which after
    rounding to bf16 moves an element by at most one ulp (2^-7 relative, of
    the largest |dQ|)."""
    _need_cuda()
    q, k, v, do = _qkv(bh, sq, sk, d, "bfloat16", seed=10)
    scale = d**-0.5
    o, lse = fa.flash_attention_fwd(q, k, v, scale)
    delta = (do.float() * o.float()).sum(-1)
    fused = fa.flash_attention_bwd_fused if d <= 64 else fa.flash_attention_bwd_fused_wide
    first = fused(q, k, v, do, lse, delta, scale)
    second = fused(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()
    assert torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])
    dq1, dq2 = first[0].float(), second[0].float()
    assert (dq1 - dq2).abs().max().item() <= 2.0**-7 * dq1.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,sk,d", [(8, 4096, 4096, 40), (3, 4000, 3900, 40), (4, 3000, 2100, 64), (2, 33, 5, 24),
                                        (64, 2704, 2704, 80), (3, 1000, 1100, 96), (1, 130, 129, 72),
                                        (2, 150, 70, 128)])
def test_f32_fused_backward_repeats(bh, sq, sk, d):
    """The same inputs twice through the fused f32 kernel: dQ, dK and dV
    bitwise equal (dQ's partials are summed in key-block order), with
    128-key blocks at D <= 64 and 64-key ones above (SD1.5's 640-channel
    level at 832x832 is (64, 2704, 80); D = 128 streams 48-query tiles)."""
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
    """The fused f32 wrapper raises on what it does not take (bf16, D > 128,
    D % 4 != 0); ``flash_attention_bwd`` sends those elsewhere."""
    _need_cuda()
    for dtype, d in (("bfloat16", 40), ("float32", 132), ("float32", 30)):
        q, k, v, do = _qkv(1, 64, 64, d, dtype)
        lse = torch.zeros(1, 64, device="cuda")
        assert not fa.takes_f32_fused_backward(q, k, v, do)
        with pytest.raises(ValueError, match="flash_attention_bwd_f32_fused takes"):
            fa.flash_attention_bwd_f32_fused(q, k, v, do, lse, lse, 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,sk,d", [(64, 2704, 2704, 80), (3, 1000, 1100, 96), (1, 130, 129, 72),
                                        (2, 150, 70, 128)])
def test_mid_forward_matches_the_wide_kernel_it_replaced(bh, sq, sk, d):
    """bf16 at 64 < D <= 128 (SD1.5's 640-channel level at 832x832 is (64,
    2704, 80); D = 96, 72 and 128 off the tiles): ``flash_attention_fwd``
    takes route tma_mid and only its counter moves; the wide kernel it
    replaced there (``flash_attention_fwd_tma_wide``, counted apart) gives
    O and lse within the bf16 bounds of the same plain version."""
    _need_cuda()
    q, k, v, _ = _qkv(bh, sq, sk, d, "bfloat16", seed=15)
    assert fa.forward_route(q, k, v) == "tma_mid"
    fa.reset_launch_counts()
    o, lse = fa.flash_attention_fwd(q, k, v)
    o_w, lse_w = fa.flash_attention_fwd_tma_wide(q, k, v, d**-0.5)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches_by_route == {"tma_mid": 1}
    assert fa.flash_attention_fwd_tma_wide.launches == 1
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, d**-0.5)
    for got_o, got_lse in ((o, lse), (o_w, lse_w)):
        torch.testing.assert_close(got_o.float(), o_ref.float(), atol=TOL["bfloat16"]["o"], rtol=0)
        torch.testing.assert_close(got_lse, lse_ref, atol=TOL["bfloat16"]["lse"], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,sk,d", [(64, 2704, 2704, 80), (3, 1000, 1100, 96), (1, 130, 129, 84),
                                        (2, 1500, 1300, 128)])
def test_f32_mid_forward_matches_the_wide_kernel_it_replaced(bh, sq, sk, d):
    """f32 at 64 < D <= 128 (SD1.5's 640-channel level at 832x832 is (64,
    2704, 80); D = 96, 84 and 128 off the tiles): ``flash_attention_fwd``
    takes route f32_mid and only its counter moves; the wide f32 kernel it
    replaced there (``flash_attention_fwd_f32_wide``, counted apart) gives
    O and lse within the f32 bounds of the same plain version."""
    _need_cuda()
    q, k, v, _ = _qkv(bh, sq, sk, d, "float32", seed=16)
    assert fa.forward_route(q, k, v) == "f32_mid"
    fa.reset_launch_counts()
    o, lse = fa.flash_attention_fwd(q, k, v)
    o_w, lse_w = fa.flash_attention_fwd_f32_wide(q, k, v, d**-0.5)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches_by_route == {"f32_mid": 1}
    assert fa.flash_attention_fwd_f32_wide.launches == 1
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, d**-0.5)
    for got_o, got_lse in ((o, lse), (o_w, lse_w)):
        torch.testing.assert_close(got_o, o_ref, atol=TOL["float32"]["o"], rtol=0)
        torch.testing.assert_close(got_lse, lse_ref, atol=TOL["float32"]["lse"], rtol=0)


@pytest.mark.cuda
def test_fused_wide_backward_takes_only_its_route():
    """The wide-head wrapper raises on what it does not take (f32, D <= 64,
    D % 8 != 0, D > 128); ``flash_attention_bwd`` sends those elsewhere."""
    _need_cuda()
    for dtype, d in (("float32", 80), ("bfloat16", 64), ("bfloat16", 84), ("bfloat16", 136)):
        q, k, v, do = _qkv(1, 64, 64, d, dtype)
        lse = torch.zeros(1, 64, device="cuda")
        assert not fa.takes_fused_wide_backward(q, k, v, do)
        with pytest.raises(ValueError, match="flash_attention_bwd_fused_wide takes"):
            fa.flash_attention_bwd_fused_wide(q, k, v, do, lse, lse, 0.1)


@pytest.mark.cuda
def test_fused_backward_takes_only_its_route():
    """The fused wrapper raises on what it does not take (f32, D % 8 != 0,
    D > 64) rather than computing it; ``flash_attention_bwd`` sends those to
    the wide-head kernel or the CUDA-core kernels."""
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


def _same_as_leaf_table(grad, codes, scales, compander):
    """The leaf-table kernel's codes, scales and signs on a one-leaf table
    of these bytes (a 1-D leaf: its layouts agree)."""
    c, s = codes.clone(), scales.clone()
    table = lk.LeafTable([c], [s], [(grad.numel(),)], [None])
    # a copy: the leaf table takes only grads on 16-byte boundaries
    upd = lk.lion8bit_update_leaves_([grad.reshape(-1).clone()], table, compander=compander)[0]
    return upd, c, s


@pytest.mark.cuda
@pytest.mark.parametrize("compander", ["exact", "fast"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bs", lk.BLOCK_SIZES)
def test_stream_kernel_matches_plain_version_at_every_block_size(bs, dtype, compander):
    """``lion_stream_kernel`` behind all three entries on a leaf list of
    mixed sizes: a ragged last tile, a leaf shorter than one tile, one of
    exactly one tile, one of a block, and a grad that starts 4 bytes off a
    16-byte boundary (every tile by plain loads). Signs and scales equal
    the plain version's, codes at most one apart from it and bitwise the
    leaf-table kernel's; one launch a call on each entry."""
    _need_cuda()
    itemsize = torch.empty((), dtype=dtype).element_size()
    per_tile = lk.stream_tile_elements(bs, itemsize) // bs
    n_blocks = [3 * per_tile + 7, per_tile // 2 + 1, per_tile, 1, 2 * per_tile + 5]
    grads, codes, scales = _lion_leaves([nb * bs for nb in n_blocks], bs, dtype, seed=bs + 31)
    off = torch.empty(grads[-1].numel() + 16 // itemsize, dtype=dtype, device="cuda")
    grads[-1] = off[4 // itemsize:4 // itemsize + grads[-1].numel()].copy_(grads[-1])
    assert grads[-1].data_ptr() % 16 == 4
    expected = [lk.lion8bit_update_reference(g, c, s, compander=compander) for g, c, s in zip(grads, codes, scales)]
    lk.reset_launch_counts()
    single = [(c.clone(), s.clone()) for c, s in zip(codes, scales)]
    upd_single = [lk.lion8bit_update_(g, c, s, compander=compander) for g, (c, s) in zip(grads, single)]
    multi = [(c.clone(), s.clone()) for c, s in zip(codes, scales)]
    upd_multi = lk.lion8bit_update_multi_(grads, [c for c, _ in multi], [s for _, s in multi], compander=compander)
    layouts = ["narrow"] + (["wide"] if bs < 128 and compander == "exact" else [])
    fused = {layout: [lk.fused_lion8bit_update(g, c, s[:, None], layout=layout, compander=compander)
                      for g, c, s in zip(grads, codes, scales)] for layout in layouts}
    table = [_same_as_leaf_table(g, c, s, compander) for g, c, s in zip(grads, codes, scales)]
    torch.cuda.synchronize()
    assert lk.lion8bit_update_.launches == len(n_blocks) and lk.lion8bit_update_multi_.launches == 1
    assert lk.fused_lion8bit_update.launches == len(n_blocks) * len(layouts)
    for i, (e_upd, e_codes, e_scales) in enumerate(expected):
        runs = [(upd_single[i], *single[i]), (upd_multi[i], *multi[i])]
        runs += [(f[i][0], f[i][1], f[i][2][:, 0]) for f in fused.values()]
        t_upd, t_codes, t_scales = table[i]
        for u, c, s in runs:
            assert u.dtype == dtype and u.shape == grads[i].shape
            torch.testing.assert_close(u, e_upd, atol=0, rtol=0)
            torch.testing.assert_close(s, e_scales, atol=0, rtol=0)
            assert int((c.int() - e_codes.int()).abs().max()) <= 1
            assert torch.equal(c, t_codes) and torch.equal(s, t_scales) and torch.equal(u, t_upd)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bs", lk.BLOCK_SIZES)
def test_stream_kernel_wraps_its_ring(bs, dtype):
    """Leaf lists long enough that every persistent CTA walks its ring of
    stages several times (the grid is at most SMs x 4 CTAs, each with 4
    stages): a large aligned leaf; then, in the middle of the list, a leaf
    with a ragged tail, a leaf whose grad starts 4 bytes off a 16-byte
    boundary (every tile by plain loads, more tiles than the grid) and a
    leaf of one block; then another large aligned leaf. So a CTA's walk
    takes plain-load tiles between bulk ones and refills each stage after
    its stores. Single-leaf and multi-leaf entries, exact compander: signs
    and scales equal the plain version's, codes at most one apart."""
    _need_cuda()
    itemsize = torch.empty((), dtype=dtype).element_size()
    per_tile = lk.stream_tile_elements(bs, itemsize) // bs
    ring = torch.cuda.get_device_properties(0).multi_processor_count * 4 * 4  # tiles the largest grid holds
    n_blocks = [2 * ring * per_tile, 37 * per_tile + 5, (3 * ring // 2) * per_tile, 1, ring * per_tile + 3]
    grads, codes, scales = _lion_leaves([nb * bs for nb in n_blocks], bs, dtype, seed=bs + 57)
    off = torch.empty(grads[2].numel() + 16 // itemsize, dtype=dtype, device="cuda")
    grads[2] = off[4 // itemsize:4 // itemsize + grads[2].numel()].copy_(grads[2])
    assert grads[2].data_ptr() % 16 == 4
    expected = [lk.lion8bit_update_reference(g, c, s) for g, c, s in zip(grads, codes, scales)]
    lk.reset_launch_counts()
    single = [(c.clone(), s.clone()) for c, s in zip(codes, scales)]
    upd_single = [lk.lion8bit_update_(g, c, s) for g, (c, s) in zip(grads, single)]
    multi = [(c.clone(), s.clone()) for c, s in zip(codes, scales)]
    upd_multi = lk.lion8bit_update_multi_(grads, [c for c, _ in multi], [s for _, s in multi])
    torch.cuda.synchronize()
    assert lk.lion8bit_update_.launches == len(n_blocks) and lk.lion8bit_update_multi_.launches == 1
    for i, (e_upd, e_codes, e_scales) in enumerate(expected):
        for u, (c, s) in ((upd_single[i], single[i]), (upd_multi[i], multi[i])):
            torch.testing.assert_close(u, e_upd, atol=0, rtol=0)
            torch.testing.assert_close(s, e_scales, atol=0, rtol=0)
            assert int((c.int() - e_codes.int()).abs().max()) <= 1


@pytest.mark.cuda
def test_stream_tile_is_the_librarys(monkeypatch):
    """The multi-leaf entry cuts its leaf list by the Python model's tile
    (``stream_tile_elements``), and the library launches only on its own:
    at every block size and grad dtype, the list cut by that tile updates
    as the plain version does, and one cut by twice or half of it is
    refused, with nothing launched."""
    _need_cuda()
    tile = lk.stream_tile_elements
    for bs in lk.BLOCK_SIZES:
        for dtype in (torch.bfloat16, torch.float32):
            itemsize = torch.empty((), dtype=dtype).element_size()
            nb = 3 * tile(bs, itemsize) // bs + 5
            (grad,), (codes,), (scales,) = _lion_leaves([nb * bs], bs, dtype, seed=bs)
            e_upd, _, e_scales = lk.lion8bit_update_reference(grad, codes, scales)
            for factor in (2, 0.5):
                monkeypatch.setattr(lk, "stream_tile_elements", lambda b, i: int(tile(b, i) * factor))
                c, s = codes.clone(), scales.clone()
                lk.reset_launch_counts()
                with pytest.raises(RuntimeError, match="launch failed"):
                    lk.lion8bit_update_multi_([grad], [c], [s])
                assert lk.lion8bit_update_multi_.launches == 0
                assert torch.equal(c, codes) and torch.equal(s, scales), (bs, dtype, factor)
            monkeypatch.setattr(lk, "stream_tile_elements", tile)
            c, s = codes.clone(), scales.clone()
            (upd,) = lk.lion8bit_update_multi_([grad], [c], [s])
            torch.cuda.synchronize()
            assert torch.equal(upd, e_upd) and torch.equal(s, e_scales), (bs, dtype)


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


# ragged leaf sets for the leaf-table entry: (torch shape, permutation to
# the JAX layout); tiles that end inside a leaf (columns and output-channel
# groups off the tile), one-tile leaves, Conv and Dense mixed, leaves whose
# layouts agree (1-D, no permutation)
def _table_leaves(bs):
    return [
        ((2 * bs, 48), (1, 0)),  # one tile: 2 blocks a column, 48 of 64 columns
        ((5 * bs, 8, 3, 3), (2, 3, 1, 0)),  # a Conv: 72 columns, 5 blocks a column
        ((3 * bs, 4096 + 24), (1, 0)),  # columns off the tile, several column tiles
        ((bs * 300,), None),  # 1-D: contiguous blocks
        ((7, 2 * bs), None),  # no permutation
        ((16 * bs, 320, 1, 1), (2, 3, 1, 0)),  # a 1x1 Conv
        ((bs, 5), (1, 0)),  # 5 columns: not a multiple of a 16-byte vector
    ]


def _table_inputs(leaves, bs, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    grads, codes, scales = [], [], []
    for shape, _ in leaves:
        grads.append((torch.randn(shape, generator=gen, device="cuda") * 1e-3).to(dtype))
        c, s = lk.block_quantize(torch.randn(shape, generator=gen, device="cuda").reshape(-1) * 1e-4, bs)
        codes.append(c)
        scales.append(s)
    return grads, codes, scales


@pytest.mark.cuda
@pytest.mark.parametrize("compander", ["exact", "fast"])
@pytest.mark.parametrize("bs,dtype", [(16, torch.bfloat16), (16, torch.float32), (64, torch.bfloat16),
                                      (64, torch.float32), (128, torch.bfloat16), (128, torch.float32),
                                      (1, torch.bfloat16), (8, torch.float32), (32, torch.bfloat16)])
def test_leaf_table_kernel_matches_plain_version(bs, dtype, compander):
    """``lion8bit_update_leaves_`` on a ragged leaf set against
    ``lion8bit_update_leaves_reference``: update signs (torch layout) and
    scales equal, codes at most one apart and equal to the single-leaf
    kernel's (both are powf's); one launch, counted there alone."""
    _need_cuda()
    leaves = _table_leaves(bs)
    perms = [perm for _, perm in leaves]
    grads, codes, scales = _table_inputs(leaves, bs, dtype, seed=bs + 3)
    e_upd, e_codes, e_scales = lk.lion8bit_update_leaves_reference(grads, codes, scales, perms, compander=compander)
    table_c, table_s = [c.clone() for c in codes], [s.clone() for s in scales]
    table = lk.LeafTable(table_c, table_s, [shape for shape, _ in leaves], perms)
    lk.reset_launch_counts()
    upds = lk.lion8bit_update_leaves_(grads, table, compander=compander)
    torch.cuda.synchronize()
    n = sum(g.numel() for g in grads)
    assert lk.lion8bit_update_leaves_.launches_by_shape == {
        (len(leaves), n, bs, str(dtype).replace("torch.", "")): 1
    }
    assert lk.lion8bit_update_.launches == lk.lion8bit_update_multi_.launches == 0
    single_c = [c.clone() for c in codes]
    for g, c, s, perm in zip(grads, single_c, [s.clone() for s in scales], perms):
        lk.lion8bit_update_((g.permute(*perm) if perm else g).contiguous(), c, s, compander=compander)
    torch.cuda.synchronize()
    for u, g, e, c, ec, sc, s, es in zip(upds, grads, e_upd, table_c, e_codes, single_c, table_s, e_scales):
        assert u.dtype == dtype and u.shape == g.shape and u.is_contiguous()
        torch.testing.assert_close(u, e, atol=0, rtol=0)
        torch.testing.assert_close(s, es, atol=0, rtol=0)
        assert int((c.int() - ec.int()).abs().max()) <= 1
        assert torch.equal(c, sc)


@pytest.mark.cuda
def test_leaf_the_table_cannot_take_goes_the_old_route():
    """A quantized Conv kernel whose axis 0 ``bs`` does not divide (``conv_out``
    if a user quantizes it) is permuted and updated by the single-leaf entry,
    counted there; the other leaves take one launch of the leaf table."""
    _need_cuda()
    from stable_diffusion_training_tpu_torch.optim import scale_by_lion_8bit
    from stable_diffusion_training_tpu_torch.optim.lion8bit import GRAD_COPIES

    shapes = {"conv_out": (4, 320, 3, 3), "proj": (64, 320), "conv": (32, 16, 3, 3)}
    orders = {"conv_out": (2, 3, 1, 0), "proj": (1, 0), "conv": (2, 3, 1, 0)}
    params = {k: torch.zeros(s, device="cuda", dtype=torch.bfloat16) for k, s in shapes.items()}
    tx = scale_by_lion_8bit(block_size=16, excluded_layer_mask=True, leaf_orders=orders)
    cpu_tx = scale_by_lion_8bit(block_size=16, excluded_layer_mask=True, leaf_orders=orders)
    state, cpu_state = tx.init(params), cpu_tx.init({k: p.cpu() for k, p in params.items()})
    gen = torch.Generator(device="cuda").manual_seed(11)
    lk.reset_launch_counts()
    copies = 0
    for _ in range(2):
        grads = {k: (torch.randn(s, generator=gen, device="cuda") * 1e-3).bfloat16() for k, s in shapes.items()}
        GRAD_COPIES["count"] = 0
        upd, state = tx.update(grads, state)
        copies += GRAD_COPIES["count"]
        cpu_upd, cpu_state = cpu_tx.update({k: g.cpu() for k, g in grads.items()}, cpu_state)
        torch.cuda.synchronize()
        for k in shapes:
            torch.testing.assert_close(upd[k].cpu(), cpu_upd[k], atol=0, rtol=0)
            torch.testing.assert_close(state.mu_quant[k].scales.cpu(), cpu_state.mu_quant[k].scales, atol=0, rtol=0)
    assert lk.lion8bit_update_.launches_by_shape == {(4 * 320 * 9 // 16, 16, "bfloat16"): 2}
    assert lk.lion8bit_update_leaves_.launches_by_shape == {(2, 64 * 320 + 32 * 16 * 9, 16, "bfloat16"): 2}
    assert lk.lion8bit_update_multi_.launches == 0
    assert copies == 2  # the old route's permute copy, once a step


@pytest.mark.cuda
def test_leaf_table_momentum_is_the_single_leaf_kernels():
    """Both kernels dequantize through the 256-entry table and requantize
    through the SFU's approximation of powf, calling powf only near a
    half-integer. The plain version on the card computes both outright
    (torch's pow of a float tensor on CUDA is CUDA's powf), so it is the
    reference here, bit for bit, for the leaf-table kernel and the stream
    kernel (single-leaf entry), with both companders:

    - the dequant: at bs 1 with b2 = 1 the new momentum is the dequantized
      code over its scale and the new scale 1 / |momentum|; over every code
      under 2^20 scales spread across 2^-20 ... 2^40 (and 1, the zero
      guard's), scales, codes and signs are equal;
    - the requantization: at bs 128 with f32 grads and b2 = 0 the new
      momentum is the grad, and every block holds a 1.0, so its new scale
      is 1 and each other code is rint(127 powf(|g + off|, 0.2)) with its
      sign. Over 2^20 grads, half of them put 127 |g + off|^0.2 within four
      kRoundMargin of a half-integer (every code's rounding boundary, both
      signs, where the approximation gives way to powf) and half spread
      across 2^-30 ... 1, codes, scales and signs are equal.
    """
    _need_cuda()
    n = 256 << 12
    gen = torch.Generator(device="cuda").manual_seed(21)
    codes = (torch.arange(n, device="cuda") % 256 - 128).to(torch.int8).reshape(n, 1)
    exponent = torch.randint(-20, 40, (n,), generator=gen, device="cuda").float()
    scales = torch.exp2(exponent) * (1 + torch.rand(n, generator=gen, device="cuda"))
    scales[::97] = 1.0
    grad = (torch.randn(n, generator=gen, device="cuda") * 1e-3).bfloat16()
    # requantization sweep: y = 127 |x|^0.2 at k + 1/2 + t, |t| <= 4 / 1024 (kRoundMargin 1 / 1024)
    half = n // 2
    k = torch.randint(0, 127, (half,), generator=gen, device="cuda", dtype=torch.float64)
    t = (torch.rand(half, generator=gen, device="cuda", dtype=torch.float64) * 2 - 1) * 4 / 1024
    near = ((k + 0.5 + t) / 127) ** 5
    spread = torch.exp2(-30 * torch.rand(n - half, generator=gen, device="cuda", dtype=torch.float64))
    x = torch.cat([near, spread])
    x = x[torch.randperm(n, generator=gen, device="cuda")]
    sign = torch.where(torch.rand(n, generator=gen, device="cuda") < 0.5, -1.0, 1.0).double()
    sweep = (sign * x).float() - lk.ZERO_CROSSING_OFFSET  # g + off = +-x, rounded as the kernels do
    sweep = sweep.reshape(-1, 128)
    sweep[:, 0] = 1.0  # each block's absmax: new scale 1
    sweep = sweep.reshape(-1)
    sweep_codes, sweep_scales = lk.block_quantize(torch.randn(n, generator=gen, device="cuda") * 1e-4, 128)
    cases = [("dequant", grad, codes, scales, 1.0), ("requantize", sweep, sweep_codes, sweep_scales, 0.0)]
    for name, g, c0, s0, b2 in cases:
        for compander in ("exact", "fast"):
            e_upd, e_codes, e_scales = lk.lion8bit_update_reference(g, c0, s0, b1=0.9, b2=b2, compander=compander)
            table_c, table_s = c0.clone(), s0.clone()
            table = lk.LeafTable([table_c], [table_s], [(n,)], [None])
            upd = lk.lion8bit_update_leaves_([g], table, b1=0.9, b2=b2, compander=compander)[0]
            single_c, single_s = c0.clone(), s0.clone()
            single_upd = lk.lion8bit_update_(g, single_c, single_s, b1=0.9, b2=b2, compander=compander)
            torch.cuda.synchronize()
            for kernel, (u, c, s) in (("leaves", (upd, table_c, table_s)), ("stream", (single_upd, single_c, single_s))):
                assert torch.equal(s, e_scales), (name, compander, kernel)
                assert torch.equal(u, e_upd), (name, compander, kernel)
                assert torch.equal(c, e_codes), (name, compander, kernel, int((c != e_codes).sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,d,dtype", [(40, 4096, 64, "bfloat16"), (40, 4032, 64, "bfloat16"),
                                           (10, 4096, 64, "float32")])
def test_sdxl_train_backward_shapes_match_plain_version(bh, sq, d, dtype):
    """The backward at SDXL training's shapes: the 64x64 level at batch 4
    (40 heads of 64 over 4,096 tokens), the 1152x896 bucket's 72x56 level
    (4,032 tokens, no multiple of the 128-row tiles) on the fused bf16
    kernel, and the f32 parity step's (batch 1) on the fused f32 kernel; one
    launch of the route's kernel, each grad within the bounds above."""
    _need_cuda()
    q, k, v, do = _qkv(bh, sq, sq, d, dtype, seed=12)
    scale = d**-0.5
    o, lse = fa.flash_attention_fwd(q, k, v, scale)
    delta = (do.float() * o.float()).sum(-1)
    fa.reset_launch_counts()
    grads = fa.flash_attention_bwd(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()
    route = fa.backward_route(q, k, v, do)
    assert route == ("fused" if dtype == "bfloat16" else "f32_fused")
    assert _bwd_launches() == ROUTE_LAUNCHES[route]
    expected = fa.flash_attention_bwd_reference(q, k, v, do, lse, delta, scale)
    for name, got, want in zip(("dq", "dk", "dv"), grads, expected):
        assert got.dtype == want.dtype and got.shape == want.shape, name
        got, want = got.float(), want.float()
        torch.testing.assert_close(got, want, atol=TOL[dtype]["grad"] * want.abs().max().item(), rtol=0, msg=name)
        assert (got - want).norm().item() <= TOL[dtype]["grad_fro"] * want.norm().item(), name


def _sdxl_scale_leaves():
    """1,100 leaves, 2,219,680,000 elements: more than one launch holds
    (``MAX_LEAVES_PER_LAUNCH``) and more than 2^31 elements, as the SDXL
    UNet's 773 quantized leaves (2,546,196,480 elements) are. Dense kernels
    (640, 3200), 3x3 Convs (320, 640) and 1-D leaves, interleaved, so that
    both launches hold every kind; the update buffer's runs (one per shape,
    the Dense run last) put the last Dense leaves' updates above element
    2^31."""
    leaves = []
    for i in range(1100):
        if i % 22 == 0:
            leaves.append(((2_000_000,), None))
        elif i % 22 < 4:
            leaves.append(((320, 640, 3, 3), (2, 3, 1, 0)))
        else:
            leaves.append(((640, 3200), (1, 0)))
    return leaves


@pytest.mark.cuda
def test_leaf_table_over_two_launches_and_2_to_31_elements():
    """``lion8bit_update_leaves_`` on a table of more than
    ``MAX_LEAVES_PER_LAUNCH`` leaves and 2^31 elements against its plain
    version: two launches (1,024 leaves, then 76), counted by their own
    leaves and elements; update signs and scales equal, codes at most one
    apart, every leaf's update where its 64-bit offset says."""
    _need_cuda()
    leaves = _sdxl_scale_leaves()
    perms = [perm for _, perm in leaves]
    shapes = [shape for shape, _ in leaves]
    sizes = [int(np.prod(s)) for s in shapes]
    assert sum(sizes) > 2**31 and len(leaves) > lk.MAX_LEAVES_PER_LAUNCH
    grads, codes, scales = _table_inputs(leaves, 16, torch.bfloat16, seed=31)
    table_c, table_s = [c.clone() for c in codes], [s.clone() for s in scales]
    table = lk.LeafTable(table_c, table_s, shapes, perms)
    assert table.upd_numel > 2**31 and max(table.upd_off) > 2**31
    lk.reset_launch_counts()
    upds = lk.lion8bit_update_leaves_(grads, table)
    torch.cuda.synchronize()
    first = lk.MAX_LEAVES_PER_LAUNCH
    assert lk.lion8bit_update_leaves_.launches_by_shape == {
        (first, sum(sizes[:first]), 16, "bfloat16"): 1,
        (len(leaves) - first, sum(sizes[first:]), 16, "bfloat16"): 1,
    }
    assert lk.lion8bit_update_.launches == lk.lion8bit_update_multi_.launches == 0
    for i, (g, c, s, perm) in enumerate(zip(grads, codes, scales, perms)):
        e_upd, e_codes, e_scales = lk.lion8bit_update_leaves_reference([g], [c], [s], [perm])
        assert upds[i].shape == g.shape and upds[i].is_contiguous(), i
        assert upds[i].data_ptr() == upds[0].data_ptr() - 2 * table.upd_off[0] + 2 * table.upd_off[i], i
        torch.testing.assert_close(upds[i], e_upd[0], atol=0, rtol=0, msg=str(i))
        torch.testing.assert_close(table_s[i], e_scales[0], atol=0, rtol=0, msg=str(i))
        assert int((table_c[i].int() - e_codes[0].int()).abs().max()) <= 1, i
