"""The stream kernel's tiles (``lion_stream_kernel``, behind
``lion8bit_update_``, ``lion8bit_update_multi_`` and ``fused_lion8bit_update``)
in plain torch, on the CPU.

The kernel runs only on the card (``tests/test_torch_port_cuda.py`` holds it
against the plain version there). Here the model of its tiles in
``ops/lion_kernel.py`` (``stream_tiles``: each tile's leaf, block range and
whether bulk copies or plain loads move it) is held against the flat
reference order on ragged leaf lists at every block size, for bf16 and f32
grads:

- every block (its elements and its scale) of every leaf is covered once;
- a bulk-copied run is 16-byte aligned and a multiple of 16 bytes, and only
  a ragged last tile or a leaf off a 16-byte boundary goes by plain loads;
- the update assembled tile by tile from the plain version equals the plain
  version over the whole leaf, bit for bit, and that equals the JAX
  package's ``fused_lion8bit_update`` (K6, Pallas in interpret mode) within
  ``tests/test_torch_port_lion_layouts.py``'s bounds: signs equal, codes at
  most one apart, scales within 1e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_diffusion_training_tpu.ops.lion_kernel import fused_lion8bit_update as jax_fused
from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk
from torch_threads import _one_thread  # noqa: F401 (the fixture)

ITEMSIZE = {torch.bfloat16: 2, torch.float32: 4}


def _leaf_list(bs, itemsize):
    """Block counts of a ragged leaf list (a ragged last tile, a leaf
    shorter than one tile, one of exactly one tile, one block, several
    tiles) and each leaf's (grad, codes, scales, signs) byte addresses: the
    last leaf's grad starts 4 bytes off a 16-byte boundary."""
    per_tile = lk.stream_tile_elements(bs, itemsize) // bs
    n_blocks = [3 * per_tile + 7, per_tile // 2 + 1, per_tile, 1, 2 * per_tile + 5]
    bases = [(1 << 20) * (4 * i + 1) for i in range(len(n_blocks))]
    addresses = [(b, b + (1 << 18), b + (2 << 18), b + (3 << 18)) for b in bases]
    g, c, s, u = addresses[-1]
    addresses[-1] = (g + 4, c, s, u)
    return n_blocks, addresses


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bs", lk.BLOCK_SIZES)
def test_stream_tiles_cover_each_block_once(bs, dtype):
    itemsize = ITEMSIZE[dtype]
    n_blocks, addresses = _leaf_list(bs, itemsize)
    per_tile = lk.stream_tile_elements(bs, itemsize) // bs
    tiles = lk.stream_tiles(n_blocks, bs, itemsize, addresses)
    covered = [np.zeros(nb, dtype=np.int64) for nb in n_blocks]
    for leaf, b0, blocks, bulk in tiles:
        assert 0 < blocks <= per_tile and b0 % per_tile == 0
        covered[leaf][b0:b0 + blocks] += 1
        g, c, s, u = addresses[leaf]
        runs = [(g + b0 * bs * itemsize, blocks * bs * itemsize), (c + b0 * bs, blocks * bs),
                (s + b0 * 4, blocks * 4), (u + b0 * bs * itemsize, blocks * bs * itemsize)]
        aligned = all(start % 16 == 0 and size % 16 == 0 for start, size in runs)
        assert bulk == aligned
        if leaf < len(n_blocks) - 1 and blocks == per_tile:
            assert bulk  # a full tile of an aligned leaf is bulk-copied
    for leaf, c in enumerate(covered):
        assert (c == 1).all(), leaf
    # tiles run leaf by leaf, in block order
    assert [(leaf, b0) for leaf, b0, _, _ in tiles] == sorted((leaf, b0) for leaf, b0, _, _ in tiles)
    assert not any(bulk for leaf, _, _, bulk in tiles if leaf == len(n_blocks) - 1)  # the grad off 16 bytes


def _inputs(n_blocks, bs, dtype, seed):
    rng = np.random.RandomState(seed)
    grads, codes, scales = [], [], []
    for nb in n_blocks:
        grads.append(torch.tensor(rng.randn(nb * bs).astype(np.float32) * 1e-3).to(dtype))
        c, s = lk.block_quantize(torch.tensor(rng.randn(nb * bs).astype(np.float32) * 1e-4), bs)
        codes.append(c)
        scales.append(s)
    return grads, codes, scales


def _by_tiles(grads, codes, scales, bs, addresses):
    """The update as the kernel assembles it: the plain version over each
    tile's blocks, written back into the leaf at the tile's range; every
    element written once."""
    itemsize = ITEMSIZE[grads[0].dtype]
    out = [(torch.empty_like(g), torch.empty_like(c), torch.empty_like(s)) for g, c, s in zip(grads, codes, scales)]
    written = [np.zeros(g.numel(), dtype=np.int64) for g in grads]
    n_blocks = [c.shape[0] for c in codes]
    for leaf, b0, blocks, _ in lk.stream_tiles(n_blocks, bs, itemsize, addresses):
        e_lo, e_hi = b0 * bs, (b0 + blocks) * bs
        upd, new_c, new_s = lk.lion8bit_update_reference(
            grads[leaf][e_lo:e_hi], codes[leaf][b0:b0 + blocks], scales[leaf][b0:b0 + blocks])
        u, c, s = out[leaf]
        u[e_lo:e_hi] = upd
        c[b0:b0 + blocks] = new_c
        s[b0:b0 + blocks] = new_s
        written[leaf][e_lo:e_hi] += 1
    assert all((w == 1).all() for w in written)
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bs", lk.BLOCK_SIZES)
def test_tile_by_tile_update_is_the_flat_reference(bs, dtype):
    n_blocks, addresses = _leaf_list(bs, ITEMSIZE[dtype])
    grads, codes, scales = _inputs(n_blocks, bs, dtype, seed=bs)
    for (u, c, s), g, c0, s0 in zip(_by_tiles(grads, codes, scales, bs, addresses), grads, codes, scales):
        e_upd, e_codes, e_scales = lk.lion8bit_update_reference(g, c0, s0)
        assert torch.equal(u, e_upd) and torch.equal(c, e_codes) and torch.equal(s, e_scales)


@pytest.mark.parametrize("bs", [4, 16, 128])
def test_tile_by_tile_update_matches_jax_k6(bs):
    """One leaf of three tiles and a ragged tail, f32 grads, against the
    JAX package's narrow entry (K6) in interpret mode."""
    per_tile = lk.stream_tile_elements(bs, 4) // bs
    n_blocks = [3 * per_tile + 5]
    grads, codes, scales = _inputs(n_blocks, bs, torch.float32, seed=bs + 7)
    (upd, new_codes, new_scales), = _by_tiles(grads, codes, scales, bs, [(0, 0, 0, 0)])
    j_upd, j_codes, j_scales = jax_fused(
        jnp.asarray(grads[0].numpy()), jnp.asarray(codes[0].numpy()), jnp.asarray(scales[0].numpy())[:, None],
        b1=0.9, b2=0.99, interpret=True, layout="narrow")
    np.testing.assert_array_equal(upd.numpy(), np.asarray(j_upd))
    assert np.abs(new_codes.numpy().astype(np.int32) - np.asarray(j_codes).astype(np.int32)).max() <= 1
    np.testing.assert_allclose(new_scales.numpy(), np.asarray(j_scales)[:, 0], rtol=1e-6, atol=0)
