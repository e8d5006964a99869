"""The leaf-table Lion entry (``lion8bit_update_leaves_``) on the CPU.

On the CPU the entry takes its plain version,
``lion8bit_update_leaves_reference`` (permute the torch-layout grad into JAX
order, ``lion8bit_update_reference``, the update back through the inverse
permutation), which ``chip_smoke.py`` and ``tests/test_torch_port_cuda.py``
hold the CUDA kernel against on the card. Here that plain version is held
against the JAX package, and a plain-torch model of the kernel's addressing
(``leaf_tile_addresses``) against ``permute(perm).reshape(-1, bs)``.

Reference: the JAX package's ``scale_by_lion_8bit(use_pallas=False)`` (its
jnp path, eager) from the same momentum, with the grad given in f32: the
kernel upcasts the grad to f32 before ``(1 - b1) g``, so for a bf16 grad
the jnp path on its f32 values is the same arithmetic. Tolerances, and why:
- update signs: equal (the dequant and the Lion direction are the same f32
  operations in the same order);
- scales: equal (the new momentum is, and absmax does not depend on order);
- codes: at most one apart, counted (XLA's f32 pow and torch's may differ
  by an ulp at a rounding boundary).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_diffusion_training_tpu.optim.lion8bit import scale_by_lion_8bit as jax_scale_by_lion_8bit
from stable_diffusion_training_tpu_torch.models.hf_io import momentum_from_jax
from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk
from stable_diffusion_training_tpu_torch.optim import scale_by_lion_8bit
from stable_diffusion_training_tpu_torch.optim.lion8bit import GRAD_COPIES
from torch_threads import _one_thread  # noqa: F401 (the fixture)

DENSE, CONV = (1, 0), (2, 3, 1, 0)


def _rand(shape, seed, scale):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _jax_layout(shape, perm):
    return tuple(shape[i] for i in perm) if perm else tuple(shape)


@pytest.mark.parametrize("compander", ["exact", "fast"])
@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bs", [16, 64])
@pytest.mark.parametrize("shape,perm", [((32, 48), DENSE), ((32, 8, 3, 3), CONV)], ids=["dense", "conv"])
def test_plain_leaf_entry_matches_jax(shape, perm, bs, grad_dtype, compander):
    """A torch-layout Dense or Conv leaf through the entry's plain version
    (and through the entry itself where a table takes the leaf) against the
    JAX jnp path on the JAX-layout leaf, from momentum after one update."""
    jshape = _jax_layout(shape, perm)
    tx = jax_scale_by_lion_8bit(block_size=bs, excluded_layer_mask=True, use_pallas=False, compander=compander)
    state = tx.init({"w": jnp.zeros(jshape)})
    _, state = tx.update({"w": jnp.asarray(_rand(jshape, 1, 1e-3))}, state)
    codes, scales = momentum_from_jax(*state.mu_quant["w"])
    g_torch = torch.tensor(_rand(shape, 2, 1e-2)).to(getattr(torch, grad_dtype))
    # the grad's own values, in f32 and in the JAX layout
    g_jax = g_torch.float().permute(*perm).contiguous().numpy()
    j_upd, j_state = tx.update({"w": jnp.asarray(g_jax)}, state)
    e_codes, e_scales = momentum_from_jax(*j_state.mu_quant["w"])
    e_upd = torch.tensor(np.asarray(j_upd["w"])).permute(*lk.inverse_permutation(perm))

    (upd,), (new_codes,), (new_scales,) = lk.lion8bit_update_leaves_reference(
        [g_torch], [codes], [scales], [perm], compander=compander)
    results = [(upd, new_codes, new_scales)]
    if lk.table_takes(shape, perm, bs):
        c, s = codes.clone(), scales.clone()
        (u,) = lk.lion8bit_update_leaves_([g_torch], lk.LeafTable([c], [s], [shape], [perm]), compander=compander)
        results.append((u, c, s))
    else:
        assert shape[0] % bs  # only a leaf whose axis 0 bs does not divide
    for u, c, s in results:
        assert u.dtype == g_torch.dtype and u.shape == g_torch.shape
        np.testing.assert_array_equal(u.float().numpy(), e_upd.numpy())
        np.testing.assert_array_equal(s.numpy(), e_scales.numpy())
        diff = (c.int() - e_codes.int()).abs()
        assert int(diff.max()) <= 1
        assert int((diff > 0).sum()) <= 1e-2 * diff.numel()


ADDRESS_CASES = [
    ((32, 48), DENSE, 16),  # one tile
    ((32, 8, 3, 3), CONV, 16),  # a Conv: columns i kh kw + h kw + w
    ((64, 8, 3, 3), CONV, 64),
    ((48, 1000), DENSE, 16),  # column tiles that end inside the leaf
    ((80, 70), DENSE, 16),  # 5 blocks a column: a row tile that ends inside the leaf
    ((256, 8, 3, 3), CONV, 128),
    ((1280, 100), DENSE, 32),
    ((16, 5, 1, 1), CONV, 1),
    ((96,), None, 16),  # layouts that agree: contiguous blocks
    ((40, 24), None, 8),
    ((320, 4, 3, 3), CONV, 8),
]


@pytest.mark.parametrize("shape,perm,bs", ADDRESS_CASES, ids=[f"{s}-{p}-bs{b}" for s, p, b in ADDRESS_CASES])
def test_kernel_addressing_reproduces_the_jax_blocks(shape, perm, bs):
    """The kernel's tile walk, modelled in torch: each thread's ``bs`` torch
    offsets are exactly its JAX block of ``p.permute(perm).reshape(-1, bs)``
    (the Conv column map included), and every block is some thread's once."""
    p = torch.arange(torch.Size(shape).numel()).reshape(shape)
    offsets, blocks = lk.leaf_tile_addresses(shape, perm, bs)
    groups, cols = lk.LEAF_TILE[bs]
    assert blocks.shape[1] == groups * cols and offsets.shape[2] == bs
    want = (p.permute(*perm) if perm else p).reshape(-1, bs)
    valid = blocks >= 0
    assert torch.equal(p.reshape(-1)[offsets[valid]], want[blocks[valid]])
    assert torch.equal(blocks[valid].sort().values, torch.arange(want.shape[0]))
    assert bool((offsets[~valid] == -1).all())
    if perm:  # neighbouring columns of a tile are neighbours in torch memory
        o = offsets[:, :, 0].reshape(offsets.shape[0], groups, cols)
        both = (o[..., 1:] >= 0) & (o[..., :-1] >= 0)
        assert bool((o[..., 1:] - o[..., :-1] == 1)[both].all())


def test_table_runs_views_and_checks():
    """The update buffer holds the leaves of one shape next to each other;
    views come back in the leaves' order, in torch shape; a table checks its
    leaves and is tied to its own codes and scales tensors."""
    leaves = [((32, 48), DENSE), ((96,), None), ((32, 48), DENSE), ((32, 8, 3, 3), CONV)]
    codes = [torch.zeros(torch.Size(s).numel() // 16, 16, dtype=torch.int8) for s, _ in leaves]
    scales = [torch.ones(c.shape[0]) for c in codes]
    table = lk.LeafTable(codes, scales, [s for s, _ in leaves], [p for _, p in leaves])
    assert table.upd_off[2] == table.upd_off[0] + 32 * 48
    assert all(off % 16 == 0 for shape, off, _ in table.runs)
    views = table.views(torch.arange(table.upd_numel, dtype=torch.float32))
    assert [tuple(v.shape) for v in views] == [s for s, _ in leaves]
    assert all(v.is_contiguous() and int(v.reshape(-1)[0]) == off for v, off in zip(views, table.upd_off))
    assert table.matches(codes, scales) and not table.matches([c.clone() for c in codes], scales)
    with pytest.raises(ValueError, match="does not take"):
        lk.LeafTable([torch.zeros(45, 16, dtype=torch.int8)], [torch.ones(45)], [(4, 20, 3, 3)], [CONV])
    with pytest.raises(ValueError, match="shaped as the table's leaves"):
        lk.lion8bit_update_leaves_([torch.zeros(48, 32)] + [torch.zeros(s) for s, _ in leaves[1:]], table)


def _update_twice(bucket_max_nb=0, shapes=None, orders=None, seed=0):
    shapes = shapes or {"conv_out": (4, 32, 3, 3), "proj": (64, 32), "conv": (32, 16, 3, 3), "b": (24,)}
    orders = orders or {"conv_out": CONV, "proj": DENSE, "conv": CONV}
    mask = {k: k != "b" for k in shapes}
    tx = scale_by_lion_8bit(block_size=16, excluded_layer_mask=mask, leaf_orders=orders,
                            bucket_max_nb=bucket_max_nb)
    state = tx.init({k: torch.zeros(s) for k, s in shapes.items()})
    outs = []
    for step in range(2):
        grads = {k: torch.tensor(_rand(s, seed + 10 * step + i, 1e-2)) for i, (k, s) in enumerate(shapes.items())}
        upd, state = tx.update(grads, state)
        outs.append((upd, {k: (m.codes.clone(), m.scales.clone()) for k, m in state.mu_quant.items()
                           if mask[k]}))
    return outs


def test_leaf_the_table_cannot_take_keeps_the_single_leaf_route():
    """``conv_out`` (axis 0 of 4, which bs 16 does not divide) is permuted
    into JAX order and updated on its own, the rest through the table; the
    result is the plain jnp path's, and the one grad copy a step is
    counted."""
    GRAD_COPIES["count"] = 0
    outs = _update_twice()
    assert GRAD_COPIES["count"] == 2
    shapes = {"conv_out": (4, 32, 3, 3), "proj": (64, 32), "conv": (32, 16, 3, 3), "b": (24,)}
    orders = {"conv_out": CONV, "proj": DENSE, "conv": CONV}
    plain = scale_by_lion_8bit(block_size=16, excluded_layer_mask={k: k != "b" for k in shapes},
                               leaf_orders=orders, use_pallas=False)
    state = plain.init({k: torch.zeros(s) for k, s in shapes.items()})
    grads = {k: torch.tensor(_rand(s, i, 1e-2)) for i, (k, s) in enumerate(shapes.items())}
    upd, _ = plain.update(grads, state)
    for k in shapes:  # f32 grads: the two paths' arithmetic agrees
        np.testing.assert_array_equal(outs[0][0][k].numpy(), upd[k].numpy(), err_msg=k)


def test_bucket_max_nb_changes_nothing():
    """``lion_bucket_max_nb`` stays accepted and no longer groups leaves:
    updates, codes and scales are bitwise the same for any value."""
    a, b = _update_twice(0), _update_twice(65536)
    for (ua, ma), (ub, mb) in zip(a, b):
        for k in ua:
            assert torch.equal(ua[k], ub[k])
        for k in ma:
            assert torch.equal(ma[k][0], mb[k][0]) and torch.equal(ma[k][1], mb[k][1])


@pytest.mark.parametrize("offset,ok", [(1, False), (2, False), (4, True)], ids=["4-bytes", "8-bytes", "16-bytes"])
def test_grads_off_16_byte_boundaries_raise(offset, ok):
    """A grad that is a view of a flat buffer (as the data-parallel
    all-reduce hands them out) must start on a 16-byte boundary, the
    kernel's ``cp.async`` width: the entry raises otherwise, on the CPU as
    on the card, before it reads a grad. On a boundary the view updates as
    a grad of its own would."""
    shape = (32, 48)
    g = torch.tensor(_rand(shape, 3, 1e-2))
    flat = torch.zeros(g.numel() + 8)
    view = flat[offset : offset + g.numel()].view(shape)
    view.copy_(g)
    codes, scales = torch.full((g.numel() // 16, 16), 3, dtype=torch.int8), torch.ones(g.numel() // 16)
    table = lk.LeafTable([codes], [scales], [shape], [DENSE])
    if not ok:
        with pytest.raises(ValueError, match="16-byte"):
            lk.lion8bit_update_leaves_([view], table)
        assert torch.equal(codes, torch.full_like(codes, 3)) and torch.equal(scales, torch.ones_like(scales))
        return
    fresh = lk.LeafTable([codes.clone()], [scales.clone()], [shape], [DENSE])
    (u_view,) = lk.lion8bit_update_leaves_([view], table)
    (u_own,) = lk.lion8bit_update_leaves_([g], fresh)
    assert torch.equal(u_view, u_own) and torch.equal(codes, fresh.codes[0]) and torch.equal(scales, fresh.scales[0])
