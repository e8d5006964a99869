"""The port's 8-bit Lion against the JAX package's, on the CPU.

On the CPU the kernel's wrappers take the plain version
(``lion8bit_update_reference``), so these tests hold that plain version,
which ``chip_smoke.py`` holds the CUDA kernel against on the card, to the
Pallas kernels run as ``tests/test_lion_kernel.py`` runs them
(``interpret=True``), and the port's optimizer to the JAX jnp path
(``use_pallas=False``), run eagerly. JAX momentum leaves cross into the
port's layout through ``models.hf_io.momentum_from_jax``.

Tolerances, and why:
- update signs: equal. The dequantized momentum is bitwise the JAX
  package's (same op order, no fused multiply-adds), and so is the Lion
  direction.
- codes: at most one apart, counted. XLA's f32 pow differs from torch's by
  an ulp on some inputs; where 127 |x|^(1/5) lies within that ulp of a
  rounding boundary the code moves by one.
- scales against the Pallas kernels: 1e-6 relative. Their interpret-mode
  lowering fuses ``(1 - b2) g + b2 mu`` into one FMA where the port rounds
  the two products; that moves the new momentum, hence a block's absmax and
  its scale, by an ulp.
- scales against the eager jnp path: equal on the first update (the same f32
  ops in the same order). On later updates a code that moved by one dequantizes to
  another momentum (up to 4% of its block's absmax, for codes near 127),
  which can move that block's next absmax: at most 1% of scales may differ,
  by at most 5% relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_diffusion_training_tpu.models import (
    CLIPTextModel as JaxCLIP,
    UNet2DConditionModel as JaxUNet,
    configs as jax_configs,
)
from stable_diffusion_training_tpu.ops.lion_kernel import (
    fused_lion8bit_update_dense,
    fused_lion8bit_update_transposed_packed,
)
from stable_diffusion_training_tpu.optim import create_mask as jax_create_mask
from stable_diffusion_training_tpu.optim.lion8bit import (
    momentum_to_reference_layout,
    scale_by_lion_8bit as jax_scale_by_lion_8bit,
)
from stable_diffusion_training_tpu_torch.models import CLIPTextModel, UNet2DConditionModel, configs
from stable_diffusion_training_tpu_torch.models.hf_io import jax_param_paths, momentum_from_jax
from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk
from stable_diffusion_training_tpu_torch.optim import (
    QuantizedMomentum,
    create_mask,
    lion,
    lion_8bit,
    scale_by_lion_8bit,
)

EXAMPLE_EXCLUSIONS = [  # model_properties_example.json
    "bias", "scale", "embedding", "conv_in", "conv_out", "time_embedding", "embeddings",
    "time_emb_proj",
]


def _rand(shape, seed, scale):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _jax_state_after(grads_np, bs, steps=1, **kw):
    """A JAX Lion state with real momentum: ``steps`` eager jnp updates."""
    tx = jax_scale_by_lion_8bit(block_size=bs, excluded_layer_mask=True, use_pallas=False, **kw)
    params = {k: jnp.zeros(v.shape) for k, v in grads_np.items()}
    state = tx.init(params)
    for i in range(steps):
        _, state = tx.update({k: jnp.asarray(v * (i + 1)) for k, v in grads_np.items()}, state)
    return state


def _assert_codes_close(got, expected, what):
    diff = (got.int() - expected.int()).abs()
    assert int(diff.max()) <= 1, what
    return int((diff > 0).sum())


@pytest.mark.parametrize("compander", ["exact", "fast"])
@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bs", [8, 16])
def test_plain_kernel_matches_jax_dense_kernel(bs, grad_dtype, compander):
    """K4's plain version against ``fused_lion8bit_update_dense``: a
    dense-layout leaf (size % 1024 == 0) with an all-zero grad block."""
    n = 4096
    mu0 = _rand((n,), 1, 1e-3)
    mu0[:bs] = 0.0
    state = _jax_state_after({"w": mu0}, bs, compander=compander)
    codes_d, scales_d = state.mu_quant["w"]
    assert scales_d.shape[1] > 1  # the dense layout
    g = _rand((n,), 2, 1e-2)
    g[:bs] = 0.0
    jdt = jnp.bfloat16 if grad_dtype == "bfloat16" else jnp.float32
    j_upd, j_codes, j_scales = fused_lion8bit_update_dense(
        jnp.asarray(g).astype(jdt), codes_d, scales_d, interpret=True, compander=compander
    )
    codes, scales = momentum_from_jax(codes_d, scales_d)
    grad = torch.tensor(g).to(getattr(torch, grad_dtype))
    upd = lk.lion8bit_update_(grad, codes, scales, compander=compander)
    assert upd.dtype == grad.dtype
    np.testing.assert_array_equal(upd.float().numpy(), np.asarray(j_upd.astype(jnp.float32)))
    e_codes, e_scales = momentum_from_jax(j_codes, j_scales)
    _assert_codes_close(codes, e_codes, "codes")
    np.testing.assert_allclose(scales.numpy(), e_scales.numpy(), rtol=1e-6, atol=0)


@pytest.mark.parametrize("compander", ["exact", "fast"])
def test_plain_multi_leaf_entry_matches_jax_transposed_packed(compander):
    """K5's plain version (the multi-leaf entry) against
    ``fused_lion8bit_update_transposed_packed`` at bs 64, the JAX package's
    regime for that kernel: three leaves packed along the block axis."""
    bs = 64
    sizes = [64 * 7, 64 * 30, 64 * 3]
    leaves = {f"w{i}": _rand((s,), 10 + i, 1e-3) for i, s in enumerate(sizes)}
    state = _jax_state_after(leaves, bs, compander=compander)
    grads = [_rand((s,), 20 + i, 1e-2) for i, s in enumerate(sizes)]
    nodes = [state.mu_quant[f"w{i}"] for i in range(3)]
    assert all(n[1].shape[0] == 1 for n in nodes)  # the transposed layout
    g_t = jnp.concatenate([jnp.asarray(g).reshape(-1, bs).T for g in grads], axis=1)
    j_upd, j_codes, j_scales = fused_lion8bit_update_transposed_packed(
        g_t,
        jnp.concatenate([n[0] for n in nodes], axis=1),
        jnp.concatenate([n[1] for n in nodes], axis=1),
        interpret=True, compander=compander,
    )
    ported = [momentum_from_jax(*n) for n in nodes]
    upds = lk.lion8bit_update_multi_(
        [torch.tensor(g) for g in grads], [c for c, _ in ported], [s for _, s in ported],
        compander=compander,
    )
    e_codes, e_scales = momentum_from_jax(j_codes, j_scales)
    np.testing.assert_array_equal(torch.cat(upds).numpy(), np.asarray(j_upd).T.reshape(-1))
    _assert_codes_close(torch.cat([c for c, _ in ported]), e_codes, "codes")
    np.testing.assert_allclose(torch.cat([s for _, s in ported]).numpy(), e_scales.numpy(), rtol=1e-6, atol=0)


def _tree(seed, dtype=np.float32):
    """Leaves of every kind: dense-eligible, transposed-only, one block, an
    all-zero grad and a leaf kept dense (``b``)."""
    return {
        "dense": _rand((64, 48), seed, 1e-2).astype(dtype),
        "ragged": _rand((40, 24), seed + 1, 1e-2).astype(dtype),
        "one_block": _rand((64,), seed + 2, 1e-2).astype(dtype),
        "zeros": np.zeros((8, 64), dtype),
        "b": _rand((24,), seed + 3, 1e-2).astype(dtype),
    }


@pytest.mark.parametrize("bucket", [0, 65536], ids=["per-leaf", "bucket"])
@pytest.mark.parametrize("compander", ["exact", "fast"])
@pytest.mark.parametrize("bs", [8, 16, 64])
def test_scale_by_lion_8bit_matches_jax_jnp_path(bs, compander, bucket):
    """The port's default path (the kernel's plain version on CPU tensors)
    against the JAX jnp path over 4 updates, f32 grads."""
    mask = {k: k != "b" for k in _tree(0)}
    j_tx = jax_scale_by_lion_8bit(block_size=bs, excluded_layer_mask=mask, use_pallas=False,
                                  compander=compander)
    tx = scale_by_lion_8bit(block_size=bs, excluded_layer_mask=mask, bucket_max_nb=bucket,
                            compander=compander)
    j_state = j_tx.init({k: jnp.asarray(v) for k, v in _tree(0).items()})
    state = tx.init({k: torch.tensor(v) for k, v in _tree(0).items()})
    n_blocks = differing = 0
    for step in range(4):
        grads = _tree(100 + step)
        j_upd, j_state = j_tx.update({k: jnp.asarray(v) for k, v in grads.items()}, j_state)
        upd, state = tx.update({k: torch.tensor(v) for k, v in grads.items()}, state)
        for name in grads:
            np.testing.assert_array_equal(upd[name].numpy(), np.asarray(j_upd[name]), err_msg=name)
            m, j_m = state.mu_quant[name], j_state.mu_quant[name]
            if not mask[name]:
                np.testing.assert_array_equal(m.numpy(), np.asarray(j_m))
                continue
            e_codes, e_scales = momentum_from_jax(*j_m)
            _assert_codes_close(m.codes, e_codes, name)
            if step == 0:
                np.testing.assert_array_equal(m.scales.numpy(), e_scales.numpy())
            np.testing.assert_allclose(m.scales.numpy(), e_scales.numpy(), rtol=5e-2)
            n_blocks += m.scales.numel()
            differing += int((m.scales != e_scales).sum())
    assert differing <= 1e-2 * n_blocks


@pytest.mark.parametrize("compander", ["exact", "fast"])
def test_plain_path_with_bf16_grads_matches_jax(compander):
    """``use_pallas=False`` with bf16 grads: the JAX jnp path keeps the grad's
    dtype in ``(1 - b1) g`` (weak typing) and returns f32 updates; so does
    the port."""
    mask = {k: k != "b" for k in _tree(0)}
    j_tx = jax_scale_by_lion_8bit(block_size=16, excluded_layer_mask=mask, use_pallas=False,
                                  compander=compander)
    tx = scale_by_lion_8bit(block_size=16, excluded_layer_mask=mask, use_pallas=False,
                            compander=compander)
    j_state = j_tx.init({k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in _tree(0).items()})
    state = tx.init({k: torch.tensor(v).bfloat16() for k, v in _tree(0).items()})
    for step in range(2):
        grads = _tree(200 + step)
        j_upd, j_state = j_tx.update({k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in grads.items()}, j_state)
        upd, state = tx.update({k: torch.tensor(v).bfloat16() for k, v in grads.items()}, state)
        for name in grads:
            assert upd[name].dtype == torch.float32
            np.testing.assert_array_equal(upd[name].numpy(), np.asarray(j_upd[name]), err_msg=name)
            if not mask[name]:
                np.testing.assert_array_equal(state.mu_quant[name].numpy(), np.asarray(j_state.mu_quant[name]))
            else:
                _assert_codes_close(state.mu_quant[name].codes, momentum_from_jax(*j_state.mu_quant[name])[0], name)


def test_leaf_order_permutes_into_jax_order():
    """With ``leaf_orders`` the momentum is kept in the JAX leaf's element
    order: a torch ``(out, in)`` weight updated as the JAX ``(in, out)``
    kernel."""
    w = _rand((48, 64), 5, 1e-2)  # JAX (in, out)
    g = _rand((48, 64), 6, 1e-2)
    j_tx = jax_scale_by_lion_8bit(block_size=16, excluded_layer_mask=True, use_pallas=False)
    j_upd, j_state = j_tx.update({"w": jnp.asarray(g)}, j_tx.init({"w": jnp.asarray(w)}))
    tx = scale_by_lion_8bit(block_size=16, excluded_layer_mask=True, leaf_orders={"w": (1, 0)})
    upd, state = tx.update({"w": torch.tensor(g.T)}, tx.init({"w": torch.tensor(w.T)}))
    np.testing.assert_array_equal(upd["w"].numpy(), np.asarray(j_upd["w"]).T)
    e_codes, _ = momentum_from_jax(*j_state.mu_quant["w"])
    _assert_codes_close(state.mu_quant["w"].codes, e_codes, "w")


@pytest.mark.parametrize("layout", ["dense", "transposed", "narrow"])
def test_momentum_from_jax_matches_reference_layout(layout):
    shape = (64, 48) if layout != "transposed" else (40, 24)
    kw = dict(momentum_layout="reference") if layout == "narrow" else {}
    state = _jax_state_after({"w": _rand(shape, 7, 1e-3)}, 16, **kw)
    node = state.mu_quant["w"]
    ref_codes, ref_scales = momentum_to_reference_layout(node)
    codes, scales = momentum_from_jax(*node)
    assert codes.dtype == torch.int8 and codes.shape == (np.prod(shape) // 16, 16)
    assert scales.dtype == torch.float32 and scales.shape == (np.prod(shape) // 16,)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_codes))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(ref_scales).reshape(-1))


def _jax_tree_leaves(tree):
    return {
        tuple(str(getattr(e, "key", e)) for e in path): leaf
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


@pytest.mark.parametrize("family", ["unet", "text_encoder"])
def test_create_mask_matches_jax_on_tiny(family):
    """Masks on torch modules equal the JAX masks on the JAX tree, leaf by
    leaf through the JAX paths, for the tiny family and the example
    config's exclusion list; the paths cover the JAX tree exactly."""
    rng = jax.random.PRNGKey(0)
    if family == "unet":
        jax_tree = jax.eval_shape(lambda: JaxUNet(**jax_configs.TINY_UNET).init(rng, batch_size=1, height=8, width=8))
        module = UNet2DConditionModel(**configs.TINY_UNET, device="meta")
    else:
        jax_tree = jax.eval_shape(lambda: JaxCLIP(**jax_configs.TINY_CLIP).init(rng))
        module = CLIPTextModel(**configs.TINY_CLIP, device="meta")
    for excluded in (EXAMPLE_EXCLUSIONS, ["bias", "scale", "embedding"]):
        j_mask = _jax_tree_leaves(jax_create_mask(jax_tree, excluded))
        shapes = _jax_tree_leaves(jax_tree)
        paths = jax_param_paths(module)
        assert {path for path, _ in paths.values()} == set(j_mask)
        mask = create_mask(module, excluded)
        for name, p in module.named_parameters():
            path, perm = paths[name]
            assert mask[name] == j_mask[path], name
            jax_shape = tuple(p.shape[i] for i in perm) if perm else tuple(p.shape)
            assert jax_shape == shapes[path].shape, name
        assert not all(mask.values()) and any(mask.values())


def test_zero_block_guard_matches_jax():
    """An all-zero block quantizes to code 3 (the zero-crossing offset) under
    scale 1 (the zero-absmax guard), as the JAX quantizer has it."""
    from stable_diffusion_training_tpu.ops.lion_kernel import _quantize as jax_quantize

    mu = torch.zeros(64)
    mu[32:] = torch.tensor(_rand((32,), 9, 1e-3))
    codes, scales = lk.block_quantize(mu, 16)
    assert scales[:2].eq(1.0).all() and codes[:2].eq(int(jax_quantize(jnp.zeros(())))).all()
    assert codes[:2].eq(3).all()
    assert scales[2:].ne(1.0).all()


def test_quantized_leaf_not_divisible_raises():
    tx = scale_by_lion_8bit(block_size=16, excluded_layer_mask=True)
    with pytest.raises(TypeError, match="not divisible by block_size=16"):
        tx.init({"w": torch.zeros(24)})


def test_init_is_code_3_and_scale_1():
    state = scale_by_lion_8bit(block_size=16, excluded_layer_mask={"w": True, "b": False}).init(
        {"w": torch.zeros(4, 8), "b": torch.zeros(3, dtype=torch.bfloat16)}
    )
    m = state.mu_quant["w"]
    assert isinstance(m, QuantizedMomentum) and m.codes.eq(3).all() and m.scales.eq(1.0).all()
    assert state.mu_quant["b"].dtype == torch.float32 and state.mu_quant["b"].shape == (3,)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_lion_matches_optax(dtype):
    """``lion`` (the unquantized option) against ``optax.lion``, momentum in
    the params' dtype, decay mask and lr: 3 updates, bitwise."""
    import optax

    mask = {k: k != "b" for k in _tree(0)}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    params = _tree(0)
    j_tx = optax.lion(1e-3, b1=0.9, b2=0.99, weight_decay=0.07, mask=mask)
    tx = lion(1e-3, b1=0.9, b2=0.99, weight_decay=0.07, mask=mask)
    j_params = {k: jnp.asarray(v).astype(jdt) for k, v in params.items()}
    t_params = {k: torch.tensor(v).to(getattr(torch, dtype)) for k, v in params.items()}
    j_state, state = j_tx.init(j_params), tx.init(t_params)
    for step in range(3):
        grads = _tree(300 + step)
        j_upd, j_state = j_tx.update({k: jnp.asarray(v).astype(jdt) for k, v in grads.items()}, j_state, j_params)
        upd, state = tx.update({k: torch.tensor(v).to(getattr(torch, dtype)) for k, v in grads.items()}, state, t_params)
        for name in grads:
            assert upd[name].dtype == t_params[name].dtype
            np.testing.assert_array_equal(upd[name].float().numpy(), np.asarray(j_upd[name].astype(jnp.float32)), err_msg=name)


def test_lion_8bit_chain_matches_jax():
    """``lion_8bit``: quantized Lion -> decay on the masked leaves -> -lr,
    against the JAX chain on its jnp path, f32, 3 updates (update signs equal,
    so the chained updates are equal)."""
    from stable_diffusion_training_tpu.optim.lion8bit import lion_8bit as jax_lion_8bit

    mask = {k: k != "b" for k in _tree(0)}
    params = _tree(0)
    j_tx = jax_lion_8bit(1e-3, block_size=16, weight_decay=0.07, mask=mask, excluded_layer_mask=mask,
                         use_pallas=False)
    tx = lion_8bit(1e-3, block_size=16, weight_decay=0.07, mask=mask, excluded_layer_mask=mask)
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    t_params = {k: torch.tensor(v) for k, v in params.items()}
    j_state, state = j_tx.init(j_params), tx.init(t_params)
    for step in range(3):
        grads = _tree(400 + step)
        j_upd, j_state = j_tx.update({k: jnp.asarray(v) for k, v in grads.items()}, j_state, j_params)
        upd, state = tx.update({k: torch.tensor(v) for k, v in grads.items()}, state, t_params)
        for name in grads:
            np.testing.assert_array_equal(upd[name].numpy(), np.asarray(j_upd[name]), err_msg=name)
