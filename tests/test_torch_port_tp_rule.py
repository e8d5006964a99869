"""The tensor-parallel rule and its operators, in one process (no process
group: a two-rank ``model_parallel`` axis is a stand-in mesh, and its sums
are patched where a test needs them).

- ``tp_plan`` splits exactly the 2-D kernels that the JAX package's
  ``params_tp_sharding`` splits on a ``(1, 1, 2)`` mesh, on the same axes
  (JAX's ``(None, model_parallel)`` is torch axis 0, ``(model_parallel,
  None)`` torch axis 1), by JAX path, on the tiny UNet, the tiny CLIP tower
  with and without a projection, and at full width on SD1.5's UNet and CLIP
  ViT-L (shapes only, on the meta device); the UNet's GEGLU ``net_0/proj``
  and ``net_2`` stay whole. Besides, the port splits the biases of the
  column-split layers with their outputs (JAX keeps them replicated).
- An attention whose heads the axis does not divide keeps its four
  projections whole (JAX splits them and runs it unpartitioned): a
  test-local tiny UNet with one head at its 32-channel level, and SD2.1's
  5-head level.
- ``tensor_parallel_`` gives each rank its slices and its heads.
- The momentum co-sharding rule on both split axes: a row-split kernel's
  local reference momentum is a flat range of the whole leaf's, a
  column-split one's whole blocks of it, and 8-bit Lion on the local leaf
  keeps exactly that slice through two updates.
- The replicas check compares the ranks of each model_parallel group
  only.
- ``global_norm`` sums only the split leaves over the group (a replicated
  leaf counts once), a row-split layer adds its bias once after the sum,
  and a self-attention sums its input's grad once for q, k and v.
- ``TrainingConfig`` takes ``[D, 1, T]`` meshes with
  ``tensor_parallel_shard_params``, and ``[D, F, T]`` ones with fsdp and
  model_parallel axes above 1 together.
"""

import jax
import pytest
import torch
from jax.sharding import PartitionSpec

from stable_diffusion_training_tpu.core.mesh import create_mesh as jax_create_mesh
from stable_diffusion_training_tpu.models import (
    CLIPTextModel as JaxCLIP,
    CLIPTextModelWithProjection as JaxCLIPProj,
    UNet2DConditionModel as JaxUNet,
    configs as jax_configs,
)
from stable_diffusion_training_tpu.parallel.sharding import params_tp_sharding
from stable_diffusion_training_tpu_torch.models import (
    CLIPTextModel,
    CLIPTextModelWithProjection,
    UNet2DConditionModel,
    configs,
)
from stable_diffusion_training_tpu_torch.models.attention import Attention
from stable_diffusion_training_tpu_torch.models.hf_io import jax_param_paths
from stable_diffusion_training_tpu_torch.ops.lion_kernel import block_quantize
from stable_diffusion_training_tpu_torch.optim import transforms
from stable_diffusion_training_tpu_torch.optim.lion8bit import scale_by_lion_8bit
from stable_diffusion_training_tpu_torch.parallel import sharding
from stable_diffusion_training_tpu_torch.train import config as port_config
from torch_threads import _one_thread  # noqa: F401 (the fixture)

T = 2
AXIS = "model_parallel"


class StandInMesh:
    """The ``DeviceMesh`` surface ``tp_plan`` reads: a ``(1, 1, T)`` mesh,
    this process its rank ``index`` on the model_parallel axis."""

    mesh_dim_names = ("data_parallel", "fsdp", AXIS)

    def __init__(self, index=0):
        self.index = index

    def size(self, dim):
        return (1, 1, T)[dim]

    def get_local_rank(self, axis):
        return self.index if axis == AXIS else 0

    def get_group(self, axis):
        return None


def _jax_tree(kind, cfg):
    rng = jax.random.PRNGKey(0)
    if kind == "unet":
        return jax.eval_shape(lambda: JaxUNet(**cfg).init(rng, batch_size=1, height=8, width=8))
    cls = JaxCLIPProj if "projection_dim" in cfg else JaxCLIP
    return jax.eval_shape(lambda: cls(**cfg).init(rng))


def _port_model(kind, cfg, device="cpu"):
    if kind == "unet":
        return UNet2DConditionModel(**cfg, device=device)
    cls = CLIPTextModelWithProjection if "projection_dim" in cfg else CLIPTextModel
    return cls(**cfg, device=device)


def _jax_splits(tree):
    """``{JAX path: torch axis}`` of the leaves ``params_tp_sharding``
    splits on a (1, 1, 2) mesh of the virtual CPU devices."""
    mesh = jax_create_mesh(shape=(1, 1, T), axis_names=("data_parallel", "fsdp", AXIS), devices=jax.devices()[:T])
    specs = params_tp_sharding(tree, mesh)
    out = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(specs)[0]:
        spec = tuple(sh.spec)
        if AXIS in spec:
            names = tuple(getattr(k, "key", str(k)) for k in path)
            out[names] = {PartitionSpec(None, AXIS): 0, PartitionSpec(AXIS, None): 1}[PartitionSpec(*spec)]
    return out


def _port_splits(model, index=0):
    """``{JAX path: torch axis}`` of the leaves ``tp_plan`` splits."""
    plan = sharding.tp_plan(model, StandInMesh(index))
    paths = jax_param_paths(model)
    return {paths[name][0]: shard.dim for name, shard in plan.rows.items()}, plan


MODELS = {
    "tiny_unet": ("unet", "TINY_UNET", "cpu"),
    "tiny_clip": ("clip", "TINY_CLIP", "cpu"),
    "tiny_clip_proj": ("clip", "TINY_CLIP_PROJ", "cpu"),
    "sd15_unet": ("unet", "SD15_UNET", "meta"),
    "clip_vit_l": ("clip", "CLIP_VIT_L", "meta"),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_tp_plan_splits_the_jax_rule_leaves(name):
    """The kernels split, and their axes, are the JAX rule's; the other
    split leaves are exactly the biases of the column-split kernels."""
    kind, cfg_name, device = MODELS[name]
    want = _jax_splits(_jax_tree(kind, getattr(jax_configs, cfg_name)))
    model = _port_model(kind, getattr(configs, cfg_name), device)
    got, _ = _port_splits(model)
    kernels = {p: d for p, d in got.items() if p[-1] == "kernel"}
    assert kernels == want and len(want) > 0
    biases = {p for p in got if p[-1] != "kernel"}
    column = ("q_proj", "k_proj", "v_proj", "mlp_fc1")
    assert biases == {p[:-1] + ("bias",) for p, d in want.items() if d == 0 and p[-2] in column}
    assert all(got[p] == 0 for p in biases)
    if kind == "unet":
        assert not biases  # the UNet's q, k, v have no bias
        paths = {path for path, _ in jax_param_paths(model).values()}
        geglu = {p for p in paths if p[-3:] == ("net_0", "proj", "kernel") or p[-2:] == ("net_2", "kernel")}
        assert geglu and not geglu & set(got)  # the feed-forward stays whole


def _attention_leaves(model, level_channels):
    """The JAX paths of every projection of the attentions at the level of
    ``level_channels`` channels."""
    paths = jax_param_paths(model)
    out = set()
    for prefix, m in model.named_modules():
        if isinstance(m, Attention) and m.to_q.in_features == level_channels:
            out.update(paths[f"{prefix}.{n}"][0] for n, _ in m.named_parameters())
    return out


@pytest.mark.parametrize("name", ["tiny_one_head", "sd21_unet"])
def test_an_attention_whose_heads_do_not_divide_stays_whole(name):
    """The port keeps whole the attentions whose heads the axis does not
    divide, which the JAX rule splits (and then runs unpartitioned): the
    rest of its rule is the JAX one."""
    if name == "tiny_one_head":
        port_cfg = dict(configs.TINY_UNET, attention_head_dim=(1, 2))
        jax_cfg, device, channels = dict(jax_configs.TINY_UNET, attention_head_dim=(1, 2)), "cpu", 32
    else:
        port_cfg, jax_cfg, device, channels = configs.SD21_UNET, jax_configs.SD21_UNET, "meta", 320
    model = _port_model("unet", port_cfg, device)
    whole = {p for p in _attention_leaves(model, channels) if p[-1] == "kernel"}
    want = _jax_splits(_jax_tree("unet", jax_cfg))
    got, _ = _port_splits(model)
    assert whole and whole <= set(want) and not whole & set(got)
    assert got == {p: d for p, d in want.items() if p not in whole}


def test_tensor_parallel_gives_each_rank_its_slices_and_heads():
    """On rank 1 of 2: each split leaf is its half of the whole one (the
    output rows of q, k, v, the input columns of to_out), the attentions
    run 1 of the tiny UNet's 2 heads, a CLIP attention 2 of 4 and its MLP
    half of fc1's outputs; the rest is unchanged."""
    whole = _port_model("unet", configs.TINY_UNET)
    model = _port_model("unet", configs.TINY_UNET)
    model.load_state_dict(whole.state_dict())
    plan = sharding.tensor_parallel_(model, StandInMesh(index=1))
    assert sharding.shard_plan(model) is plan
    params, before = dict(model.named_parameters()), dict(whole.named_parameters())
    assert list(params) == list(before)  # the order the optimizer and checkpoints walk
    for name, p in params.items():
        if name in plan.rows:
            assert torch.equal(p, plan.rows[name].take(before[name]))
            assert p.shape[plan.rows[name].dim] == before[name].shape[plan.rows[name].dim] // T
        else:
            assert torch.equal(p, before[name]), name
    attns = [m for m in model.modules() if isinstance(m, Attention)]
    assert attns and all(m.heads == 1 and m.tp.size == T for m in attns)
    clip = _port_model("clip", configs.TINY_CLIP)
    sharding.tensor_parallel_(clip, StandInMesh(index=1))
    layer = clip.text_model.encoder.layers[0]
    assert layer.self_attn.num_heads == 2 and layer.mlp.tp is not None
    assert layer.mlp.fc1.weight.shape == (32, 32) and layer.mlp.fc2.weight.shape == (32, 32)


@pytest.mark.parametrize("dim", [0, 1], ids=["column", "row"])
def test_lion_keeps_the_slice_of_the_whole_momentum(dim):
    """A Dense kernel ``(O, I) = (64, 32)`` split on its outputs or inputs
    over two ranks at block 16: each rank's reference-order momentum is its
    slice of the whole leaf's (``MomentumShard.take``: whole blocks of
    each input column, or a flat range of the JAX ``(I, O)`` rows), and
    8-bit Lion on the rank's slice of two updates' grads keeps exactly that
    slice, with exactly its slice of the updates."""
    g = torch.Generator().manual_seed(3)
    shape = torch.Size((64, 32))
    grads = [torch.randn(shape, generator=g) for _ in range(2)]
    orders = {"w": (1, 0)}
    one = scale_by_lion_8bit(block_size=16, excluded_layer_mask=True, leaf_orders=orders)
    state = one.init({"w": torch.zeros(shape)})
    whole = []
    for grad in grads:
        upd, state = one.update({"w": grad}, state)
        mu = state.mu_quant["w"]  # the kernel path updates the codes in place
        whole.append((upd["w"], mu.codes.clone(), mu.scales.clone()))
    for index in range(T):
        step = shape[dim] // T
        rows = sharding.RowShard(shape, tuple(i * step for i in range(T + 1)), index, None, dim)
        plan = sharding.ShardPlan({"w": rows}, orders)
        shard = plan.momentum("w", 16)
        assert shard is not None and shard.transposed == (dim == 0)
        local = scale_by_lion_8bit(block_size=16, excluded_layer_mask=True, leaf_orders=orders, plan=plan)
        lstate = local.init({"w": rows.take(torch.zeros(shape))})
        for grad, (upd, whole_codes, whole_scales) in zip(grads, whole):
            lupd, lstate = local.update({"w": rows.take(grad).contiguous()}, lstate)
            assert torch.equal(lupd["w"], rows.take(upd))
            codes, scales = shard.take(whole_codes, whole_scales)
            assert torch.equal(lstate.mu_quant["w"].codes, codes) and torch.equal(lstate.mu_quant["w"].scales, scales)
            # the rank's blocks are its slice's own reference order
            own = block_quantize(rows.take(grad).t().contiguous(), 16)[0].shape
            assert codes.shape == own


def test_a_column_split_of_partial_blocks_keeps_the_whole_momentum():
    """Output channels 24 a rank are not whole blocks of 16: the rule keeps
    the leaf's momentum whole on every rank."""
    rows = sharding.RowShard(torch.Size((48, 8)), (0, 24, 48), 0, None, 0)
    assert sharding.ShardPlan({"w": rows}, {"w": (1, 0)}).momentum("w", 16) is None


def test_global_norm_counts_a_replicated_leaf_once(monkeypatch):
    """With the group's sum standing in for two ranks holding the same
    partials (it doubles them), only the leaves the plan splits are summed:
    a leaf whole on every rank counts once. Under an FSDP plan (every leaf
    split) every leaf is a shard."""
    calls = []

    def doubled(t, group=None):
        calls.append((t.numel(), group))
        t.mul_(2)

    monkeypatch.setattr(torch.distributed, "all_reduce", doubled)
    updates = {"split": torch.full((4,), 1.0), "whole": torch.full((3,), 2.0), "split_b": torch.full((2,), 3.0)}

    def plan(names, group):
        rows = {n: sharding.RowShard(torch.Size((2 * updates[n].numel(),)), (0, updates[n].numel(), 2 * updates[n].numel()),
                                     0, group) for n in names}
        return sharding.ShardPlan(rows, {}, fsdp=group == "fsdp")

    got = transforms.global_norm(updates, plan(("split", "split_b"), "tp"))
    assert torch.allclose(got, torch.tensor((2 * 4 + 12 + 2 * 18) ** 0.5))
    assert calls == [(2, "tp")]  # one all_reduce, of the two split leaves' partials
    every = transforms.global_norm(updates, plan(updates, "fsdp"))
    assert torch.allclose(every, torch.tensor((2 * (4 + 12 + 18)) ** 0.5))
    assert torch.equal(transforms.global_norm(updates), torch.sqrt(sum((x * x).sum() for x in updates.values())))


@pytest.mark.parametrize("differs", ["model_parallel", "data_parallel"])
def test_replicas_are_checked_over_the_model_parallel_axis(monkeypatch, differs):
    """``assert_replicated(..., mesh, "model_parallel")`` on a ``(2, 1, 2)``
    world compares each row block's model_parallel ranks only: a rank whose
    whole leaves differ from its axis partner's raises, while two row
    blocks that differ from each other do not."""
    mine = [torch.arange(6, dtype=torch.float32)]
    ours = sharding.state_digest(mine)

    def gathered(obj):  # ranks (data, fsdp, model): (0,0,0) this one, (0,0,1), (1,0,0), (1,0,1)
        place, digest = obj
        assert place == (0, 0) and digest == ours
        partner = "other" if differs == "model_parallel" else ours
        return [((0, 0), ours), ((0, 0), partner), ((1, 0), "block 1"), ((1, 0), "block 1")]

    monkeypatch.setattr(sharding, "all_gather_objects", gathered)
    mesh = StandInMesh(index=0)
    if differs == "model_parallel":
        with pytest.raises(RuntimeError, match="differs across ranks"):
            sharding.assert_replicated(mine, "whole leaves", mesh, AXIS)
    else:
        assert sharding.assert_replicated(mine, "whole leaves", mesh, AXIS) == ours


def _doubling_sum(monkeypatch):
    """The axis's sum, standing in for two ranks with the same partials."""
    calls = []

    def doubled(t, group):
        calls.append(tuple(t.shape))
        t.mul_(2)

    monkeypatch.setattr(sharding, "_sum_", doubled)
    return calls


def test_a_row_split_bias_is_added_once(monkeypatch):
    _doubling_sum(monkeypatch)
    g = torch.Generator().manual_seed(0)
    linear = torch.nn.Linear(6, 5)
    x = torch.randn(3, 6, generator=g)
    out = sharding.tp_row_linear(x, linear, sharding.TpAxis(None, T))
    torch.testing.assert_close(out, 2 * (x @ linear.weight.t()) + linear.bias, rtol=0, atol=1e-6)


@pytest.mark.parametrize("context", [False, True], ids=["self", "cross"])
def test_a_self_attention_sums_its_input_grad_once(monkeypatch, context):
    """q, k and v of a self-attention read one ``tp_copy``: one sum of the
    input's grad in the backward (and one of ``to_out``'s products in the
    forward); a cross-attention sums its context's grad apart."""
    calls = _doubling_sum(monkeypatch)
    before = dict(sharding.TP_ALL_REDUCES)
    attn = Attention(8, heads=2, dim_head=4, context_dim=6 if context else None)
    attn.split_(sharding.TpAxis(None, T))
    assert attn.heads == 1
    attn.to_q.weight = torch.nn.Parameter(attn.to_q.weight[:4].clone())
    attn.to_k.weight = torch.nn.Parameter(attn.to_k.weight[:4].clone())
    attn.to_v.weight = torch.nn.Parameter(attn.to_v.weight[:4].clone())
    attn.to_out[0].weight = torch.nn.Parameter(attn.to_out[0].weight[:, :4].clone())
    x = torch.randn(2, 5, 8, requires_grad=True)
    ctx = torch.randn(2, 7, 6, requires_grad=True) if context else None
    attn(x, ctx).sum().backward()
    counts = {k: v - before[k] for k, v in sharding.TP_ALL_REDUCES.items()}
    assert counts == {"forward": 1, "backward": 2 if context else 1}
    assert len(calls) == sum(counts.values())


def _config(monkeypatch, world, **overrides):
    from torch_dist_child import step_config

    monkeypatch.setattr(port_config, "process_count", lambda: world)
    return step_config(dict(batch_size=4, **overrides))


def test_config_takes_tensor_parallel_meshes(monkeypatch):
    """``[D, 1, T]`` with ``tensor_parallel_shard_params`` splits; without
    it (or on an axis of 1) the model_parallel ranks are replicas; the rows
    split over data x fsdp only."""
    cfg = _config(monkeypatch, 2, mesh_shape=[1, 1, 2], tensor_parallel_shard_params=True)
    assert cfg.splits_tensors() and cfg.batch_shards() == 1 and not cfg.shards_params()
    cfg = _config(monkeypatch, 4, mesh_shape=[2, 1, 2], tensor_parallel_shard_params=True)
    assert cfg.splits_tensors() and cfg.batch_shards() == 2
    assert not _config(monkeypatch, 4, mesh_shape=[2, 2]).splits_tensors()
    assert not _config(monkeypatch, 1, tensor_parallel_shard_params=True).splits_tensors()


def test_config_still_raises_for_tp_with_fsdp(monkeypatch):
    """TP with FSDP is ported: ``[1, 2, 2]`` with both flags both shards
    and splits, its rows split over the fsdp axis; it still raises, as any
    mesh does, where the process group does not hold its four ranks."""
    cfg = _config(monkeypatch, 4, mesh_shape=[1, 2, 2], tensor_parallel_shard_params=True, fsdp_shard_params=True)
    assert cfg.splits_tensors() and cfg.shards_params() and cfg.batch_shards() == 2
    cfg = _config(monkeypatch, 4, mesh_shape=[1, 2, 2], tensor_parallel_shard_params=True)
    assert cfg.splits_tensors() and not cfg.shards_params() and cfg.batch_shards() == 2
    with pytest.raises(ValueError, match="the process group has 2"):
        _config(monkeypatch, 2, mesh_shape=[1, 2, 2], tensor_parallel_shard_params=True)
    with pytest.raises(ValueError, match="the process group has 2"):
        _config(monkeypatch, 2, mesh_shape=[1, 2, 2], fsdp_shard_params=True)
