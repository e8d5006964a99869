"""TP with FSDP: the composed plan leaf by leaf, the momentum rule across
both axes and the global norm, on four gloo ranks of the CPU.

One four-rank world (``tests/torch_dist_child.py``) on a ``(data_parallel,
fsdp, model_parallel) = (1, 2, 2)`` mesh runs:

- ``plan``: ``on_device_model_training_state`` with
  ``tensor_parallel_shard_params`` and ``fsdp_shard_params`` over the tiny
  UNet and CLIP tower, each rank reporting its plan. Held against the JAX
  package's ``train_state_tp_sharding(fsdp_rest=True)`` placement (the JAX
  training state on a ``(1, 2, 2)`` mesh of conftest's virtual CPU devices
  with both flags): the kernels split over ``model_parallel``, and their
  axes, are JAX's (JAX's ``(None, model_parallel)`` is torch axis 0,
  ``(model_parallel, None)`` torch axis 1); besides, the port splits the
  column-split layers' biases. Every leaf is then sharded over fsdp on its
  local axis 0 (``torch.chunk``'s bounds), where JAX keeps the params
  replicated over fsdp and shards only their optimizer state: another
  placement of the same numbers (ROADMAP Queue 3).
- ``rule-kernel`` / ``rule-plain``: ``TpRuleModel`` split over
  ``model_parallel``, then sharded with FSDP2 over fsdp; clip-by-global-norm
  (at a bound above the grads' norm, so that it passes them unchanged) and
  8-bit Lion at block 16 on each rank's local leaves for two updates of the
  same whole grads, through the kernel path's entries (their plain versions
  on the CPU) and the plain jnp-path math. The parent runs the chain in one
  process on the whole leaves.

Checks: the leaves whose momentum stays whole are exactly those whose
ranges are not whole blocks at one level; each rank's codes and scales after
``init`` and after each update are exactly its part of the one-process
state (a row-split kernel's: the strided set of block ranges, checked also
by an independent formula), its updates exactly its part of the
one-process updates; ``global_norm`` over the composed plan takes one
``all_reduce`` per axis and is within a few f32 ulps of the one-process
norm.
"""

import time

import jax
import numpy as np
import pytest
import torch

import torch_dist_child as child
from stable_diffusion_training_tpu.core.mesh import create_mesh as jax_create_mesh
from stable_diffusion_training_tpu.train import (
    TrainingConfig as JaxTrainingConfig,
    on_device_model_training_state as jax_training_state,
)
from stable_diffusion_training_tpu_torch.models import CLIPTextModel, UNet2DConditionModel, configs
from stable_diffusion_training_tpu_torch.models.hf_io import jax_param_paths
from stable_diffusion_training_tpu_torch.optim import transforms
from stable_diffusion_training_tpu_torch.parallel.sharding import NestedShard, RowShard, ShardPlan
from test_torch_port_train_step import _config
from torch_threads import _one_thread  # noqa: F401 (the fixture)

WORLD = 4
MESH = (1, 2, 2)
BOTH = dict(mesh_shape=list(MESH), fsdp_shard_params=True, tensor_parallel_shard_params=True)
AXIS = "model_parallel"
DEADLINE_S = 240
PATHS = {"kernel": None, "plain": False}  # use_pallas of each path
# above the grads' norm (~180): the clip runs, its norm summed over both axes,
# and passes the grads as they are, so the ranks' Lion sees the one process's
# grads bitwise (a clip that scaled them would carry the norm's last-ulp
# difference, the squares summed in another order, into every scale)
MAX_NORM = 1e4
# the leaves of TpRuleModel whose momentum stays whole: not whole blocks at
# one level (12 output channels a rank; 24 rows, or 24 elements, a rank)
RULE_WHOLE = sorted(["narrow.to_q.weight", "narrow.to_k.weight", "narrow.to_v.weight", "narrow.to_out.0.weight",
                     "narrow.to_out.0.bias", "norm.weight", "norm.bias"])


def _jax_placement():
    """``{model: {JAX path: spec}}`` of the JAX training state's params with
    both flags on a (1, 2, 2) mesh."""
    mesh = jax_create_mesh(shape=MESH, axis_names=("data_parallel", "fsdp", AXIS), devices=jax.devices()[:WORLD])
    states = jax_training_state(
        _config(JaxTrainingConfig, "v-zero-snr", tensor_parallel_shard_params=True, fsdp_shard_params=True), mesh=mesh
    )
    out = {}
    for key, state in (("unet", states[0]), ("text_encoder", states[1])):
        out[key] = {tuple(getattr(k, "key", str(k)) for k in path): tuple(leaf.sharding.spec)
                    for path, leaf in jax.tree_util.tree_flatten_with_path(state.params)[0]}
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tp_fsdp_rule"))
    cases = {f"rule-{path}": dict(kind="rule", mesh=MESH, use_pallas=flag, tp=True, max_norm=MAX_NORM)
             for path, flag in PATHS.items()}
    cases["plan"] = dict(kind="plan", mesh=MESH, config=dict(BOTH, batch_size=2))
    procs = child.start_world(tmp, cases, WORLD)
    try:
        refs = {path: _one_process(flag) for path, flag in PATHS.items()}
        jax_specs = _jax_placement()
    finally:
        codes = child.wait_world(procs, time.monotonic() + DEADLINE_S)
    return dict(refs=refs, jax=jax_specs, results=child.world_results(tmp, cases, WORLD), codes=codes)


def _one_process(use_pallas):
    model, grads = child.rule_inputs(model_class=child.TpRuleModel)
    params = {n: p.detach() for n, p in model.named_parameters()}
    tx = child.rule_optimizer(model, use_pallas, max_norm=MAX_NORM)
    state = tx.init(params)
    out = {"init": child.rule_state(state[1]), "updates": [], "states": []}
    for step in grads:
        updates, state = tx.update(step, state, params)
        out["updates"].append(updates)
        out["states"].append(child.rule_state(state[1]))
    out["global_norm"] = float(transforms.global_norm(grads[0]))
    return out


def _result(world, name, rank):
    got = world["results"].get((name, rank))
    assert got is not None, f"rank {rank} gave no result for {name} (exit codes {world['codes']})"
    assert not isinstance(got, str), got
    return got


def _shard(layout, shape):
    """A reported ``shard_layout`` as the port's shard (no group)."""
    if layout[0] == "nested":
        outer = _shard(layout[1], shape)
        local = list(shape)
        local[outer.dim] = outer.stop - outer.start
        return NestedShard(outer, _shard(layout[2], torch.Size(local)))
    _, dim, bounds, index = layout
    return RowShard(torch.Size(shape), bounds, index, None, dim)


def _rank_plan(got):
    model, _ = child.rule_inputs(model_class=child.TpRuleModel)
    shapes = {n: p.shape for n, p in model.named_parameters()}
    rows = {n: _shard(layout, shapes[n]) for n, layout in got["rows"].items()}
    return ShardPlan(rows, {n: perm for n, (_, perm) in jax_param_paths(model).items()}, fsdp=True)


def _part(plan, leaf, value):
    """The rank's part of a one-process leaf, update or momentum."""
    if not isinstance(value, tuple):
        return plan.take(leaf, value)
    shard = plan.momentum(leaf, 16)
    return value if shard is None else shard.take(*value)


def _equal(a, b):
    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def test_ranks_exit_cleanly(world):
    assert world["codes"] == [0] * WORLD


@pytest.mark.parametrize("key", ["unet", "text_encoder"])
def test_the_plan_splits_the_jax_rule_leaves_then_shards_every_leaf(world, key):
    """Rank ``r`` is ``(fsdp, model_parallel) = (r // 2, r % 2)``. Its TP
    slices are the JAX rule's kernels (and the column-split biases), each on
    JAX's axis; every leaf is sharded over fsdp on its local axis 0."""
    model = (UNet2DConditionModel(**configs.TINY_UNET, device="meta") if key == "unet"
             else CLIPTextModel(**configs.TINY_CLIP, device="meta"))
    paths = jax_param_paths(model)
    shapes = {n: p.shape for n, p in model.named_parameters()}
    specs = world["jax"][key]
    want = {}
    for name, (path, _) in paths.items():
        spec = specs[path]
        assert "fsdp" not in spec, (path, spec)  # JAX: params replicated over fsdp
        if AXIS in spec:
            want[name] = 1 - spec.index(AXIS)  # JAX (I, O) axis 1 is torch axis 0
    column = ("q_proj", "k_proj", "v_proj", "mlp_fc1")
    for rank in range(WORLD):
        layout = _result(world, "plan", rank)["layout"][key]
        assert set(layout) == set(paths)
        split = {n: lay[1][1] for n, lay in layout.items() if lay[0] == "nested"}
        kernels = {n: d for n, d in split.items() if paths[n][0][-1] == "kernel"}
        assert kernels == want and want
        biases = {n for n in split if paths[n][0][-1] == "bias"}
        assert biases == {n[: -len("weight")] + "bias" for n, d in want.items() if d == 0
                          and paths[n][0][-2] in column}
        for name, lay in layout.items():
            inner = lay[2] if lay[0] == "nested" else lay
            local = shapes[name][0] // 2 if split.get(name) == 0 else shapes[name][0]
            chunk = -(-local // 2)
            assert inner == ("rows", 0, (0, min(chunk, local), local), rank // 2), (name, inner)
            if lay[0] == "nested":
                assert lay[1][3] == rank % 2


def test_the_models_keep_whole_momentum_only_where_blocks_break(world):
    """The tiny models at block 16: the 32-wide attentions' q, k and v are
    8 output channels a rank after both splits, and ``conv_out`` 2, so
    those keep their whole momentum; every other quantized leaf is split."""
    for rank in range(WORLD):
        whole = _result(world, "plan", rank)["whole"]
        assert all(n.endswith(("to_q.weight", "to_k.weight", "to_v.weight")) for n in whole["unet"]
                   if n != "conv_out.weight") and "conv_out.weight" in whole["unet"]
        assert whole["text_encoder"] and all(n.endswith(("q_proj.weight", "k_proj.weight", "v_proj.weight"))
                                             for n in whole["text_encoder"])


@pytest.mark.parametrize("rank", range(WORLD))
def test_the_rule_keeps_whole_only_the_leaves_it_cannot_split(world, rank):
    got = _result(world, "rule-kernel", rank)
    assert got["whole"] == RULE_WHOLE
    fsdp, tp = divmod(rank, 2)
    assert got["rows"]["wide.to_out.0.weight"] == (
        "nested", ("rows", 1, (0, 32, 64), tp), ("rows", 0, (0, 32, 64), fsdp))
    assert got["rows"]["conv.weight"] == ("rows", 0, (0, 16, 32), fsdp)


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("leaf", [n for n, _ in child.TpRuleModel().named_parameters()])
def test_local_momentum_and_updates_are_the_one_process_parts(world, path, leaf):
    """After ``init`` and after each of two updates, bitwise."""
    ref = world["refs"][path]
    for rank in range(WORLD):
        got = _result(world, f"rule-{path}", rank)
        plan = _rank_plan(got)
        assert _equal(got["init"][leaf], _part(plan, leaf, ref["init"][leaf])), (rank, "init")
        for step in range(2):
            assert _equal(got["states"][step][leaf], _part(plan, leaf, ref["states"][step][leaf])), (rank, step)
            assert torch.equal(got["updates"][step][leaf], plan.take(leaf, ref["updates"][step][leaf])), (rank, step)


def test_a_row_split_kernels_momentum_is_a_strided_set_of_blocks(world):
    """``wide.to_out.0``: torch ``(O, I) = (64, 64)``, JAX ``(I, O)``. Rank
    ``(f, t)`` holds input rows ``32 t : 32 (t + 1)`` and output channels
    ``32 f : 32 (f + 1)``: 32 runs of two blocks, block ``(i, 2 f + j)`` of
    the whole ``(64, 4, 16)`` codes for each of its rows ``i``."""
    ref = world["refs"]["kernel"]["states"][1]["wide.to_out.0.weight"]
    codes, scales = ref[0].view(64, 4, 16), ref[1].view(64, 4)
    for rank in range(WORLD):
        f, t = divmod(rank, 2)
        got = _result(world, "rule-kernel", rank)["states"][1]["wide.to_out.0.weight"]
        rows, cols = slice(32 * t, 32 * (t + 1)), slice(2 * f, 2 * f + 2)
        assert torch.equal(got[0], codes[rows, cols].reshape(-1, 16))
        assert torch.equal(got[1], scales[rows, cols].reshape(-1))


@pytest.mark.parametrize("rank", range(WORLD))
def test_global_norm_sums_each_axis_once(world, rank):
    """One ``all_reduce`` over fsdp (every leaf's partial) and one over
    model_parallel (the TP-split leaves'), and the one-process norm within a
    few f32 ulps."""
    got = _result(world, "rule-kernel", rank)
    want = world["refs"]["kernel"]["global_norm"]
    assert got["norm_collectives"] == 2
    assert abs(got["global_norm"] - want) <= 4 * np.spacing(np.float32(want))
