"""The FSDP momentum co-sharding rule and the sharded global norm, leaf by
leaf, on two gloo ranks of the CPU.

One two-rank world (``tests/torch_dist_child.py``, ``run_rule``) shards
``RuleModel`` with FSDP2 over a ``(1, 2, 1)`` mesh and runs clip-by-global-norm
and 8-bit Lion at block 16 on each rank's shards, for two updates of the
same whole grads (each rank takes its rows), through the kernel path's entries
(their plain versions on the CPU) and through the plain jnp-path math. The
parent runs the same chain in one process on the whole leaves.

- The rule: the Dense and the Conv kernel (JAX's output channels are torch's
  rows) and the leaves whose orders agree (the biases, a 77-row embedding
  split 39 and 38) keep their own blocks; a Conv kernel of 4 output channels
  and a 48-wide norm (24 elements a rank) keep their whole momentum.
- Each rank's codes and scales after ``init`` and after each update are
  exactly its slice of the one-process state (``MomentumShard.take``), a
  whole leaf's exactly the one-process state, and each rank's updates
  exactly its rows of the one-process updates: each block is updated from
  the same grads by the same math, whatever the rank.
- ``global_norm`` over the shards: one ``all_reduce`` a call, and within a
  few f32 ulps of the one-process norm (the squares summed in another
  order).
"""

import time

import numpy as np
import pytest
import torch

import torch_dist_child as child
from stable_diffusion_training_tpu_torch.optim import transforms
from stable_diffusion_training_tpu_torch.parallel.sharding import MomentumShard, RowShard
from torch_threads import _one_thread  # noqa: F401 (the fixture)

WORLD = 2
DEADLINE_S = 240
PATHS = {"kernel": None, "plain": False}  # use_pallas of each path
# the rule at block 16 over two ranks: {leaf: (transposed, columns)}, None kept whole
RULE = {
    "dense.weight": (True, 24), "dense.bias": (False, 1), "conv.weight": (True, 72), "conv.bias": (False, 1),
    "table.weight": (False, 16), "out.weight": None, "norm.weight": None, "norm.bias": None,
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("fsdp_rule"))
    cases = {f"rule-{path}": dict(kind="rule", mesh=(1, WORLD, 1), use_pallas=flag) for path, flag in PATHS.items()}
    procs = child.start_world(tmp, cases, WORLD)
    try:
        refs = {path: _one_process(flag) for path, flag in PATHS.items()}
    finally:
        codes = child.wait_world(procs, time.monotonic() + DEADLINE_S)
    return dict(refs=refs, results=child.world_results(tmp, cases, WORLD), codes=codes)


def _one_process(use_pallas):
    model, grads = child.rule_inputs()
    params = {n: p.detach() for n, p in model.named_parameters()}
    tx = child.rule_optimizer(model, use_pallas)
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


def _slice(leaf, rows, shape, momentum):
    """The one-process momentum of ``leaf`` cut to a rank's rows by the rule."""
    if RULE[leaf] is None or not isinstance(momentum, tuple):
        return momentum if RULE[leaf] is None else momentum[rows[0] : rows[1]]
    bounds = (0, -(-shape[0] // WORLD), shape[0])
    index = bounds.index(rows[0])
    shard = MomentumShard(RowShard(torch.Size(shape), bounds, index, None), *RULE[leaf], 16)
    return shard.take(*momentum)


def _equal(a, b):
    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def test_ranks_exit_cleanly(world):
    assert world["codes"] == [0] * WORLD


@pytest.mark.parametrize("rank", range(WORLD))
def test_the_rule_keeps_whole_only_the_leaves_it_cannot_split(world, rank):
    got = _result(world, "rule-kernel", rank)
    assert got["whole"] == sorted(n for n, r in RULE.items() if r is None)
    assert got["rows"]["table.weight"] == ((0, 39), (39, 77))[rank]  # torch.chunk's uneven split
    assert got["rows"]["out.weight"] == ((0, 2), (2, 4))[rank]


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("leaf", list(RULE))
def test_local_momentum_and_updates_are_the_one_process_slices(world, path, leaf):
    """After ``init`` and after each of two updates, bitwise."""
    ref = world["refs"][path]
    model, _ = child.rule_inputs()
    shape = dict(model.named_parameters())[leaf].shape
    for rank in range(WORLD):
        got = _result(world, f"rule-{path}", rank)
        rows = got["rows"][leaf]
        assert _equal(got["init"][leaf], _slice(leaf, rows, shape, ref["init"][leaf])), (rank, "init")
        for step in range(2):
            want = _slice(leaf, rows, shape, ref["states"][step][leaf])
            assert _equal(got["states"][step][leaf], want), (rank, step)
            assert torch.equal(got["updates"][step][leaf], ref["updates"][step][leaf][rows[0] : rows[1]]), (rank, step)


@pytest.mark.parametrize("rank", range(WORLD))
def test_global_norm_over_shards_takes_one_collective(world, rank):
    got = _result(world, "rule-kernel", rank)
    want = world["refs"]["kernel"]["global_norm"]
    assert got["norm_collectives"] == 1
    assert abs(got["global_norm"] - want) <= 4 * np.spacing(np.float32(want))


def test_a_misaligned_grad_is_copied_to_an_aligned_start():
    """A grad shard that starts off a 16-byte boundary (a reduce-scatter
    output's view) is copied before the leaf table, counted in
    ``GRAD_COPIES``; the update is the aligned grad's, bitwise."""
    from stable_diffusion_training_tpu_torch.optim import lion8bit

    torch.manual_seed(0)
    p = {"w": torch.randn(32, 24)}
    flat = torch.randn(32 * 24 + 1)
    misaligned = {"w": flat[1:].view(32, 24)}
    assert misaligned["w"].data_ptr() % 16 and misaligned["w"].is_contiguous()
    aligned = {"w": misaligned["w"].clone()}
    tx = lion8bit.scale_by_lion_8bit(block_size=16, excluded_layer_mask=True, leaf_orders={"w": (1, 0)})
    before = lion8bit.GRAD_COPIES["count"]
    got, got_state = tx.update(misaligned, tx.init(p), p)
    assert lion8bit.GRAD_COPIES["count"] == before + 1
    want, want_state = tx.update(aligned, tx.init(p), p)
    assert lion8bit.GRAD_COPIES["count"] == before + 1
    assert torch.equal(got["w"], want["w"])
    assert torch.equal(got_state.mu_quant["w"].codes, want_state.mu_quant["w"].codes)
