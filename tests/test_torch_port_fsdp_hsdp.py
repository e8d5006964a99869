"""HSDP on four gloo ranks of the CPU: a ``(2, 2, 1)`` mesh with
``fsdp_shard_params`` shards the models over the ``fsdp`` axis and
replicates the shards over ``data_parallel`` (FSDP2 on the 2-D ``(data,
fsdp)`` mesh: the grads reduce-scattered over fsdp, then summed over data).

One four-rank world (``tests/torch_dist_child.py``) builds the config and
takes one step on a global batch of 4, one row a rank, with per-row draws;
the parent takes the same step in one process. Each rank's dump is gathered
whole over its fsdp group, so all four are bitwise equal (the two data
replicas run the same update on the same summed grads), and rank 0's is
held to ``tests/test_torch_port_train_step.py``'s bounds against the
one-process step (``test_torch_port_distributed.assert_dump_matches``).
"""

import time

import numpy as np
import pytest

import torch_dist_child as child
from test_torch_port_distributed import _row_draws, _stack, assert_dump_matches, assert_ranks_equal
from torch_threads import _one_thread  # noqa: F401 (the fixture)

WORLD = 4
MESH = (2, 2, 1)
DEADLINE_S = 300


def _case():
    rng = np.random.default_rng(11)
    batch = {
        "pixel_values": rng.uniform(-1, 1, (WORLD, 3, 64, 64)).astype(np.float32),
        "input_ids": rng.integers(0, 1000, (WORLD * 3, 77)).astype(np.int32),
    }
    return dict(kind="step", config=dict(batch_size=WORLD), batch=batch, draws=_stack(_row_draws(WORLD, (32, 32), 13)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("hsdp"))
    case = _case()
    cases = {"hsdp": dict(case, mesh=MESH, config=dict(case["config"], mesh_shape=list(MESH), fsdp_shard_params=True))}
    procs = child.start_world(tmp, cases, WORLD)
    try:
        ref = child.run_step(case)
    finally:
        codes = child.wait_world(procs, time.monotonic() + DEADLINE_S)
    return dict(ref=ref, results=child.world_results(tmp, cases, WORLD), codes=codes)


def test_ranks_exit_cleanly(world):
    assert world["codes"] == [0] * WORLD


def test_hsdp_step_matches_the_one_process_step(world):
    got = [world["results"].get(("hsdp", r)) for r in range(WORLD)]
    for r, dump in enumerate(got):
        assert dump is not None and not isinstance(dump, str), (r, dump)
    for dump in got[1:]:
        assert_ranks_equal(got[0], dump)
    assert_dump_matches(got[0], world["ref"])
    for dump in got:
        assert all(all(v.values()) for v in dump["local_slices"].values())
