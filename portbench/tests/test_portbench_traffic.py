"""The traffic generator (``portbench/traffic.py``) on the CPU: the same seed
gives the same inputs; a bucket mix gives every seed the same set of image
sizes in an order of its own; a run over a bucket mix warms every size in
set-up, counts the window's model FLOPs size by size and comes out correct,
on the image path and on the latent-cache path's step table."""

import pytest
import torch

from portbench_tiny import tiny_cell

from portbench import flops, run
from portbench.traffic import batch_resolution, buckets, make_inputs, tiers


def mix(cell, sizes):
    cell["traffic"].pop("resolution")
    cell["traffic"].pop("distinct_batches")
    cell["traffic"]["buckets"] = [{"resolution": list(s), "batches": n} for s, n in sizes]
    return cell


def sizes_of(cell, seed):
    inputs = make_inputs(cell["traffic"], cell["config"], seed, torch.device("cpu"))
    return [batch_resolution(batch, cell["config"]) for batch, _ in inputs]


def test_the_same_seed_gives_the_same_inputs():
    cell = tiny_cell("tiny")
    a = make_inputs(cell["traffic"], cell["config"], 2**33 + 1, torch.device("cpu"))
    b = make_inputs(cell["traffic"], cell["config"], 2**33 + 1, torch.device("cpu"))
    for (xa, da), (xb, db) in zip(a, b):
        assert all(torch.equal(xa[k], xb[k]) for k in xa) and all(torch.equal(da[k], db[k]) for k in da)
    assert buckets(cell["traffic"]) == [((32, 32), 4)]
    assert tiers(cell["traffic"]) == [(32, 32)]
    assert tiers(mix(tiny_cell("tiny"), [((128, 64), 1)])["traffic"]) == [(91, 64)]


def test_a_bucket_mix_gives_every_seed_the_same_sizes():
    cell = mix(tiny_cell("tiny"), [((32, 32), 3), ((32, 64), 2), ((64, 32), 3)])
    orders = [sizes_of(cell, seed) for seed in (2**33 + 3, 2**33 + 4, 2**33 + 5)]
    assert all(sorted(o) == sorted(orders[0]) for o in orders)
    assert sorted(orders[0]) == sorted([(32, 32)] * 3 + [(32, 64)] * 2 + [(64, 32)] * 3)
    assert len({tuple(o) for o in orders}) > 1
    assert sizes_of(cell, 2**33 + 3) == orders[0]


@pytest.mark.parametrize("family,sizes", [
    ("tiny", [((32, 32), 2), ((32, 64), 2)]),
    ("tiny_sdxl", [((64, 64), 2), ((128, 64), 2)]),
], ids=["images", "latent_cache"])
def test_a_bucket_mix_runs_correct_with_every_size_warmed(family, sizes):
    cell = mix(tiny_cell(family), sizes)
    cell["check"]["checked_steps"] = 1
    result = run.run_cell(cell, 2**33 + 7, 0.5, True, device="cpu")
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 2 + 1  # the checked step, the other size's warm-up, the window
    assert 0 < result["metrics"]["mfu"]["value"]


def test_the_window_flops_follow_each_batch_size():
    cell = tiny_cell("tiny")
    small = flops.step_flops_per_image(cell["config"], cell["traffic"], (32, 32))
    large = flops.step_flops_per_image(cell["config"], cell["traffic"], (32, 64))
    assert large > 1.5 * small
