"""``portbench/flops.py``: the FlopCounterMode count over the reference
against a hand count of one tiny block, against the same count over the
port's own modules, and at the cells' shapes against the scale the
cells' configurations give."""

import json
import os

import pytest
import torch

from portbench_tiny import ROOT, TINY_SDXL_UNET, TINY_UNET

from portbench import flops
from portbench.reference import models


def test_resnet_and_transformer_blocks_match_a_hand_count():
    b, cin, cout, h, w, temb = 2, 32, 64, 8, 8, 128
    with torch.device("meta"):
        block = models.ResnetBlock2D(cin, cout, temb)
        got = flops.forward_flops(block, torch.zeros(b, cin, h, w), torch.zeros(b, temb))
    hand = 2 * b * h * w * cout * (cin * 9 + cout * 9 + cin) + 2 * b * temb * cout
    assert got == hand

    s, t, d, c, heads = 16, 7, 32, 24, 4
    with torch.device("meta"):
        block = models.BasicTransformerBlock(d, heads, d // heads, c)
        got = flops.forward_flops(block, torch.zeros(b, s, d), torch.zeros(b, t, c))
    attn1 = 4 * 2 * b * s * d * d + 2 * 2 * b * s * s * d
    attn2 = 2 * 2 * b * s * d * d + 2 * 2 * b * t * c * d + 2 * 2 * b * s * t * d
    ff = 2 * b * s * d * 8 * d + 2 * b * s * 4 * d * d
    assert got == attn1 + attn2 + ff


@pytest.mark.parametrize("unet", [TINY_UNET, TINY_SDXL_UNET], ids=["tiny", "tiny_sdxl"])
def test_the_reference_unet_counts_as_the_ports(unet):
    from stable_diffusion_training_tpu_torch.models import UNet2DConditionModel

    with torch.device("meta"):
        x, t, ctx = torch.zeros(2, 4, 16, 16), torch.zeros(2, dtype=torch.long), torch.zeros(2, 227, 32)
        added = None
        if "addition_embed_type" in unet:
            added = {"text_embeds": torch.zeros(2, 16), "time_ids": torch.zeros(2, 6)}
        ours = flops.forward_flops(models.UNet(unet), x, t, ctx, added)
        port = flops.forward_flops(UNet2DConditionModel(**unet, device="meta"), x, t, ctx, added)
    assert ours == port


def test_sd15_at_512_counts_as_the_ports_unet():
    from stable_diffusion_training_tpu_torch.models import UNet2DConditionModel

    with open(os.path.join(ROOT, "portbench", "configs", "sd15.json")) as f:
        config = json.load(f)
    traffic = {"resolution": [512, 512], "batch_size": 1, "inputs": "images"}
    ours = flops.unet_forward_flops(config, traffic, (512, 512))
    with torch.device("meta"):
        port = flops.forward_flops(UNet2DConditionModel(**config["unet"], device="meta"), torch.zeros(1, 4, 64, 64),
                                   torch.zeros(1, dtype=torch.long), torch.zeros(1, 227, 768))
    assert ours == port
    # 816 GFLOP an image at 231 context tokens; 227 tokens here
    assert 0.995 < ours / 816e9 < 1.0


@pytest.mark.parametrize("cell,unet_gflop", [("sd15-train-1088", 5599), ("sd15-f32-train-832", 2672),
                                             ("sdxl-train-1024", 6931)])
def test_the_cells_unet_forward_is_at_the_published_scale(cell, unet_gflop):
    from portbench.run import load_cell

    c = load_cell(cell)
    resolution = c["traffic"]["resolution"]
    got = flops.unet_forward_flops(c["config"], c["traffic"], resolution) / 1e9
    assert 0.99 * unet_gflop < got <= unet_gflop  # at 231 tokens; the step's context has 227
    step = flops.step_flops_per_image(c["config"], c["traffic"], resolution) / 1e9
    assert step >= 3 * got
