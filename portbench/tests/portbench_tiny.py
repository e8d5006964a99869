"""Tiny cells for the CPU tests: the benchmark's configurations with the
port's ``tiny`` and ``tiny_sdxl`` families' widths, small batches and
images, everything else as a cell has it."""

import copy
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_UNET = dict(
    sample_size=8, in_channels=4, out_channels=4,
    down_block_types=["CrossAttnDownBlock2D", "DownBlock2D"], up_block_types=["UpBlock2D", "CrossAttnUpBlock2D"],
    block_out_channels=[32, 64], layers_per_block=1, attention_head_dim=2, cross_attention_dim=32,
)
TINY_SDXL_UNET = dict(
    sample_size=8, in_channels=4, out_channels=4,
    down_block_types=["DownBlock2D", "CrossAttnDownBlock2D"], up_block_types=["CrossAttnUpBlock2D", "UpBlock2D"],
    block_out_channels=[32, 64], layers_per_block=1, transformer_layers_per_block=[1, 2], attention_head_dim=[2, 4],
    cross_attention_dim=32, use_linear_projection=True, addition_embed_type="text_time", addition_time_embed_dim=8,
    projection_class_embeddings_input_dim=8 * 6 + 16,
)
TINY_VAE = dict(in_channels=3, out_channels=3, block_out_channels=[32, 64], layers_per_block=1, latent_channels=4,
                sample_size=32, scaling_factor=0.18215)
TINY_CLIP = dict(vocab_size=1000, hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
                 max_position_embeddings=77, hidden_act="quick_gelu")

END_TO_END = [{"name": "images_per_s", "unit": "images/s"}, {"name": "peak_mem_gb", "unit": "GB"},
              {"name": "setup_s", "unit": "s"}]
PER_LAYER = [{"name": n, "unit": "%"} for n in ("mfu", "idle_share", "attention_roofline", "gemm_conv_roofline")] + [
    {"name": n, "unit": "ms"} for n in ("optimizer_host_ms", "optimizer_device_ms", "elementwise_ms")]


def tiny_cell(family: str = "tiny", dtype: str = "float32", limits=None) -> dict:
    """A cell of the ``tiny`` (SD1.5-shaped, images) or ``tiny_sdxl``
    (latent cache) family at batch 4."""
    name = "sd15" if family == "tiny" else "sdxl"
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as f:
        config = copy.deepcopy(json.load(f))
    config["unet"] = copy.deepcopy(TINY_UNET if family == "tiny" else TINY_SDXL_UNET)
    config["vae"], config["text_encoder"] = dict(TINY_VAE), dict(TINY_CLIP)
    config["recipe"].update(model_path=family, model_family=family)
    traffic = {"mixed_precision": dtype, "batch_size": 4, "distinct_batches": 4, "tf32": False,
               "resolution": [32, 32] if family == "tiny" else [64, 64],
               "inputs": "images" if family == "tiny" else "latent_cache"}
    return {"name": f"{family}-{dtype}", "chips": 1, "run_seconds": 1, "config": config, "traffic": traffic,
            "check": {"checked_steps": 3, "trace_steps": 2, "reference_block_rows": 2,
                      "limits": limits or {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-2, "ema_gap": 1e-4}},
            "end_to_end": END_TO_END, "per_layer": PER_LAYER}
