"""The model FLOPs of one training image, from the configuration's shapes.

``forward_flops`` runs a reference module once on the meta device under
``torch.utils.flop_counter.FlopCounterMode`` (matmuls and convolutions, 2
per multiply-add; nothing is allocated). A step's FLOPs an image are the
trained models' forward at three times (forward and the two products of
its backward) and the frozen ones' at once; recompute under gradient
checkpointing is not counted.
"""

from typing import Dict, Sequence

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference.models import CLIPText, UNet, VAEEncoder
from .traffic import context_tokens, latent_shape


def forward_flops(module: torch.nn.Module, *inputs, **kwargs) -> int:
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        module(*inputs, **kwargs)
    return counter.get_total_flops()


def unet_forward_flops(config: Dict, traffic: Dict, resolution: Sequence[int]) -> int:
    _, c, h, w = latent_shape(traffic, config, resolution)
    unet_cfg = config["unet"]
    with torch.device("meta"):
        unet = UNet(unet_cfg)
        x = torch.zeros(1, c, h, w)
        t = torch.zeros(1, dtype=torch.long)
        ctx = torch.zeros(1, context_tokens(config["recipe"]), unet_cfg["cross_attention_dim"])
        added = None
        if unet_cfg.get("addition_embed_type") == "text_time":
            pooled = unet_cfg["projection_class_embeddings_input_dim"] - 6 * unet_cfg["addition_time_embed_dim"]
            added = {"text_embeds": torch.zeros(1, pooled), "time_ids": torch.zeros(1, 6)}
        return forward_flops(unet, x, t, ctx, added)


def text_forward_flops(config: Dict) -> int:
    recipe = config["recipe"]
    with torch.device("meta"):
        ids = torch.zeros(recipe["context_window_concatenation_count"], recipe["text_encoder_context_window"],
                          dtype=torch.long)
        return forward_flops(CLIPText(config["text_encoder"]), ids)


def vae_encode_flops(config: Dict, resolution: Sequence[int]) -> int:
    h, w = resolution
    with torch.device("meta"):
        return forward_flops(VAEEncoder(config["vae"]), torch.zeros(1, 3, h, w))


def step_flops_per_image(config: Dict, traffic: Dict, resolution: Sequence[int]) -> float:
    """The model FLOPs of one image of the cell's step at ``resolution``."""
    total = 3 * unet_forward_flops(config, traffic, resolution)
    if traffic["inputs"] == "images":
        trained = config["recipe"]["train_text_encoder"]
        total += (3 if trained else 1) * text_forward_flops(config)
        total += vae_encode_flops(config, resolution)
    return float(total)
