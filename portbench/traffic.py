"""The general generator of a training cell's inputs, read from a traffic
file (``portbench/traffic/<name>.json``).

A traffic file gives the precision, the image size, the batch, what a
batch holds (``images``: pixels and token ids, the step encodes them;
``latent_cache``: the VAE posterior's moments, the frozen towers' context,
pooled embeds and micro-conditioning ids, as the offline cache writes
them) and how many distinct batches the run cycles through. Every batch
and every step's draws (the VAE sample's noise, the noise, the offset and
perturbation noises, the timesteps) are made on the device from the seed.
The first batches are the checked steps': their rows all differ.

The image size is ``"resolution": [h, w]`` with ``distinct_batches``
batches, or a bucket mix: ``"buckets": [{"resolution": [h, w], "batches":
n}, ...]``, ``n`` batches of each bucket, their order drawn from the seed
(every seed runs the same set of sizes). Each bucket is a tier of the
training configuration's buckets (its area's root, rounded up, and its
shorter side), whose step table then holds it.
"""

import math
from typing import Dict, List, Sequence, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def buckets(traffic: Dict) -> List[Tuple[Tuple[int, int], int]]:
    """``[((h, w), batches), ...]`` of a traffic file."""
    if "buckets" in traffic:
        return [(tuple(b["resolution"]), b["batches"]) for b in traffic["buckets"]]
    return [(tuple(traffic["resolution"]), traffic["distinct_batches"])]


def tiers(traffic: Dict) -> List[Tuple[int, int]]:
    """The (area root, minimum axis) bucket tiers of the training
    configuration: for a bucket ``(h, w)`` on the 64-pixel grid, the tier's
    bucket of width ``min(h, w)`` is ``max(h, w)`` high."""
    return [(math.isqrt(h * w - 1) + 1, min(h, w)) for (h, w), _ in buckets(traffic)]


def latent_factor(config: Dict) -> int:
    return 2 ** (len(config["vae"]["block_out_channels"]) - 1)


def latent_shape(traffic: Dict, config: Dict, resolution: Sequence[int]) -> Tuple[int, int, int, int]:
    factor = latent_factor(config)
    h, w = resolution
    return traffic["batch_size"], config["vae"]["latent_channels"], h // factor, w // factor


def batch_resolution(batch: Dict[str, torch.Tensor], config: Dict) -> Tuple[int, int]:
    """The image size of a batch made by ``make_batch``."""
    if "pixel_values" in batch:
        return tuple(batch["pixel_values"].shape[-2:])
    h, w = batch["latent_moments"].shape[-2:]
    return h * latent_factor(config), w * latent_factor(config)


def context_tokens(recipe: Dict) -> int:
    window, concat = recipe["text_encoder_context_window"], recipe["context_window_concatenation_count"]
    if not recipe["strip_bos_eos_token"]:
        return window * concat
    return 2 * (window - 1) if concat == 1 else (window - 2) * concat + 2


def make_batch(traffic: Dict, config: Dict, resolution, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    b, c, lh, lw = latent_shape(traffic, config, resolution)
    h, w = resolution
    recipe = config["recipe"]
    if traffic["inputs"] == "images":
        concat = recipe["context_window_concatenation_count"]
        return {
            "pixel_values": torch.rand(b, 3, h, w, generator=gen, device=device) * 2 - 1,
            "input_ids": torch.randint(0, config["text_encoder"]["vocab_size"],
                                       (b * concat, recipe["text_encoder_context_window"]),
                                       generator=gen, device=device),
        }
    if traffic["inputs"] == "latent_cache":
        unet = config["unet"]
        pooled = unet["projection_class_embeddings_input_dim"] - 6 * unet["addition_time_embed_dim"]
        mean = torch.randn(b, c, lh, lw, generator=gen, device=device)
        logvar = torch.randn(b, c, lh, lw, generator=gen, device=device) * 0.1 - 6.0
        # original size, crop top-left, target size: the uncropped image
        ids = torch.tensor([h, w, 0, 0, h, w], dtype=torch.float32, device=device)
        return {
            "latent_moments": torch.cat([mean, logvar], dim=1),
            "encoder_hidden_states": torch.randn(b, context_tokens(recipe), unet["cross_attention_dim"],
                                                 generator=gen, device=device),
            "pooled_text_embeds": torch.randn(b, pooled, generator=gen, device=device),
            "time_ids": ids.expand(b, 6).contiguous(),
        }
    raise ValueError(f"unknown inputs {traffic['inputs']!r}")


def make_draws(traffic: Dict, config: Dict, resolution, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    shape = latent_shape(traffic, config, resolution)
    b, c = shape[:2]
    # the VAE sample's noise is in the latents' dtype: the VAE's on the
    # image path, the cache's f32 on the latent path
    eps_dtype = DTYPES[traffic["mixed_precision"]] if traffic["inputs"] == "images" else torch.float32
    return {
        "latent_eps": torch.randn(shape, generator=gen, device=device, dtype=eps_dtype),
        "noise": torch.randn(shape, generator=gen, device=device),
        "noise_offset": torch.randn(b, c, 1, 1, generator=gen, device=device),
        "perturb_noise": torch.randn(shape, generator=gen, device=device),
        "timesteps": torch.randint(0, 1000, (b,), generator=gen, device=device),
    }


def make_inputs(traffic: Dict, config: Dict, seed: int, device) -> List[Tuple[Dict, Dict]]:
    """One pair of (batch, draws) for each of the traffic's batches; a
    bucket mix in an order drawn from the seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [res for res, n in buckets(traffic) for _ in range(n)]
    if len(buckets(traffic)) > 1:
        sizes = [sizes[i] for i in torch.randperm(len(sizes), generator=gen, device=device).tolist()]
    return [(make_batch(traffic, config, res, gen, device), make_draws(traffic, config, res, gen, device))
            for res in sizes]
