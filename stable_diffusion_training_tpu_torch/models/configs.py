"""Canonical model configurations: SD1.5, SD2.1, SDXL, plus tiny test sizes.

The port's own copy of ``stable_diffusion_training_tpu/models/configs.py``:
the architecture families are explicit data, so models can be built without
network access and checkpoints only carry weights. The port runs every
family: ``sd15``, ``sd21`` (linear projections, heads of 64 at every level,
a 1024-wide context from the 23-layer OpenCLIP ViT-H with exact-erf
``gelu``; v-prediction at 768x768), ``sdxl``, ``sdxl_refiner`` and the
``tiny*`` ones.
"""

from typing import Any, Dict

SD15_UNET: Dict[str, Any] = dict(
    sample_size=64,
    in_channels=4,
    out_channels=4,
    down_block_types=(
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "DownBlock2D",
    ),
    up_block_types=(
        "UpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
    ),
    block_out_channels=(320, 640, 1280, 1280),
    layers_per_block=2,
    attention_head_dim=8,  # head *count* (diffusers SD1.5 naming quirk)
    cross_attention_dim=768,
    use_linear_projection=False,
)

SD21_UNET: Dict[str, Any] = dict(
    sample_size=96,
    in_channels=4,
    out_channels=4,
    down_block_types=(
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "DownBlock2D",
    ),
    up_block_types=(
        "UpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
    ),
    block_out_channels=(320, 640, 1280, 1280),
    layers_per_block=2,
    attention_head_dim=(5, 10, 20, 20),  # d_head=64 at every scale
    cross_attention_dim=1024,
    use_linear_projection=True,
)

SDXL_UNET: Dict[str, Any] = dict(
    sample_size=128,
    in_channels=4,
    out_channels=4,
    down_block_types=(
        "DownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
    ),
    up_block_types=(
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "UpBlock2D",
    ),
    block_out_channels=(320, 640, 1280),
    layers_per_block=2,
    transformer_layers_per_block=(1, 2, 10),
    attention_head_dim=(5, 10, 20),
    num_attention_heads=None,
    cross_attention_dim=2048,
    use_linear_projection=True,
    addition_embed_type="text_time",
    addition_time_embed_dim=256,
    projection_class_embeddings_input_dim=2816,
)

SDXL_REFINER_UNET: Dict[str, Any] = dict(
    # stabilityai/stable-diffusion-xl-refiner-1.0 layout: 4 levels with
    # attention only on the middle two, TE2-only 1280-dim context, and
    # aesthetic-score micro-conditioning (5 time ids: 2560 = 1280 + 5*256).
    # Real checkpoints carry their own unet/config.json through from_config;
    # this entry exists for fresh-init benchmarks/tests.
    sample_size=128,
    in_channels=4,
    out_channels=4,
    down_block_types=(
        "DownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "DownBlock2D",
    ),
    up_block_types=(
        "UpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "UpBlock2D",
    ),
    block_out_channels=(384, 768, 1536, 1536),
    layers_per_block=2,
    transformer_layers_per_block=4,
    attention_head_dim=(6, 12, 24, 24),  # d_head=64 at every scale
    cross_attention_dim=1280,
    use_linear_projection=True,
    addition_embed_type="text_time",
    addition_time_embed_dim=256,
    projection_class_embeddings_input_dim=2560,
)

SD_VAE: Dict[str, Any] = dict(
    in_channels=3,
    out_channels=3,
    block_out_channels=(128, 256, 512, 512),
    layers_per_block=2,
    latent_channels=4,
    sample_size=512,
    scaling_factor=0.18215,
)

SDXL_VAE: Dict[str, Any] = dict(SD_VAE, sample_size=1024, scaling_factor=0.13025)

CLIP_VIT_L: Dict[str, Any] = dict(  # SD1.5 / SDXL text_encoder 1
    vocab_size=49408,
    hidden_size=768,
    intermediate_size=3072,
    num_hidden_layers=12,
    num_attention_heads=12,
    max_position_embeddings=77,
    hidden_act="quick_gelu",
)

OPEN_CLIP_VIT_H: Dict[str, Any] = dict(  # SD2.1 (ships layers 1..23 of 24)
    vocab_size=49408,
    hidden_size=1024,
    intermediate_size=4096,
    num_hidden_layers=23,
    num_attention_heads=16,
    max_position_embeddings=77,
    hidden_act="gelu",
)

OPEN_CLIP_VIT_BIGG: Dict[str, Any] = dict(  # SDXL text_encoder 2
    vocab_size=49408,
    hidden_size=1280,
    intermediate_size=5120,
    num_hidden_layers=32,
    num_attention_heads=20,
    max_position_embeddings=77,
    hidden_act="gelu",
    projection_dim=1280,
)

# --- tiny configs for tests / CPU CI ---------------------------------------
TINY_UNET: Dict[str, Any] = dict(
    sample_size=8,
    in_channels=4,
    out_channels=4,
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    block_out_channels=(32, 64),
    layers_per_block=1,
    attention_head_dim=2,
    cross_attention_dim=32,
)

TINY_VAE: Dict[str, Any] = dict(
    in_channels=3,
    out_channels=3,
    block_out_channels=(32, 64),
    layers_per_block=1,
    latent_channels=4,
    sample_size=32,
    scaling_factor=0.18215,
)

TINY_SDXL_UNET: Dict[str, Any] = dict(  # SDXL shape (text_time micro-cond)
    sample_size=8,
    in_channels=4,
    out_channels=4,
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
    up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
    block_out_channels=(32, 64),
    layers_per_block=1,
    transformer_layers_per_block=(1, 2),
    attention_head_dim=(2, 4),
    cross_attention_dim=32,
    use_linear_projection=True,
    addition_embed_type="text_time",
    addition_time_embed_dim=8,
    projection_class_embeddings_input_dim=8 * 6 + 16,  # 6 time_ids + pooled 16
)

TINY_CLIP: Dict[str, Any] = dict(
    vocab_size=1000,
    hidden_size=32,
    intermediate_size=64,
    num_hidden_layers=2,
    num_attention_heads=4,
    max_position_embeddings=77,
    hidden_act="quick_gelu",
)

TINY_CLIP_PROJ: Dict[str, Any] = dict(TINY_CLIP, projection_dim=16)

TINY_SDXL_REFINER_UNET: Dict[str, Any] = dict(  # refiner shape: 5 time ids
    TINY_SDXL_UNET,
    cross_attention_dim=32,
    projection_class_embeddings_input_dim=8 * 5 + 16,  # 5 time_ids + pooled 16
)

MODEL_FAMILIES = {
    "sd15": dict(unet=SD15_UNET, vae=SD_VAE, text_encoder=CLIP_VIT_L),
    "sd21": dict(unet=SD21_UNET, vae=SD_VAE, text_encoder=OPEN_CLIP_VIT_H),
    "sdxl": dict(
        unet=SDXL_UNET,
        vae=SDXL_VAE,
        text_encoder=CLIP_VIT_L,
        text_encoder_2=OPEN_CLIP_VIT_BIGG,
    ),
    "tiny": dict(unet=TINY_UNET, vae=TINY_VAE, text_encoder=TINY_CLIP),
    "tiny_sdxl": dict(
        unet=TINY_SDXL_UNET,
        vae=TINY_VAE,
        text_encoder=TINY_CLIP,
        text_encoder_2=TINY_CLIP_PROJ,
    ),
    # dual-tower-width tiny SDXL: cross_attention_dim = TE1 + TE2 hidden
    # (32+32), the real SDXL proportion (768+1280=2048) — used where the
    # dual-tower concat context must flow end-to-end (in-loop SDXL eval,
    # cached_text_context with context_use_tower_2=True)
    "tiny_sdxl_dual": dict(
        unet=dict(TINY_SDXL_UNET, cross_attention_dim=64),
        vae=TINY_VAE,
        text_encoder=TINY_CLIP,
        text_encoder_2=TINY_CLIP_PROJ,
    ),
    "sdxl_refiner": dict(
        unet=SDXL_REFINER_UNET,
        vae=SDXL_VAE,
        text_encoder=OPEN_CLIP_VIT_BIGG,  # TE2 only; slot kept for assembly
        text_encoder_2=OPEN_CLIP_VIT_BIGG,
    ),
    "tiny_sdxl_refiner": dict(
        unet=TINY_SDXL_REFINER_UNET,
        vae=TINY_VAE,
        text_encoder=TINY_CLIP_PROJ,
        text_encoder_2=TINY_CLIP_PROJ,
    ),
}
