"""Training configuration.

The port's own copy of ``stable_diffusion_training_tpu/train/config.py``:
``TrainingConfig`` with every field and default of the JAX package's (the
reference trainer's 29 fields plus the JAX package's additions), and
``training_config_from_dict``, which keeps only the dataclass fields of a
raw ``model_properties`` JSON dict. Fields that name JAX or TPU machinery
(``compilation_cache_path``, ``mesh_shape``, ``use_pallas_lion`` ...) keep
their names so one JSON file configures both packages; the comments below
say which of them the port ignores. A field that asks for what the port
does not have yet (a mesh of more than one device, FSDP or TP sharding,
the polyphase VAE downsample, SDXL micro-conditioning) raises
``NotImplementedError`` naming its ROADMAP item.
"""

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional


def not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to the PyTorch trainer yet (ROADMAP Queue 1 item {item})")


@dataclass
class TrainingConfig:
    model_path: str
    batch_size: int
    learning_rate: float
    unet_learning_rate: float
    text_encoder_learning_rate: float
    lr_scheduler: str
    adam_to_lion_scale_factor: float
    compilation_cache_path: str  # XLA's compilation cache: ignored by the port
    keep_compiled_fn_in_cache: bool  # XLA's compilation cache: ignored by the port
    text_encoder_context_window: int
    context_window_concatenation_count: int
    aot_compile: bool  # XLA ahead-of-time compiles: ignored by the port (eager steps)
    strip_bos_eos_token: bool
    offset_noise_magnitude: float
    min_snr_gamma_magnitude: float
    perturbation_noise_magnitude: float
    image_area_root: List[int]
    minimum_axis_length: List[int]
    beta_scheduler: str
    prediction_type: str
    excluded_layer_pattern_from_weight_decay: List[str]
    excluded_layer_from_quantization: List[str]
    quant_block_size: int
    quantize_unet_state: bool
    quantize_text_encoder_state: bool
    accumulate_unet_ema: bool
    accumulate_text_encoder_ema: bool
    ema_rate: float

    # --- the JAX package's additions, defaulted so reference configs load ---
    model_family: str = "sd15"  # architecture family when building fresh models
    # multi-device layout: one device only (more raises, not ported)
    mesh_shape: Optional[List[int]] = None
    mesh_axis_names: Optional[List[str]] = None
    fsdp_shard_params: bool = False  # param sharding (True raises, not ported)
    tensor_parallel_shard_params: bool = False  # tensor parallelism (True raises, not ported)
    gradient_checkpointing: bool = False  # recompute each UNet block in the backward
    ff_gradient_checkpointing: bool = False  # recompute each transformer feed-forward
    train_unet: bool = True
    train_text_encoder: bool = True  # False: frozen text encoder
    mixed_precision: str = "bfloat16"  # computation and param dtype of the models
    attention_backend: str = "auto"  # "auto" | "flash" | "xla" | "xla_remat"
    # the VAE encoder's stride-2 convs as four stride-1 polyphase convs
    # (True raises, not ported; off by default in the JAX package)
    vae_polyphase_downsample: bool = False
    # quantized momentum through the fused kernel; None = on (the default),
    # False = the plain jnp-path math
    use_pallas_lion: Optional[bool] = None
    # quantized leaves with at most this many blocks update together in one
    # launch (the kernel's multi-leaf entry); 0 = one launch per leaf
    lion_bucket_max_nb: int = 65536
    # 8-bit Lion compander: "exact" (the reference's op order) or "fast"
    # (the same math reassociated; not bitwise against exact)
    lion_compander: str = "exact"
    # momentum layout: "auto" or "reference" (the jnp path with the exact
    # compander); the port stores the reference order either way
    lion_momentum_layout: str = "auto"
    # the reference ignores the configured learning rates and scale factor
    # (hard-coded scale 7, the 1e-6 default LRs) and has only a constant
    # schedule; True forwards the configured unet/text LRs and
    # adam_to_lion_scale_factor and enables lr_scheduler "cosine" |
    # "warmup_cosine" with lr_warmup_steps / lr_decay_steps
    honor_learning_rates: bool = False
    lr_warmup_steps: int = 0
    lr_decay_steps: int = 0
    seed_init: int = 0  # seed of the fresh-family random weights
    grad_accumulation_steps: int = 1  # micro-batches per update
    use_latent_cache: bool = False  # batches carry latent_moments
    vae_encode_chunk: int = 0  # VAE encode micro-batch, 0 = whole
    # batches carry a precomputed encoder_hidden_states; pair with
    # train_text_encoder=False
    cached_text_context: bool = False
    # batches carry pooled embeds + time_ids (SDXL; True raises, not ported)
    sdxl_micro_conditioning: bool = False
    # micro-conditioning time ids: 6 for the SDXL base model, 5 for the refiner
    sdxl_time_ids_count: int = 6
    device_prefetch_depth: int = 1  # batches in flight ahead of the step (loader)
    bucket_rounding: int = 64  # aspect-ratio bucket grid step (loader)

    def __post_init__(self):
        if self.mesh_shape is not None and math.prod(self.mesh_shape) > 1:
            raise not_ported(f"mesh_shape={list(self.mesh_shape)} (more than one device)", 7)
        if self.fsdp_shard_params:
            raise not_ported("fsdp_shard_params=True", 7)
        if self.tensor_parallel_shard_params:
            raise not_ported("tensor_parallel_shard_params=True", 7)
        if self.vae_polyphase_downsample:
            raise not_ported("vae_polyphase_downsample=True (ops/conv.py)", 9)
        if self.sdxl_micro_conditioning:
            raise not_ported("sdxl_micro_conditioning=True (SDXL)", 6)
        if self.cached_text_context and self.train_text_encoder:
            # zero grads + Lion weight decay would silently decay the
            # "trainable" TE toward zero while conditioning comes from the
            # stale precomputed context — never a sane combination
            raise ValueError(
                "cached_text_context=True requires train_text_encoder=False "
                "(the precomputed context bypasses the text encoder; "
                "training it would only apply weight decay to unused params)"
            )
        if self.vae_encode_chunk and self.batch_size % self.vae_encode_chunk:
            raise ValueError(
                f"vae_encode_chunk={self.vae_encode_chunk} must divide "
                f"batch_size={self.batch_size} (the encode runs over whole "
                "micro-batches)"
            )

    def replace(self, **kwargs) -> "TrainingConfig":
        return dataclasses.replace(self, **kwargs)


_FIELD_NAMES = {f.name for f in dataclasses.fields(TrainingConfig)}
_REQUIRED = {
    f.name
    for f in dataclasses.fields(TrainingConfig)
    if f.default is dataclasses.MISSING and f.default_factory is dataclasses.MISSING
}


def training_config_from_dict(config_dict: Dict[str, Any]) -> TrainingConfig:
    """Build the typed config from the raw JSON dict, keeping only dataclass
    fields — the reference trainer's subset rule (its ``training.py:38-40``)."""
    missing = _REQUIRED - set(config_dict)
    if missing:
        raise KeyError(f"model_properties config missing keys: {sorted(missing)}")
    subset = {k: v for k, v in config_dict.items() if k in _FIELD_NAMES}
    return TrainingConfig(**subset)
