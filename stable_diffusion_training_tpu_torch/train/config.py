"""Training configuration.

The port's own copy of ``stable_diffusion_training_tpu/train/config.py``:
``TrainingConfig`` with every field and default of the JAX package's (the
reference trainer's 29 fields plus the JAX package's additions), and
``training_config_from_dict``, which keeps only the dataclass fields of a
raw ``model_properties`` JSON dict. Fields that name JAX or TPU machinery
(``compilation_cache_path``, ``mesh_shape``, ``use_pallas_lion`` ...) keep
their names so one JSON file configures both packages; the comments below
say which of them the port ignores. ``mesh_shape`` lays the ranks out:
``None`` (every rank on the data axis), ``[W, 1]`` (data parallelism),
``[D, T]`` or ``[D, F, T]`` (``data_parallel``, ``fsdp``,
``model_parallel``), its product the process group's size. The rows of a
batch split over data x fsdp ranks; the ``model_parallel`` ranks of a row
block see the same rows. ``fsdp_shard_params`` shards params, grads, EMA
and the Lion momentum over the ``fsdp`` axis (FSDP2; HSDP with D > 1); with
it off the fsdp ranks are data parallel, as in the JAX package (``[D, F,
T]`` then trains as ``[D * F, 1, T]``), and on an fsdp axis of 1 it trains
as the default does (FSDP2 runs in a process group, every shard the whole
leaf). ``tensor_parallel_shard_params`` splits the attention and CLIP
projections over the ``model_parallel`` axis (Megatron's column and row
splits, ``parallel.tensor_parallel_``); without it that axis holds replicas
that all compute the same step, as in the JAX package, and on an axis of 1
it changes nothing. With both, FSDP2 shards the split models' local leaves
over the fsdp axis (``shards_params()`` and ``splits_tensors()`` both
true). ``vae_polyphase_downsample`` builds the frozen VAE's encoder with
the polyphase stride-2 convs (``ops.conv``). A mesh axis the port does not
know raises ``NotImplementedError`` naming its ROADMAP item.
``batch_size`` is the global batch, as in the reference: the data x fsdp
ranks must divide it, and each rank's rows must divide into
``grad_accumulation_steps`` micro-batches.
"""

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ..core.distributed import process_count
from ..core.mesh import AXIS_DATA, AXIS_FSDP, AXIS_TENSOR, MESH_AXES


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
    # rank layout: None = every rank on the data axis; [W, 1] the same;
    # [D, F, T] data x fsdp x model
    mesh_shape: Optional[List[int]] = None
    mesh_axis_names: Optional[List[str]] = None
    fsdp_shard_params: bool = False  # ZeRO-3 over the fsdp axis (FSDP2)
    tensor_parallel_shard_params: bool = False  # Megatron splits over the model_parallel axis
    gradient_checkpointing: bool = False  # recompute each UNet block in the backward
    ff_gradient_checkpointing: bool = False  # recompute each transformer feed-forward
    train_unet: bool = True
    train_text_encoder: bool = True  # False: frozen text encoder
    mixed_precision: str = "bfloat16"  # computation and param dtype of the models
    attention_backend: str = "auto"  # "auto" | "flash" | "xla" | "xla_remat"
    # the VAE encoder's stride-2 convs as four stride-1 polyphase convs
    # (ops.conv; off by default, as in the JAX package)
    vae_polyphase_downsample: bool = False
    # quantized momentum through the fused kernel; None = on (the default),
    # False = the plain jnp-path math
    use_pallas_lion: Optional[bool] = None
    # accepted for the JAX package's configs; changes nothing: every
    # quantized leaf of a model updates in one launch of the leaf-table
    # entry, and the result is bitwise the same for any value
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
    # batches carry pooled embeds + time_ids (SDXL micro-conditioning)
    sdxl_micro_conditioning: bool = False
    # micro-conditioning time ids: 6 for the SDXL base model, 5 for the refiner
    sdxl_time_ids_count: int = 6
    device_prefetch_depth: int = 1  # batches in flight ahead of the step (loader)
    bucket_rounding: int = 64  # aspect-ratio bucket grid step (loader)

    def __post_init__(self):
        axes = self.mesh_axes()
        for axis, size in axes.items():
            if axis not in MESH_AXES and size > 1:
                raise not_ported(f"mesh_shape={list(self.mesh_shape)} ({axis} axis of {size})", 7)
        world = math.prod(axes.values()) if axes else process_count()
        if world != process_count():
            raise ValueError(
                f"mesh_shape={list(self.mesh_shape)} holds {world} ranks; the process "
                f"group has {process_count()} (torchrun --nproc_per_node={world})"
            )
        rows = self.batch_shards()
        if self.batch_size % rows or (self.batch_size // rows) % self.grad_accumulation_steps:
            raise ValueError(
                f"batch_size={self.batch_size} must split into {rows} rank(s) of whole "
                f"grad_accumulation_steps={self.grad_accumulation_steps} micro-batches"
            )
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

    def mesh_axes(self) -> Dict[str, int]:
        """``{axis name: size}`` of ``mesh_shape`` (``mesh_axis_names``, else
        data and model axes for two dims, data, fsdp and model for three);
        {} when it is None."""
        if self.mesh_shape is None:
            return {}
        shape = [int(s) for s in self.mesh_shape]
        default = (AXIS_DATA, AXIS_TENSOR) if len(shape) <= 2 else (AXIS_DATA, AXIS_FSDP, AXIS_TENSOR)
        names = list(self.mesh_axis_names or default[: len(shape)])
        if len(names) != len(shape):
            raise ValueError(f"mesh_shape={shape} and mesh_axis_names={names} differ in length")
        return dict(zip(names, shape))

    def batch_shards(self) -> int:
        """Ranks that split a batch's rows: data x fsdp of ``mesh_shape``,
        else the process group's size (1 without one)."""
        axes = self.mesh_axes()
        if not axes:
            return process_count()
        return axes.get(AXIS_DATA, 1) * axes.get(AXIS_FSDP, 1)

    def shards_params(self) -> bool:
        """Whether params, grads, EMA and momentum are sharded over the
        mesh's ``fsdp`` axis (``fsdp_shard_params`` and a ``mesh_shape``
        with that axis). On an axis of one rank FSDP2 runs and every shard
        is the whole leaf: the numbers are the default's."""
        return self.fsdp_shard_params and AXIS_FSDP in self.mesh_axes()

    def splits_tensors(self) -> bool:
        """Whether the UNet's and the text encoder's attention (and CLIP's
        MLP) projections are split over the mesh's ``model_parallel`` axis
        (``tensor_parallel_shard_params`` and that axis above one rank)."""
        return self.tensor_parallel_shard_params and self.mesh_axes().get(AXIS_TENSOR, 1) > 1

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
