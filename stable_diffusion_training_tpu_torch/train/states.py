"""Model and state assembly for the train step: load the models, build each
trained model's optimizer chain, keep the EMA buffers.

Port of ``stable_diffusion_training_tpu/train/states.py`` (``load_models``,
``create_frozen_states``, ``build_lr_schedule``,
``create_lion_optimizer_states``, ``on_device_model_training_state``) on one
device with no mesh. It keeps the reference trainer's quirks as the JAX
package does:

- ``on_device_model_training_state`` hard-codes ``adam_to_lion_scale_factor``
  = 7 and does not forward the configured learning rates unless
  ``honor_learning_rates`` (so lr = 1e-6 / 7 and decay = 0.07);
- the EMA buffers start as distinct copies of the initial params.

Each trained model has its own chain, clip_by_global_norm(1) -> Lion
(8-bit or dense) with decoupled weight decay -> learning rate, and its own
optimizer state.
"""

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from ..diffusion import DDPMScheduler
from ..models import AutoencoderKL, CLIPTextModel, UNet2DConditionModel, configs, random_init_
from ..models import hf_io
from ..optim import transforms
from ..optim.lion8bit import lion, lion_8bit
from ..optim.masks import create_mask
from ..utils.device import resolve_device
from .config import TrainingConfig

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float32": torch.float32,
    "fp32": torch.float32,
    "no": torch.float32,
}


@dataclass
class FrozenModel:
    """A model or scheduler that the step calls but does not train, with its
    state (the JAX package's ``FrozenModel``)."""

    call: Any
    params: Any


class TrainState:
    """A trained model with its optimizer chain and state, the counterpart of
    flax's ``TrainState``: ``params`` are the module's own parameters,
    updated in place by ``apply_gradients``."""

    def __init__(self, model: nn.Module, tx: transforms.GradientTransformation):
        self.model = model
        self.tx = tx
        self.step = 0
        self.opt_state = tx.init(self.params)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @torch.no_grad()
    def apply_gradients(self, grads: Dict[str, torch.Tensor]) -> "TrainState":
        params = self.params
        updates, self.opt_state = self.tx.update(grads, self.opt_state, params)
        transforms.apply_updates_(params, updates)
        self.step += 1
        return self


def _is_checkpoint_dir(path: str) -> bool:
    return os.path.isdir(os.path.join(path, "unet"))


def load_models(training_config: TrainingConfig, device=None) -> dict:
    """UNet, VAE, text encoder and the training scheduler, in the JAX
    package's nested dict. ``model_path`` is a diffusers checkpoint directory
    (unet/vae/text_encoder) or a family name (``sd15``, ``tiny``...), whose
    models get seeded random weights (``seed_init``)."""
    if training_config.gradient_checkpointing or training_config.ff_gradient_checkpointing:
        raise NotImplementedError(
            "gradient_checkpointing / ff_gradient_checkpointing are not ported yet "
            "(ROADMAP Queue 1)"
        )
    device = resolve_device(device)
    dtype = _DTYPES[training_config.mixed_precision]
    backend = training_config.attention_backend
    model_dir = training_config.model_path
    if _is_checkpoint_dir(model_dir):
        unet = hf_io.load_unet(os.path.join(model_dir, "unet"), device, dtype, backend)
        vae = hf_io.load_vae(os.path.join(model_dir, "vae"), device, dtype, backend)
        text_encoder = hf_io.load_text_encoder(os.path.join(model_dir, "text_encoder"), device, dtype)
    else:
        family = configs.MODEL_FAMILIES[
            model_dir if model_dir in configs.MODEL_FAMILIES else training_config.model_family
        ]
        unet = UNet2DConditionModel(**family["unet"], attention_backend=backend, device=device, dtype=dtype)
        vae = AutoencoderKL(**family["vae"], attention_backend=backend, device=device, dtype=dtype)
        text_encoder = CLIPTextModel(**family["text_encoder"], device=device, dtype=dtype)
        for model in (unet, vae, text_encoder):
            random_init_(model, torch.Generator(device).manual_seed(training_config.seed_init))
    vae.requires_grad_(False)

    noise_scheduler = DDPMScheduler(
        beta_start=0.00085,
        beta_end=0.012,
        beta_schedule=training_config.beta_scheduler,
        num_train_timesteps=1000,
        prediction_type=training_config.prediction_type,
        device=device,
    )
    return {
        "unet": {"unet_params": dict(unet.named_parameters()), "unet_model": unet},
        "vae": {"vae_params": dict(vae.named_parameters()), "vae_model": vae},
        "text_encoder": {
            "text_encoder_params": dict(text_encoder.named_parameters()),
            "text_encoder_model": text_encoder,
        },
        "schedulers": {
            "noise_scheduler_state": noise_scheduler.create_state(),
            "noise_scheduler_object": noise_scheduler,
        },
        "tokenizer": None,
    }


def create_frozen_states(models: dict) -> dict:
    """The VAE and the noise scheduler as ``FrozenModel``s."""
    return {
        "vae_state": FrozenModel(call=models["vae"]["vae_model"], params=models["vae"]["vae_params"]),
        "schedulers_state": FrozenModel(
            call=models["schedulers"]["noise_scheduler_object"],
            params=models["schedulers"]["noise_scheduler_state"],
        ),
    }


def build_lr_schedule(
    learning_rate: float,
    lr_scheduler: str = "constant",
    warmup_steps: int = 0,
    decay_steps: int = 0,
) -> Callable[[int], float]:
    """``constant`` (with an optional linear warm-up from 0), ``cosine`` or
    ``warmup_cosine``, as the JAX package builds them from optax."""
    if lr_scheduler in ("constant", "", None):
        if warmup_steps:
            return transforms.linear_schedule(0.0, learning_rate, warmup_steps)
        return transforms.constant_schedule(learning_rate)
    if lr_scheduler in ("cosine", "warmup_cosine"):
        if not decay_steps:
            raise ValueError(f"{lr_scheduler!r} requires lr_decay_steps > 0")
        return transforms.warmup_cosine_decay_schedule(
            init_value=0.0,
            peak_value=learning_rate,
            warmup_steps=warmup_steps if lr_scheduler == "warmup_cosine" else 0,
            decay_steps=decay_steps,
        )
    raise ValueError(f"unknown lr_scheduler {lr_scheduler!r}")


def create_lion_optimizer_states(
    models: dict,
    train_unet: bool = True,
    train_text_encoder: bool = True,
    adam_to_lion_scale_factor: float = 7,
    u_net_learning_rate: float = 1e-6,
    text_encoder_learning_rate: float = 1e-6,
    excluded_layer_pattern_from_weight_decay: Optional[list] = None,
    excluded_layer_from_quantization: Optional[list] = None,
    lion_8bit_block_size: Optional[int] = None,
    quantize_unet_state: bool = False,
    quantize_text_encoder_state: bool = False,
    use_pallas_lion: Optional[bool] = None,
    lr_scheduler: str = "constant",
    lr_warmup_steps: int = 0,
    lr_decay_steps: int = 0,
    bucket_max_nb: int = 0,
    compander: str = "exact",
    momentum_layout: str = "auto",
) -> dict:
    """clip(1) -> Lion (8-bit or dense) ``TrainState`` per trained model:
    lr = configured / scale factor, decay = 1e-2 * scale factor, b1 = 0.9,
    b2 = 0.99. Masks and momentum order come from the JAX parameter paths."""
    excluded_wd = excluded_layer_pattern_from_weight_decay or []
    excluded_q = excluded_layer_from_quantization or []

    def build(model, learning_rate, quantize):
        schedule = build_lr_schedule(
            learning_rate / adam_to_lion_scale_factor,
            lr_scheduler=lr_scheduler,
            warmup_steps=lr_warmup_steps,
            decay_steps=lr_decay_steps,
        )
        decay_mask = create_mask(model, excluded_wd) if excluded_wd else None
        if quantize:
            opt = lion_8bit(
                learning_rate=schedule,
                b1=0.9,
                b2=0.99,
                weight_decay=1e-2 * adam_to_lion_scale_factor,
                mask=decay_mask,
                block_size=lion_8bit_block_size,
                excluded_layer_mask=create_mask(model, excluded_q),
                use_pallas=use_pallas_lion,
                bucket_max_nb=bucket_max_nb,
                compander=compander,
                momentum_layout=momentum_layout,
                leaf_orders={
                    name: perm for name, (_, perm) in hf_io.jax_param_paths(model).items()
                },
            )
        else:
            opt = lion(
                learning_rate=schedule, b1=0.9, b2=0.99,
                weight_decay=1e-2 * adam_to_lion_scale_factor, mask=decay_mask,
            )
        return TrainState(model, transforms.chain(transforms.clip_by_global_norm(1), opt))

    unet_state = text_encoder_state = None
    if train_unet:
        unet_state = build(models["unet"]["unet_model"], u_net_learning_rate, quantize_unet_state)
    if train_text_encoder:
        text_encoder_state = build(
            models["text_encoder"]["text_encoder_model"],
            text_encoder_learning_rate,
            quantize_text_encoder_state,
        )
    return {"unet_state": unet_state, "text_encoder_state": text_encoder_state}


def on_device_model_training_state(training_config: TrainingConfig, device=None):
    """Load, build the optimizer states and the EMA buffers on ``device``
    (cuda unless told otherwise). Returns the JAX package's 7-tuple:
    ``(unet_state, text_encoder_state, unet_ema_params,
    text_encoder_ema_params, frozen_vae, frozen_schedulers, models)``."""
    if not training_config.train_text_encoder:
        raise NotImplementedError(
            "train_text_encoder=False (frozen text encoder) is not ported yet (ROADMAP Queue 1)"
        )
    models = load_models(training_config, device)
    # the reference hard-codes scale 7 and drops the configured LRs;
    # honor_learning_rates opts out of that quirk
    lr_kwargs = dict(adam_to_lion_scale_factor=7)
    if training_config.honor_learning_rates:
        lr_kwargs = dict(
            adam_to_lion_scale_factor=training_config.adam_to_lion_scale_factor,
            u_net_learning_rate=training_config.unet_learning_rate,
            text_encoder_learning_rate=training_config.text_encoder_learning_rate,
            lr_scheduler=training_config.lr_scheduler,
            lr_warmup_steps=training_config.lr_warmup_steps,
            lr_decay_steps=training_config.lr_decay_steps,
        )
    states = create_lion_optimizer_states(
        models=models,
        train_unet=True,
        train_text_encoder=True,
        **lr_kwargs,
        excluded_layer_pattern_from_weight_decay=(
            training_config.excluded_layer_pattern_from_weight_decay
        ),
        excluded_layer_from_quantization=training_config.excluded_layer_from_quantization,
        lion_8bit_block_size=training_config.quant_block_size,
        quantize_unet_state=training_config.quantize_unet_state,
        quantize_text_encoder_state=training_config.quantize_text_encoder_state,
        use_pallas_lion=training_config.use_pallas_lion,
        bucket_max_nb=training_config.lion_bucket_max_nb,
        compander=training_config.lion_compander,
        momentum_layout=training_config.lion_momentum_layout,
    )
    frozen = create_frozen_states(models)

    def ema_copy(params):  # distinct buffers from the params
        return {name: p.detach().clone() for name, p in params.items()}

    unet_ema = (
        ema_copy(models["unet"]["unet_params"]) if training_config.accumulate_unet_ema else None
    )
    text_encoder_ema = (
        ema_copy(models["text_encoder"]["text_encoder_params"])
        if training_config.accumulate_text_encoder_ema
        else None
    )
    model_objects = {
        "unet": models["unet"]["unet_model"],
        "vae": models["vae"]["vae_model"],
        "text_encoder": models["text_encoder"]["text_encoder_model"],
        "schedulers": models["schedulers"]["noise_scheduler_object"],
        "tokenizer": models["tokenizer"],
    }
    return (
        states["unet_state"],
        states["text_encoder_state"],
        unet_ema,
        text_encoder_ema,
        frozen["vae_state"],
        frozen["schedulers_state"],
        model_objects,
    )
