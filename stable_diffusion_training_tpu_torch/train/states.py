"""Model and state assembly for the train step: load the models, build each
trained model's optimizer chain, keep the EMA buffers.

Port of ``stable_diffusion_training_tpu/train/states.py`` (``load_models``,
``create_frozen_states``, ``build_lr_schedule``,
``create_lion_optimizer_states``, ``on_device_model_training_state``). Each
rank builds the whole models on its own device; with a mesh, their weights
are then replicated from the mesh's first rank (``parallel.replicate_``),
where the JAX package places them with a replicated sharding. Under
``fsdp_shard_params`` with an ``fsdp`` mesh axis the UNet and the text
encoder are then sharded with FSDP2 (``parallel.fully_shard_``), where the JAX
package places them with its FSDP shardings, and the optimizer state and
the EMA copies are built on each rank's local shards (the Lion momentum
under the co-sharding rule of ``parallel.sharding``); the frozen VAE stays
replicated. Under ``tensor_parallel_shard_params`` with a ``model_parallel``
axis above 1 the weights are replicated over every axis, then the UNet's
and the text encoder's attention (and CLIP's MLP) projections are split
over that axis (``parallel.tensor_parallel_``, the JAX package's
``train_state_tp_sharding``) before the optimizer state and the EMA copies
are built on each rank's leaves: its slices of the split ones, the rest
whole. With both, the split models are then sharded (the JAX package's
``train_state_tp_sharding(fsdp_rest=True)``): FSDP2 shards each rank's
leaves, its slices and the whole ones, over the fsdp axis, and the state
is built on those shards under the composed plan (``shard_plan``). The
frozen VAE's encoder takes the polyphase downsample when
``vae_polyphase_downsample`` says so. It keeps the reference trainer's
quirks as the JAX package does:

- ``on_device_model_training_state`` hard-codes ``adam_to_lion_scale_factor``
  = 7 and does not forward the configured learning rates unless
  ``honor_learning_rates`` (so lr = 1e-6 / 7 and decay = 0.07);
- the EMA buffers start as distinct copies of the initial params.

Each trained model has its own chain, clip_by_global_norm(1) -> Lion
(8-bit or dense) with decoupled weight decay -> learning rate, and its own
optimizer state. A frozen text encoder (``train_text_encoder=False``) keeps
the ``TrainState`` surface with ``set_to_zero`` as its chain, as the JAX
package does: no optimizer state, and its params take no grad.
"""

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn

from ..diffusion import DDPMScheduler
from ..models import AutoencoderKL, CLIPTextModel, UNet2DConditionModel, configs, random_init_
from ..models import hf_io
from ..optim import transforms
from ..optim.lion8bit import QuantizedMomentum, lion, lion_8bit
from ..optim.masks import create_mask
from ..core.mesh import MESH_AXES
from ..parallel import replicate_
from ..parallel.sharding import fully_shard_, local_tensor, shard_plan, tensor_parallel_
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
    updated in place by ``apply_gradients``. ``plan``: the
    ``parallel.sharding.ShardPlan`` of a sharded or split model, or None.
    For a model sharded with FSDP2 (``plan.fsdp``) the params are this
    rank's local shards, views of the sharded parameters' storage. FSDP2
    keeps a root's gathered params registered after a forward that no
    backward follows (a frozen text encoder's): ``params`` reshards the root
    first, so that the next forward gathers what the chain wrote. A split
    model's params are plain parameters, its slices of the split leaves;
    one split and then sharded holds its shards of its slices (the composed
    plan, still ``plan.fsdp``)."""

    def __init__(self, model: nn.Module, tx: transforms.GradientTransformation):
        self.model = model
        self.tx = tx
        self.step = 0
        self.plan = shard_plan(model)
        self.opt_state = tx.init(self.params)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        if self.plan is None or not self.plan.fsdp:
            return dict(self.model.named_parameters())
        self.model.reshard()
        return {name: local_tensor(p) for name, p in self.model.named_parameters()}

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
    (unet/vae/text_encoder) or a family name (``sd15``, ``sdxl``, ``tiny``...),
    whose models get seeded random weights (``seed_init``). For SDXL that is
    the ``text_time`` UNet, the SDXL VAE and tower 1: as in the JAX package,
    tower 2 is not loaded (it runs only in the offline cache pass,
    ``data/latent_cache.py``). The UNet recomputes its blocks and
    feed-forwards in the backward as ``gradient_checkpointing`` and
    ``ff_gradient_checkpointing`` say; the VAE's encoder downsamples through
    the polyphase convs as ``vae_polyphase_downsample`` says."""
    device = resolve_device(device)
    dtype = _DTYPES[training_config.mixed_precision]
    backend = training_config.attention_backend
    polyphase = training_config.vae_polyphase_downsample
    model_dir = training_config.model_path
    if _is_checkpoint_dir(model_dir):
        unet = hf_io.load_unet(os.path.join(model_dir, "unet"), device, dtype, backend)
        vae = hf_io.load_vae(os.path.join(model_dir, "vae"), device, dtype, backend, polyphase)
        text_encoder = hf_io.load_text_encoder(os.path.join(model_dir, "text_encoder"), device, dtype)
    else:
        family = configs.MODEL_FAMILIES[
            model_dir if model_dir in configs.MODEL_FAMILIES else training_config.model_family
        ]
        unet = UNet2DConditionModel(**family["unet"], attention_backend=backend, device=device, dtype=dtype)
        vae = AutoencoderKL(
            **family["vae"], attention_backend=backend, device=device, dtype=dtype, polyphase_downsample=polyphase
        )
        # CLIPTextModel takes tower 1 (a family may give its slot a config
        # with a projection, as the refiner's does; from_config drops it)
        text_encoder = CLIPTextModel.from_config(family["text_encoder"], device=device, dtype=dtype)
        for model in (unet, vae, text_encoder):
            random_init_(model, torch.Generator(device).manual_seed(training_config.seed_init))
    vae.requires_grad_(False)
    unet.set_gradient_checkpointing(
        training_config.gradient_checkpointing, training_config.ff_gradient_checkpointing
    )

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
        plan = shard_plan(model)  # None unless the model is FSDP-sharded or split
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
                plan=plan,
            )
        else:
            opt = lion(
                learning_rate=schedule, b1=0.9, b2=0.99,
                weight_decay=1e-2 * adam_to_lion_scale_factor, mask=decay_mask,
            )
        clip = transforms.clip_by_global_norm(1, plan)
        return TrainState(model, transforms.chain(clip, opt))

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


def state_tensors(*parts: Any) -> List[torch.Tensor]:
    """Every tensor of ``parts`` (``TrainState``s: params and optimizer
    state; ``FrozenModel``s: params; EMA dicts; None), depth first in dict
    order, so the same on every rank: what the replication check and the
    tests' digests cover. Step counts are Python ints, the same on every
    rank by construction."""
    out = []

    def walk(node):
        if isinstance(node, torch.Tensor):
            out.append(node)
        elif isinstance(node, TrainState):
            walk(node.params)
            walk(node.opt_state)
        elif isinstance(node, FrozenModel):
            walk(node.params)
        elif isinstance(node, QuantizedMomentum):
            out.extend((node.codes, node.scales))
        elif isinstance(node, dict):
            for value in node.values():
                walk(value)
        elif isinstance(node, (tuple, list)):
            for value in node:
                walk(value)

    for part in parts:
        walk(part)
    return out


def on_device_model_training_state(training_config: TrainingConfig, device=None, mesh=None):
    """Load, build the optimizer states and the EMA buffers on ``device``
    (cuda unless told otherwise). With a ``mesh`` (``core.create_mesh``)
    the models' weights are first replicated from the mesh's first rank, so
    seeded weights and a ``model_path`` checkpoint give every rank the same
    start; then, when ``training_config.splits_tensors()``, the UNet and the
    text encoder are split over the mesh's ``model_parallel`` axis, and,
    when ``training_config.shards_params()``, (the split or whole models)
    sharded over its ``fsdp`` axis, before the optimizer state and the EMA
    copies are built on the local leaves.
    Returns the JAX package's 7-tuple: ``(unet_state, text_encoder_state,
    unet_ema_params, text_encoder_ema_params, frozen_vae,
    frozen_schedulers, models)``."""
    models = load_models(training_config, device)
    trained = (models["unet"]["unet_model"], models["text_encoder"]["text_encoder_model"])
    replicate_(
        [p.detach() for m in (*trained, models["vae"]["vae_model"]) for p in m.parameters()], mesh, MESH_AXES
    )
    if mesh is not None:
        for model, key in zip(trained, ("unet", "text_encoder")):
            if training_config.splits_tensors():
                tensor_parallel_(model, mesh)  # each rank keeps its slices of the split leaves
            if training_config.shards_params():
                fully_shard_(model, mesh)  # then its shards of every leaf it holds
            # the dicts hold the rank's own leaves: slices, shards or both
            models[key][f"{key}_params"] = {n: local_tensor(p) for n, p in model.named_parameters()}
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
        train_text_encoder=training_config.train_text_encoder,
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
    if not training_config.train_text_encoder:
        # frozen text encoder: the TrainState surface the step expects, with
        # a chain that allocates no momentum
        text_encoder = models["text_encoder"]["text_encoder_model"]
        text_encoder.requires_grad_(False)
        states["text_encoder_state"] = TrainState(text_encoder, transforms.set_to_zero())
    frozen = create_frozen_states(models)

    def ema_copy(params):  # distinct buffers from the params (local shards under FSDP, slices under TP)
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
