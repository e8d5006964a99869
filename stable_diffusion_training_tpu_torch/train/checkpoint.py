"""Checkpoints: the diffusers-layout export and the port's full training state.

Port of ``stable_diffusion_training_tpu/train/checkpoint.py``.

``save_model`` writes what the JAX package's does: a diffusers pipeline
directory (``unet/``, ``vae/``, ``text_encoder/``, ``tokenizer/`` when a
tokenizer is given, ``scheduler/`` and ``model_index.json``) whose scheduler
is always DDIM scaled_linear/v_prediction whatever the training scheduler,
with f32 torch-layout safetensors under diffusers names. The JAX package
loads it (``models.hf_io.load_*_params``) and so does the port
(``models.hf_io.load_*``).

``save_train_state``/``restore_train_state`` keep the full training state,
which the diffusers export leaves out: each trained model's params, its
optimizer state (8-bit momentum codes and scales in the reference order,
dense momentum, step counts, masks), both EMA buffers and the random
generator's state, plus ``metadata.json``. The layout is the port's own: one
safetensors file of tensors per part and ``structure.json`` for the
numbers, flags and empty slots between them. The JAX package writes its
full state with orbax, which only orbax reads; the port does not read those
directories, and a JAX run resumes in the port from its diffusers export
alone (params; the optimizer state starts anew).

Under data parallelism every rank holds the same state: ``save_model`` and
``save_train_state`` write from rank 0 alone while the others wait (the
role of orbax's distributed save), and ``restore_train_state`` reads onto
every rank's own device, then checks that the ranks hold the same bytes.
Under FSDP every rank first takes part in rebuilding each whole tensor from
the shards, many leaves to a collective (params and EMA from their rows,
the Lion codes and scales into the reference order:
``parallel.sharding.gather_rows_many``), rank 0 keeping them in host memory;
then rank 0 writes. Under tensor parallelism the split leaves are
rebuilt the same way, each on its own axis (a row-split kernel's input
channels on torch axis 1); under TP with FSDP in two rounds, the fsdp rows
of each TP slice first, then the slices. The files are those
a one-process run writes for the same state, and a restore reads the whole
files and keeps each rank's shard or slice, so a checkpoint moves between
one process, a data-parallel world and an FSDP or TP world either way. The checkpoint
directory must be one that every rank sees.
"""

import json
import os
from typing import Any, Dict, Optional

import torch

from ..core.distributed import process_count, process_index, run_on
from ..diffusion import DDIMScheduler
from ..models import hf_io
from ..optim.lion8bit import QuantizedMomentum
from ..parallel import assert_replicated
from ..parallel.sharding import ShardPlan, gather_rows_many, shard_plan
from .states import TrainState, state_tensors

_MODEL_INDEX = {
    "_class_name": "FlaxStableDiffusionPipeline",
    "_diffusers_version": "0.21.4",
    "feature_extractor": [None, None],
    "safety_checker": [None, None],
    "scheduler": ["diffusers", "FlaxDDIMScheduler"],
    "text_encoder": ["transformers", "FlaxCLIPTextModel"],
    "tokenizer": ["transformers", "CLIPTokenizer"],
    "unet": ["diffusers", "FlaxUNet2DConditionModel"],
    "vae": ["diffusers", "FlaxAutoencoderKL"],
}


def save_model(
    model_object_dict: dict,
    tokenizer_object: Any,
    unet_params: Dict[str, torch.Tensor],
    text_encoder_params: Dict[str, torch.Tensor],
    vae_params: Dict[str, torch.Tensor],
    output_dir: str,
) -> None:
    """Write a trained pipeline in diffusers layout (the JAX package's and the
    reference trainer's signature); the params are ``{name: tensor}`` dicts
    of the models in ``model_object_dict`` (this rank's shards of an
    FSDP-sharded model's, its slices of a split one's), written as f32.
    Every rank calls it; rank 0 writes."""
    unet_params = _whole(unet_params, shard_plan(model_object_dict["unet"]))
    text_encoder_params = _whole(text_encoder_params, shard_plan(model_object_dict["text_encoder"]))
    run_on(
        process_index() == 0, _write_model, model_object_dict, tokenizer_object, unet_params,
        text_encoder_params, vae_params, output_dir,
    )


def _whole(params: Dict[str, torch.Tensor], plan: Optional[ShardPlan]) -> Dict[str, torch.Tensor]:
    """``params`` with each shard of ``plan`` gathered into its whole leaf,
    several leaves a collective (every rank calls it), rank 0 keeping them
    in host memory (the leaves no rank splits stay where they are, for the
    writer to stream) and the others nothing; ``params`` itself without a
    plan."""
    if plan is None:
        return params
    keep = process_index() == 0
    names = [n for n in params if n in plan.rows]
    fulls = gather_rows_many([g for n in names for g in plan.rows[n].gathers(params[n])], host=True, keep=keep)
    gathered = dict(zip(names, fulls))
    return {n: gathered.get(n, t) for n, t in params.items()} if keep else {}


def _write_model(model_object_dict, tokenizer_object, unet_params, text_encoder_params, vae_params, output_dir):
    os.makedirs(output_dir, exist_ok=True)
    # the reference trainer always embeds DDIM scaled_linear/v_prediction
    DDIMScheduler(
        beta_start=0.00085,
        beta_end=0.012,
        beta_schedule="scaled_linear",
        num_train_timesteps=1000,
        prediction_type="v_prediction",
    ).save_config(os.path.join(output_dir, "scheduler"))

    unet_dir = os.path.join(output_dir, "unet")
    model_object_dict["unet"].save_config(unet_dir)
    hf_io.save_weights(unet_params, unet_dir, "diffusion_pytorch_model.safetensors")

    vae_dir = os.path.join(output_dir, "vae")
    model_object_dict["vae"].save_config(vae_dir)
    hf_io.save_weights(vae_params, vae_dir, "diffusion_pytorch_model.safetensors")

    te_dir = os.path.join(output_dir, "text_encoder")
    hf_io.write_text_encoder_config(model_object_dict["text_encoder"], te_dir)
    hf_io.save_weights(text_encoder_params, te_dir, "model.safetensors")

    if tokenizer_object is not None:
        tokenizer_object.save_pretrained(os.path.join(output_dir, "tokenizer"))

    with open(os.path.join(output_dir, "model_index.json"), "w") as f:
        json.dump(_MODEL_INDEX, f, indent=2, sort_keys=True)


# --- the full training state -------------------------------------------------

_PARTS = ("unet_state", "text_encoder_state", "unet_ema_params", "text_encoder_ema_params", "train_rng")


def _keys(node) -> list:
    """A sequence's keys in paths: a NamedTuple's field names, else indices."""
    return list(node._fields) if hasattr(node, "_fields") else [str(i) for i in range(len(node))]


def _flatten(
    node: Any, path: str, tensors: Dict[str, torch.Tensor], scalars: Dict[str, Any],
    plan: Optional[ShardPlan] = None, leaf: Optional[str] = None, pending: Optional[list] = None,
) -> None:
    """Tensors of ``node`` into ``tensors`` and its other leaves (ints,
    floats, bools, strings, None) into ``scalars``, keyed by their path.
    Under a ``plan`` a sharded leaf (``leaf``: the param name of a params,
    EMA or momentum dict entry) takes its place in ``tensors`` and its
    gathers go to ``pending`` as ``(path, RowGather)``, for
    ``_gather_pending``."""
    if isinstance(node, torch.Tensor):
        tensors[path] = node
        if plan is not None and leaf in plan.rows:
            pending.extend((path, g) for g in plan.rows[leaf].gathers(node))
    elif isinstance(node, torch.Generator):
        tensors[path] = node.get_state()
    elif isinstance(node, TrainState):
        _flatten(node.params, f"{path}/params", tensors, scalars, node.plan, pending=pending)
        _flatten(node.opt_state, f"{path}/opt_state", tensors, scalars, node.plan, pending=pending)
        scalars[f"{path}/step"] = node.step
    elif isinstance(node, QuantizedMomentum):
        keys = (f"{path}/codes", f"{path}/scales")
        tensors[keys[0]], tensors[keys[1]] = node.codes, node.scales
        shard = plan.momentum(leaf, node.codes.shape[1]) if plan is not None and leaf in plan.rows else None
        if shard is not None:
            pending.extend(zip(keys, shard.gathers(node.codes, node.scales)))
    elif isinstance(node, dict):
        for key, value in node.items():
            _flatten(value, f"{path}/{key}", tensors, scalars, plan, key, pending)
    elif isinstance(node, (tuple, list)):
        for key, value in zip(_keys(node), node):
            _flatten(value, f"{path}/{key}", tensors, scalars, plan, pending=pending)
        scalars[f"{path}/#"] = len(node)
    elif node is None or isinstance(node, (bool, int, float, str)):
        scalars[path] = node
    else:
        raise TypeError(f"cannot checkpoint {type(node).__name__} at {path}")


def _gather_pending(tensors: Dict[str, torch.Tensor], pending: list) -> Dict[str, torch.Tensor]:
    """``tensors`` with each pending shard replaced by its whole tensor, in
    place and in host memory, on rank 0; the gathers are collectives, so
    every rank calls it, and the other ranks get nothing to write."""
    if not pending:
        return tensors
    keep = process_index() == 0
    fulls = gather_rows_many([g for _, g in pending], host=True, keep=keep)
    if not keep:
        return {}
    for (path, _), full in zip(pending, fulls):
        tensors[path] = full
    return tensors


@torch.no_grad()
def _restore(
    like: Any, path: str, tensors: Dict[str, torch.Tensor], scalars: Dict[str, Any],
    plan: Optional[ShardPlan] = None, leaf: Optional[str] = None,
) -> Any:
    """``like`` (a freshly built state) with the saved values: tensors copied
    into its own tensors in place (so module parameters stay the modules'),
    everything else rebuilt. Under a ``plan`` a sharded leaf takes this
    rank's shard of the whole saved tensor."""
    sharded = plan is not None and leaf in plan.rows

    def saved(key: str) -> torch.Tensor:
        if key not in tensors:
            raise KeyError(f"the saved state has no tensor {key}")
        return tensors[key]

    def fill(key: str, into: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
        if value.shape != into.shape or value.dtype != into.dtype:
            raise ValueError(
                f"{key}: saved {tuple(value.shape)} {value.dtype}, state has "
                f"{tuple(into.shape)} {into.dtype}"
            )
        return into.copy_(value)

    if isinstance(like, torch.Tensor):
        return fill(path, like, plan.take(leaf, saved(path)) if sharded else saved(path))
    if isinstance(like, torch.Generator):
        like.set_state(tensors[path])
        return like
    if isinstance(like, TrainState):
        _restore(like.params, f"{path}/params", tensors, scalars, like.plan)
        like.opt_state = _restore(like.opt_state, f"{path}/opt_state", tensors, scalars, like.plan)
        like.step = scalars[f"{path}/step"]
        return like
    if isinstance(like, QuantizedMomentum):
        codes, scales = saved(f"{path}/codes"), saved(f"{path}/scales")
        shard = plan.momentum(leaf, like.codes.shape[1]) if sharded else None
        if shard is not None:
            codes, scales = shard.take(codes, scales)
        return QuantizedMomentum(fill(f"{path}/codes", like.codes, codes), fill(f"{path}/scales", like.scales, scales))
    if isinstance(like, dict):
        return {key: _restore(value, f"{path}/{key}", tensors, scalars, plan, key) for key, value in like.items()}
    if isinstance(like, (tuple, list)):
        if scalars.get(f"{path}/#") != len(like):
            raise ValueError(f"{path}: saved {scalars.get(f'{path}/#')} entries, state has {len(like)}")
        values = [_restore(value, f"{path}/{key}", tensors, scalars, plan)
                  for key, value in zip(_keys(like), like)]
        if hasattr(like, "_fields"):  # a NamedTuple
            return type(like)(*values)
        return type(like)(values)
    if path not in scalars:
        raise KeyError(f"the saved state has no value {path}")
    return scalars[path]


def save_train_state(
    directory: str,
    unet_state: TrainState,
    text_encoder_state: TrainState,
    unet_ema_params: Optional[Dict[str, torch.Tensor]],
    text_encoder_ema_params: Optional[Dict[str, torch.Tensor]],
    train_rng: torch.Generator,
    step_metadata: Optional[Dict[str, Any]] = None,
) -> None:
    """Full-state checkpoint: params, optimizer state (quantized momentum
    included), EMA and the generator, restorable mid-run and bit for bit.
    Every rank calls it (under FSDP every rank gathers); rank 0 writes."""
    payload = {
        "unet_state": unet_state,
        "text_encoder_state": text_encoder_state,
        "unet_ema_params": unet_ema_params if unet_ema_params is not None else {},
        "text_encoder_ema_params": text_encoder_ema_params if text_encoder_ema_params is not None else {},
        "train_rng": train_rng,
    }
    # the EMA buffers are sharded as their model's params
    plans = {"unet_ema_params": unet_state.plan, "text_encoder_ema_params": text_encoder_state.plan}
    scalars: Dict[str, Any] = {}
    parts = {}
    for part in _PARTS:
        tensors, pending = {}, []
        _flatten(payload[part], part, tensors, scalars, plans.get(part), pending=pending)
        parts[part] = _gather_pending(tensors, pending)
    run_on(process_index() == 0, _write_train_state, directory, parts, scalars, step_metadata)


def _write_train_state(directory, parts, scalars, step_metadata):
    os.makedirs(directory, exist_ok=True)
    for part in _PARTS:
        hf_io.save_safetensors(parts[part], os.path.join(directory, f"{part}.safetensors"))
    with open(os.path.join(directory, "structure.json"), "w") as f:
        json.dump(scalars, f, indent=1, sort_keys=True)
    if step_metadata is not None:
        with open(os.path.join(directory, "metadata.json"), "w") as f:
            json.dump(step_metadata, f, indent=2)


def restore_train_state(directory: str, template: Dict[str, Any]) -> Dict[str, Any]:
    """Restore a ``save_train_state`` directory onto ``template``, a freshly
    built state with the same keys as ``save_train_state``'s arguments
    (``unet_state``, ``text_encoder_state``, ``unet_ema_params``,
    ``text_encoder_ema_params`` ({} for none), ``train_rng``). Tensors are
    copied into the template's own, whose shapes and dtypes must match;
    an FSDP-sharded or split template takes each rank's shard or slice of
    the whole saved tensors. With several ranks each restores onto its own template; ranks
    that hold whole states are then checked to hold the same state
    (``parallel.assert_replicated``)."""
    with open(os.path.join(directory, "structure.json")) as f:
        scalars = json.load(f)
    plans = {
        "unet_ema_params": template["unet_state"].plan,
        "text_encoder_ema_params": template["text_encoder_state"].plan,
    }
    restored = {}
    for part in _PARTS:
        tensors = hf_io.load_safetensors(os.path.join(directory, f"{part}.safetensors"))
        restored[part] = _restore(template[part], part, tensors, scalars, plans.get(part))
        del tensors
    if process_count() > 1 and not any(plans.values()):
        parts = [restored[part] for part in _PARTS[:-1]]
        tensors = state_tensors(*parts) + [restored["train_rng"].get_state()]
        assert_replicated(tensors, f"state restored from {directory}")
    return restored
