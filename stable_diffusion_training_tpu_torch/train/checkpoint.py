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
"""

import json
import os
from typing import Any, Dict, Optional

import torch

from ..diffusion import DDIMScheduler
from ..models import hf_io
from ..optim.lion8bit import QuantizedMomentum
from .states import TrainState

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
    of the models in ``model_object_dict``, written as f32."""
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


def _flatten(node: Any, path: str, tensors: Dict[str, torch.Tensor], scalars: Dict[str, Any]) -> None:
    """Tensors of ``node`` into ``tensors`` and its other leaves (ints,
    floats, bools, strings, None) into ``scalars``, keyed by their path."""
    if isinstance(node, torch.Tensor):
        tensors[path] = node
    elif isinstance(node, torch.Generator):
        tensors[path] = node.get_state()
    elif isinstance(node, TrainState):
        _flatten(node.params, f"{path}/params", tensors, scalars)
        _flatten(node.opt_state, f"{path}/opt_state", tensors, scalars)
        scalars[f"{path}/step"] = node.step
    elif isinstance(node, QuantizedMomentum):
        tensors[f"{path}/codes"] = node.codes
        tensors[f"{path}/scales"] = node.scales
    elif isinstance(node, dict):
        for key, value in node.items():
            _flatten(value, f"{path}/{key}", tensors, scalars)
    elif isinstance(node, (tuple, list)):
        for key, value in zip(_keys(node), node):
            _flatten(value, f"{path}/{key}", tensors, scalars)
        scalars[f"{path}/#"] = len(node)
    elif node is None or isinstance(node, (bool, int, float, str)):
        scalars[path] = node
    else:
        raise TypeError(f"cannot checkpoint {type(node).__name__} at {path}")


@torch.no_grad()
def _restore(like: Any, path: str, tensors: Dict[str, torch.Tensor], scalars: Dict[str, Any]) -> Any:
    """``like`` (a freshly built state) with the saved values: tensors copied
    into its own tensors in place (so module parameters stay the modules'),
    everything else rebuilt."""

    def tensor(key: str, into: torch.Tensor) -> torch.Tensor:
        if key not in tensors:
            raise KeyError(f"the saved state has no tensor {key}")
        saved = tensors[key]
        if saved.shape != into.shape or saved.dtype != into.dtype:
            raise ValueError(
                f"{key}: saved {tuple(saved.shape)} {saved.dtype}, state has "
                f"{tuple(into.shape)} {into.dtype}"
            )
        return into.copy_(saved)

    if isinstance(like, torch.Tensor):
        return tensor(path, like)
    if isinstance(like, torch.Generator):
        like.set_state(tensors[path])
        return like
    if isinstance(like, TrainState):
        _restore(like.params, f"{path}/params", tensors, scalars)
        like.opt_state = _restore(like.opt_state, f"{path}/opt_state", tensors, scalars)
        like.step = scalars[f"{path}/step"]
        return like
    if isinstance(like, QuantizedMomentum):
        return QuantizedMomentum(tensor(f"{path}/codes", like.codes), tensor(f"{path}/scales", like.scales))
    if isinstance(like, dict):
        return {key: _restore(value, f"{path}/{key}", tensors, scalars) for key, value in like.items()}
    if isinstance(like, (tuple, list)):
        if scalars.get(f"{path}/#") != len(like):
            raise ValueError(f"{path}: saved {scalars.get(f'{path}/#')} entries, state has {len(like)}")
        values = [_restore(value, f"{path}/{key}", tensors, scalars) for key, value in zip(_keys(like), like)]
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
    included), EMA and the generator, restorable mid-run and bit for bit."""
    os.makedirs(directory, exist_ok=True)
    payload = {
        "unet_state": unet_state,
        "text_encoder_state": text_encoder_state,
        "unet_ema_params": unet_ema_params if unet_ema_params is not None else {},
        "text_encoder_ema_params": text_encoder_ema_params if text_encoder_ema_params is not None else {},
        "train_rng": train_rng,
    }
    scalars: Dict[str, Any] = {}
    for part in _PARTS:
        tensors: Dict[str, torch.Tensor] = {}
        _flatten(payload[part], part, tensors, scalars)
        hf_io.save_safetensors(tensors, os.path.join(directory, f"{part}.safetensors"))
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
    copied into the template's own, whose shapes and dtypes must match."""
    with open(os.path.join(directory, "structure.json")) as f:
        scalars = json.load(f)
    restored = {}
    for part in _PARTS:
        tensors = hf_io.load_safetensors(os.path.join(directory, f"{part}.safetensors"))
        restored[part] = _restore(template[part], part, tensors, scalars)
        del tensors
    return restored
