"""Weights in and out of the port's models.

The port's own copy of the name mapping in
``stable_diffusion_training_tpu/models/hf_io.py``:

- ``jax_params_to_state_dict`` turns the JAX package's nested params (numpy
  arrays) into a state dict that the port's models load with
  ``strict=True``: conv kernels ``(kh, kw, I, O)`` -> ``(O, I, kh, kw)``,
  dense kernels ``(in, out)`` -> ``(out, in)``, ``scale``/``embedding`` ->
  ``weight``, ``name_N`` -> ``name.N``, ``to_out`` -> ``to_out.0``, and the
  CLIP tower into transformers' ``text_model.*`` layout.
- ``load_unet``/``load_vae``/``load_text_encoder`` build a model from a
  diffusers checkpoint directory (``config.json`` + ``.safetensors``), read
  by ``load_safetensors``, a small reader of the format's layout (u64 header
  length, JSON header, raw little-endian tensors), so no ``safetensors``
  package is needed.
"""

import json
import os
import struct
from typing import Any, Dict

import numpy as np
import torch

from ..utils.device import resolve_device
from .clip import CLIPTextModel
from .unet import UNet2DConditionModel
from .vae import AutoencoderKL

# TimestepEmbedding's linear_1/linear_2: the trailing _N is part of the name
_KEEP_UNDERSCORE = {"linear_1", "linear_2"}


def _unfold(name: str) -> str:
    """``down_blocks_0`` -> ``down_blocks.0``; ``resnets_1`` -> ``resnets.1``."""
    if name in _KEEP_UNDERSCORE:
        return name
    out, acc = [], []
    for piece in name.split("_"):
        if piece.isdigit():
            if acc:
                out.append("_".join(acc))
            out.append(piece)
            acc = []
        else:
            acc.append(piece)
    if acc:
        out.append("_".join(acc))
    return ".".join(out)


def _clip_key(key: str) -> str:
    """The JAX CLIP tower's flat names -> transformers' nesting."""
    key = key.replace("mlp_fc1", "mlp.fc1").replace("mlp_fc2", "mlp.fc2")
    if key.startswith(("token_embedding", "position_embedding")):
        return f"text_model.embeddings.{key}"
    if key.startswith("layers."):
        return f"text_model.encoder.{key}"
    return f"text_model.{key}"


def jax_params_to_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX package params (a nested dict of arrays) -> the port's state dict.

    A tree with a top-level ``token_embedding`` is the CLIP text tower; every
    other tree (UNet, VAE) maps to diffusers' names directly.
    """
    flat: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [k])
            return
        value = np.asarray(node)
        leaf = path[-1]
        base = ".".join(_unfold(p).replace("to_out", "to_out.0") for p in path[:-1])
        if leaf == "kernel":
            value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.transpose(1, 0)
            leaf = "weight"
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        flat[f"{base}.{leaf}" if base else leaf] = torch.tensor(value)

    walk(params, [])
    if "token_embedding" in params:
        flat = {_clip_key(k): v for k, v in flat.items()}
    return flat


# --- safetensors -------------------------------------------------------------

_ST_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Read a ``.safetensors`` file into CPU tensors."""
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
        data = bytearray(f.read())
    out = {}
    for key, info in header.items():
        if key == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {key} has unsupported dtype {info['dtype']}")
        start, end = info["data_offsets"]
        if not 0 <= start <= end <= len(data):
            raise ValueError(f"{path}: tensor {key} lies outside the file")
        if end > start:
            count = (end - start) // dtype.itemsize
            tensor = torch.frombuffer(data, dtype=dtype, offset=start, count=count).clone()
        else:
            tensor = torch.empty(0, dtype=dtype)
        out[key] = tensor.reshape(info["shape"])
    return out


def _load_weights(directory: str) -> Dict[str, torch.Tensor]:
    for name in ("diffusion_pytorch_model.safetensors", "model.safetensors"):
        path = os.path.join(directory, name)
        if os.path.exists(path):
            return load_safetensors(path)
    raise FileNotFoundError(f"no .safetensors weights in {directory}")


def load_config_json(directory: str) -> Dict[str, Any]:
    with open(os.path.join(directory, "config.json")) as f:
        return json.load(f)


def _build(cls, directory: str, state_dict, device, dtype, **kw):
    model = cls.from_config(load_config_json(directory), device="meta", dtype=dtype, **kw)
    model = model.to_empty(device=resolve_device(device))
    model.load_state_dict(state_dict, strict=True)
    return model.eval()


def load_unet(directory: str, device=None, dtype=torch.float32, attention_backend="auto"):
    return _build(
        UNet2DConditionModel, directory, _load_weights(directory), device, dtype,
        attention_backend=attention_backend,
    )


def load_vae(directory: str, device=None, dtype=torch.float32, attention_backend="auto"):
    """Newer diffusers names the VAE mid-block attention ``to_q/to_k/to_v/
    to_out.0``; map them to the 0.21-era ``query/key/value/proj_attn``."""
    renames = {".to_q.": ".query.", ".to_k.": ".key.", ".to_v.": ".value.",
               ".to_out.0.": ".proj_attn."}

    def rekey(key: str) -> str:
        if ".attentions." in key:
            for old, new in renames.items():
                key = key.replace(old, new)
        return key

    sd = {rekey(k): v for k, v in _load_weights(directory).items()}
    return _build(
        AutoencoderKL, directory, sd, device, dtype, attention_backend=attention_backend
    )


def load_text_encoder(directory: str, device=None, dtype=torch.float32):
    sd = {
        k: v for k, v in _load_weights(directory).items() if not k.endswith("position_ids")
    }
    return _build(CLIPTextModel, directory, sd, device, dtype)
