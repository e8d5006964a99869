"""Weights in and out of the port's models.

The port's own copy of the name mapping in
``stable_diffusion_training_tpu/models/hf_io.py``:

- ``jax_params_to_state_dict`` turns the JAX package's nested params (numpy
  arrays) into a state dict that the port's models load with
  ``strict=True``: conv kernels ``(kh, kw, I, O)`` -> ``(O, I, kh, kw)``,
  dense kernels ``(in, out)`` -> ``(out, in)``, ``scale``/``embedding`` ->
  ``weight``, ``name_N`` -> ``name.N``, ``to_out`` -> ``to_out.0``, and the
  CLIP tower into transformers' ``text_model.*`` layout (SDXL's second
  encoder keeps its tower under ``text_model`` and ``text_projection`` at
  the top).
- ``jax_param_paths`` gives each torch parameter its path in the JAX
  package's param tree and the permutation from the torch layout to the JAX
  one: the optimizer matches its masks on those paths and keeps its
  quantized momentum in the JAX leaf's element order.
- ``momentum_from_jax`` and ``lion_momentum_from_jax`` carry the JAX 8-bit
  Lion state across (any of its momentum layouts, numpy in), so a JAX train
  state (params, EMA params through ``jax_params_to_state_dict``, Lion
  momentum) continues in the port.
- ``load_unet``/``load_vae``/``load_text_encoder``/``load_text_encoder_2``
  build a model from a diffusers checkpoint directory (``config.json`` +
  ``.safetensors``), read by ``load_safetensors``, a small reader of the
  format's layout (u64 header length, JSON header, raw little-endian
  tensors), so no ``safetensors`` package is needed; ``save_safetensors``
  writes that layout, ``save_weights`` a model's params in f32 under their
  diffusers names and ``save_text_encoder`` a text encoder's folder
  (transformers' ``config.json`` and ``model.safetensors``). The port's
  text encoders carry transformers' own names, so neither direction
  re-keys them (the JAX package folds ``embeddings.`` and
  ``encoder.layers`` on load and unfolds them on save).
"""

import json
import os
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..utils.device import resolve_device
from .clip import CLIPTextModel, CLIPTextModelWithProjection
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

    A tree with a top-level ``token_embedding`` is the CLIP text tower, one
    with a top-level ``text_projection`` SDXL's second text encoder (the
    tower under ``text_model``); every other tree (UNet, VAE) maps to
    diffusers' names directly.
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
    elif "text_projection" in params:
        tower = "text_model."
        flat = {_clip_key(k[len(tower):]) if k.startswith(tower) else k: v for k, v in flat.items()}
    return flat


# --- JAX parameter paths and the JAX train state ----------------------------

_CLIP_PREFIXES = ("text_model.embeddings.", "text_model.encoder.", "text_model.")


def _jax_module_path(module_name: str, clip: bool) -> Tuple[str, ...]:
    """A torch module name as the JAX tree nests it: ``down_blocks.0`` ->
    ``down_blocks_0``, ``to_out.0`` -> ``to_out``; the CLIP tower without
    transformers' ``text_model``/``embeddings``/``encoder`` levels and with
    ``mlp_fc1``/``mlp_fc2``."""
    if clip:
        for prefix in _CLIP_PREFIXES:
            if module_name.startswith(prefix):
                module_name = module_name[len(prefix):]
                break
        module_name = module_name.replace("mlp.fc", "mlp_fc")
    path = []
    for part in module_name.split(".") if module_name else []:
        if part.isdigit():
            if path[-1] != "to_out":
                path[-1] = f"{path[-1]}_{part}"
        else:
            path.append(part)
    return tuple(path)


def jax_param_paths(
    module: nn.Module,
) -> Dict[str, Tuple[Tuple[str, ...], Optional[Tuple[int, ...]]]]:
    """``{torch name: (JAX path, perm)}`` in ``named_parameters`` order.

    The path's last component is JAX's leaf name: ``kernel`` for Dense and
    Conv weights, ``scale`` for norm weights, ``embedding`` for embedding
    tables, ``bias``. ``perm`` takes the torch tensor to the JAX layout
    (``tensor.permute(perm)``): ``(1, 0)`` for a Dense kernel, ``(2, 3, 1,
    0)`` for a Conv kernel, None where the layouts agree. SDXL's second text
    encoder nests its tower under ``text_model`` in the JAX tree too."""
    clip = isinstance(module, CLIPTextModel)
    projected = isinstance(module, CLIPTextModelWithProjection)
    out = {}
    for name, param in module.named_parameters():
        module_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(module_name)
        perm = None
        if leaf == "bias":
            pass
        elif isinstance(owner, nn.Embedding):
            leaf = "embedding"
        elif isinstance(owner, (nn.GroupNorm, nn.LayerNorm)):
            leaf = "scale"
        else:
            leaf = "kernel"
            perm = {2: (1, 0), 4: (2, 3, 1, 0)}.get(param.dim())
        path = _jax_module_path(module_name, clip)
        if projected and module_name.startswith("text_model."):
            path = ("text_model",) + path
        out[name] = (path + (leaf,), perm)
    return out


def _momentum_layout(codes_shape, scales_shape) -> str:
    """The JAX package's quantized-momentum layouts, told apart by the scales
    shape: transposed ``(1, nb)``, narrow ``(nb, 1)``, dense tile-grouped
    ``(gpr * x / r, r)`` (a single block is ``(1, 1)`` in both non-dense
    layouts; its codes tell them apart)."""
    if tuple(scales_shape) == (1, 1):
        return "narrow" if codes_shape[0] == 1 and codes_shape[1] > 1 else "transposed"
    if scales_shape[0] == 1:
        return "transposed"
    if scales_shape[1] == 1:
        return "narrow"
    return "dense"


def momentum_from_jax(codes, scales) -> Tuple[torch.Tensor, torch.Tensor]:
    """One JAX quantized momentum leaf (numpy, any layout) -> the port's
    codes ``(n_blocks, bs)`` int8 and scales ``(n_blocks,)`` f32, both in
    the reference order of the leaf's flat elements."""
    codes, scales = np.asarray(codes), np.asarray(scales)
    layout = _momentum_layout(codes.shape, scales.shape)
    if layout == "dense":
        # codes are the leaf's (size/128, 128) flat view; scales tile-grouped:
        # row t*gpr + j, lane c holds block (t*r + c) * gpr + j
        x = codes.shape[0]
        rows, r = scales.shape
        gpr = rows * r // x
        codes = codes.reshape(-1, 128 // gpr)
        scales = scales.reshape(x // r, gpr, r).transpose(0, 2, 1)
    elif layout == "transposed":
        codes = codes.T
    return (
        torch.tensor(np.ascontiguousarray(codes, dtype=np.int8)),
        torch.tensor(np.ascontiguousarray(scales, dtype=np.float32).reshape(-1)),
    )


def lion_momentum_from_jax(mu_quant: Dict[str, Any], module: nn.Module, device=None) -> Dict[str, Any]:
    """The JAX 8-bit Lion momentum tree (``ScaleBy8bitLionState.mu_quant``,
    numpy leaves) -> the port's ``{torch name: momentum}``: a
    ``QuantizedMomentum`` for each ``(codes, scales)`` leaf, the dense f32
    momentum permuted to the torch layout for the others."""
    from ..optim.lion8bit import QuantizedMomentum

    device = resolve_device(device)
    out = {}
    for name, (path, perm) in jax_param_paths(module).items():
        node = mu_quant
        for key in path:
            node = node[key]
        if isinstance(node, tuple):
            codes, scales = momentum_from_jax(*node)
            out[name] = QuantizedMomentum(codes.to(device), scales.to(device))
        else:
            dense = torch.tensor(np.asarray(node, dtype=np.float32))
            if perm:
                dense = dense.permute(*np.argsort(perm)).contiguous()
            out[name] = dense.to(device)
    return out


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


_ST_NAMES = {dtype: name for name, dtype in _ST_DTYPES.items()}


def save_safetensors(
    tensors: Dict[str, torch.Tensor],
    path: str,
    metadata: Optional[Dict[str, str]] = None,
    dtype: Optional[torch.dtype] = None,
) -> None:
    """Write ``tensors`` as a ``.safetensors`` file: u64 header length, the
    JSON header (padded with spaces to 8 bytes), then each tensor's raw
    little-endian bytes, in the given order, with no gaps. Tensors move to
    the host one at a time, each cast to ``dtype`` on the way if given."""
    header: Dict[str, Any] = {"__metadata__": dict(metadata)} if metadata else {}
    offset = 0
    for key, t in tensors.items():
        dt = dtype or t.dtype
        if dt not in _ST_NAMES:
            raise ValueError(f"tensor {key} has unsupported dtype {dt}")
        nbytes = t.numel() * dt.itemsize
        header[key] = {
            "dtype": _ST_NAMES[dt], "shape": list(t.shape), "data_offsets": [offset, offset + nbytes],
        }
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            if t.numel():
                host = t.detach().to(dtype or t.dtype).contiguous().cpu().reshape(-1)
                f.write(host.view(torch.uint8).numpy().data)


def save_weights(params: Dict[str, torch.Tensor], directory: str, filename: str) -> None:
    """A model's params (``{diffusers name: tensor}``) as f32 safetensors in
    ``directory``, the layout the JAX package's ``hf_io`` writes and reads."""
    os.makedirs(directory, exist_ok=True)
    save_safetensors(
        params, os.path.join(directory, filename), metadata={"format": "pt"}, dtype=torch.float32
    )


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


def _text_encoder_weights(directory: str) -> Dict[str, torch.Tensor]:
    return {
        k: v for k, v in _load_weights(directory).items() if not k.endswith("position_ids")
    }


def load_text_encoder(directory: str, device=None, dtype=torch.float32):
    return _build(CLIPTextModel, directory, _text_encoder_weights(directory), device, dtype)


def load_text_encoder_2(directory: str, device=None, dtype=torch.float32):
    """SDXL's ``text_encoder_2/``: transformers' ``CLIPTextModelWithProjection``."""
    return _build(
        CLIPTextModelWithProjection, directory, _text_encoder_weights(directory), device, dtype
    )


def write_text_encoder_config(text_encoder, directory: str) -> None:
    """transformers' ``config.json`` for a text encoder: its config, with the
    architecture named after its class (``CLIPTextModel`` or
    ``CLIPTextModelWithProjection``)."""
    cfg = dict(text_encoder.config.to_dict())
    cfg.update({
        "architectures": [type(text_encoder).__name__], "model_type": "clip_text_model",
        "torch_dtype": "float32",
    })
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2, sort_keys=True)


def save_text_encoder(text_encoder, directory: str) -> None:
    """A text encoder's folder as transformers writes it: ``config.json``
    and its params in f32 in ``model.safetensors``."""
    write_text_encoder_config(text_encoder, directory)
    save_weights(text_encoder.state_dict(), directory, "model.safetensors")


def save_model_folder(model, directory: str) -> None:
    """A UNet's or VAE's folder as diffusers writes it: ``config.json`` and
    its params in f32 in ``diffusion_pytorch_model.safetensors``."""
    model.save_config(directory)
    save_weights(model.state_dict(), directory, "diffusion_pytorch_model.safetensors")
