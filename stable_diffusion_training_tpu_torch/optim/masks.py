"""Boolean masks over a model's parameters, matched on the JAX package's
parameter paths.

Port of ``stable_diffusion_training_tpu/optim/masks.py``: a leaf is excluded
(``False``) when any excluded name is one of the components of its path.
The path is the JAX tree's (``models.hf_io.jax_param_paths``), not the torch
name: JAX calls a norm's weight ``scale`` and an embedding's ``embedding``
where torch says ``weight``, so matching ``["bias", "scale", "embedding"]``
on torch names would weight-decay and quantize every norm.
"""

from typing import Dict, Sequence

from torch import nn

from ..models.hf_io import jax_param_paths


def create_mask(module: nn.Module, excluded_layer_list: Sequence[str]) -> Dict[str, bool]:
    """``{torch name: True}`` for included leaves, ``False`` where any
    excluded name is a component of the leaf's JAX path."""
    return {
        name: not any(excluded in path for excluded in excluded_layer_list)
        for name, (path, _) in jax_param_paths(module).items()
    }
