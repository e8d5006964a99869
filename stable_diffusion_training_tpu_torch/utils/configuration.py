"""Diffusers-layout configuration records for the port's schedulers and models.

Port of ``stable_diffusion_training_tpu/utils/configuration.py``: objects
record their constructor kwargs into a frozen ``.config`` and round-trip it
through ``config.json`` / ``scheduler_config.json`` files laid out like a
diffusers checkpoint directory.
"""

import inspect
import json
import os
from types import MappingProxyType
from typing import Any, Dict, Optional


class FrozenConfig:
    """Immutable attribute/namespace view over a config dict."""

    def __init__(self, data: Dict[str, Any]):
        object.__setattr__(self, "_data", MappingProxyType(dict(data)))

    def __getattr__(self, name):
        try:
            return self._data[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __getitem__(self, name):
        return self._data[name]

    def __contains__(self, name):
        return name in self._data

    def get(self, name, default=None):
        return self._data.get(name, default)

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._data)

    def __setattr__(self, name, value):
        raise AttributeError("FrozenConfig is immutable")

    def __repr__(self):
        return f"FrozenConfig({dict(self._data)!r})"


class ConfigurableMixin:
    """Base for objects whose constructor kwargs define a serializable config.

    Subclasses call ``self._register_config(locals())`` in ``__init__``; keys
    in ``ignore_for_config`` (run-time choices such as the device) are
    dropped. ``config`` is a property, so an ``nn.Module`` subclass keeps it
    out of its parameters and state dict.
    """

    config_name: str = "config.json"
    ignore_for_config = ("dtype", "device")

    def _register_config(self, values: Dict[str, Any]) -> None:
        cfg = {
            k: v
            for k, v in values.items()
            if k not in ("self", "__class__") and k not in self.ignore_for_config
        }
        object.__setattr__(self, "_internal_config", FrozenConfig(cfg))

    @property
    def config(self) -> FrozenConfig:
        return self._internal_config

    def save_config(self, save_directory: str) -> None:
        os.makedirs(save_directory, exist_ok=True)
        payload = {
            "_class_name": self._diffusers_class_name(),
            "_diffusers_version": "0.21.4",
        }
        payload.update(_jsonify(self.config.to_dict()))
        path = os.path.join(save_directory, self.config_name)
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)

    @classmethod
    def load_config(
        cls, pretrained_path: str, subfolder: Optional[str] = None
    ) -> Dict[str, Any]:
        directory = (
            os.path.join(pretrained_path, subfolder) if subfolder else pretrained_path
        )
        with open(os.path.join(directory, cls.config_name)) as f:
            config = json.load(f)
        config.pop("_class_name", None)
        config.pop("_diffusers_version", None)
        return config

    @classmethod
    def from_config(cls, config: Dict[str, Any], **overrides):
        """Build from a config dict, dropping keys the constructor does not
        take (diffusers and transformers files carry extra ones)."""
        config = dict(config)
        config.update(overrides)
        sig = inspect.signature(cls.__init__)
        accepted = {
            k: v for k, v in config.items() if k in sig.parameters and k != "self"
        }
        return cls(**accepted)

    def _diffusers_class_name(self) -> str:
        return type(self).__name__


def _jsonify(obj):
    """Convert config values to JSON-safe types."""
    if isinstance(obj, dict):
        return {k: _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    if hasattr(obj, "tolist"):  # numpy arrays and scalars, torch tensors
        return obj.tolist()
    return obj
