"""Configuration records and device selection for the port."""

from .configuration import ConfigurableMixin, FrozenConfig
from .device import resolve_device

__all__ = ["ConfigurableMixin", "FrozenConfig", "resolve_device"]
