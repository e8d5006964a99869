"""Configuration records, device selection and the text-context window
math for the port."""

from .configuration import ConfigurableMixin, FrozenConfig
from .context import concat_context_windows, context_token_count
from .device import resolve_device

__all__ = [
    "ConfigurableMixin",
    "FrozenConfig",
    "concat_context_windows",
    "context_token_count",
    "resolve_device",
]
