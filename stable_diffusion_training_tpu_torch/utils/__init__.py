"""Configuration records, device selection, the text-context window math,
JSON state IO, the metrics writers, timing and the profiler trace for the
port."""

from .configuration import ConfigurableMixin, FrozenConfig
from .context import concat_context_windows, context_token_count
from .device import resolve_device
from .profiling import StepTimer, estimate_unet_flops, profiler_trace
from .timing import TimingContextManager

__all__ = [
    "ConfigurableMixin",
    "FrozenConfig",
    "StepTimer",
    "TimingContextManager",
    "concat_context_windows",
    "context_token_count",
    "estimate_unet_flops",
    "profiler_trace",
    "resolve_device",
]
