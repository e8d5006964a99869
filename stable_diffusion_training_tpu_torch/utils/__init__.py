"""Configuration records, device selection, the text-context window math,
JSON state IO, the metrics writers, timing, the profiler trace and the
profiling tools for the port: the kernel build cache's key and purge
(``hostcache``), a reader of the profiler's Chrome traces
(``kernel_trace``) and each op's work and bound on the card's roofline
(``roofline``)."""

from .configuration import ConfigurableMixin, FrozenConfig
from .context import concat_context_windows, context_token_count
from .device import resolve_device
from .hostcache import host_compiler, prepare_cache_dir, toolchain_fingerprint, toolchain_parts
from .kernel_trace import (
    category_report,
    category_roofline,
    category_table,
    categorize,
    device_busy,
    device_events,
    family_of,
    idle_share,
    kernel_ops,
    load_trace,
    op_durations,
    top_ops,
    traced_window,
)
from .profiling import StepTimer, annotate_launch, estimate_unet_flops, profiler_trace
from .roofline import (
    OpIndex,
    Work,
    attention_bound,
    attention_work,
    launch_label,
    launch_name,
    lion_bytes,
    op_cost,
    op_work,
    parse_launch,
    parse_ops,
    tensor_bytes,
)
from .timing import TimingContextManager

__all__ = [
    "ConfigurableMixin",
    "FrozenConfig",
    "OpIndex",
    "StepTimer",
    "TimingContextManager",
    "Work",
    "annotate_launch",
    "attention_bound",
    "attention_work",
    "categorize",
    "category_report",
    "category_roofline",
    "category_table",
    "concat_context_windows",
    "context_token_count",
    "device_busy",
    "device_events",
    "estimate_unet_flops",
    "family_of",
    "host_compiler",
    "idle_share",
    "kernel_ops",
    "launch_label",
    "launch_name",
    "lion_bytes",
    "load_trace",
    "op_cost",
    "op_durations",
    "op_work",
    "parse_launch",
    "parse_ops",
    "prepare_cache_dir",
    "profiler_trace",
    "resolve_device",
    "tensor_bytes",
    "toolchain_fingerprint",
    "toolchain_parts",
    "top_ops",
    "traced_window",
]
