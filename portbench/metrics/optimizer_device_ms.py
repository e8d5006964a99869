"""``optimizer_device_ms``: device ms a step of the kernels launched inside
the optimizer spans (``portbench/spans.py``)."""

from portbench.trace.view import OPTIMIZER


def read(view):
    spans = view.spans_named(OPTIMIZER)
    events = view.launched_within(spans) if spans else []
    if not events:
        return None
    return view.device_ms_per_step(events)
