"""``optimizer_host_ms``: host ms a step inside the benchmark's spans around
``TrainState.apply_gradients`` and ``ema_update_`` (``portbench/spans.py``)."""

from portbench.trace.view import OPTIMIZER


def read(view):
    spans = view.spans_named(OPTIMIZER)
    if not spans:
        return None
    return sum(s["dur"] for s in spans) / 1e3 / view.steps
