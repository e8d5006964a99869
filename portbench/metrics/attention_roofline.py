"""``attention_roofline``: the least time the card could take for the
attention calls' work (counted from their shapes, ``portbench/trace/view.py``:
forward and backward, nothing twice for recompute) over the device time of
every kernel that those calls and their backward launched, in %."""

def read(view):
    events, works = view.attention()
    device_ms = sum(e["dur"] for e in events) / 1e3
    if not events or not works or device_ms <= 0:
        return None
    bound = sum(w.bound()[0] for pair in works for w in pair if w is not None)
    return 100.0 * bound / device_ms
