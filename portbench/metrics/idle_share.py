"""``idle_share``: the share of the traced steps' window in which no device
event ran, in %."""


def read(view):
    window = view.window_s()
    return 100.0 * (1.0 - view.busy_s() / window) if window > 0 else None
