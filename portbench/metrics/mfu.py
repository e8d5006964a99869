"""``mfu``: the model FLOPs of the window's images (``portbench/flops.py``:
trained models at three forward passes, frozen ones at one, no recompute)
over the window's seconds, as a share of the card's peak for the cell's
dtype, in %. Read from the window, not from the traced steps."""


def read(view):
    if not view.window or not view.window["seconds"] or not view.window["flops"]:
        return None
    return 100.0 * view.window["flops"] / view.window["seconds"] / view.peak_flops
