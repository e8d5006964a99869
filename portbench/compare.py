"""The numbers that decide ``correct``, each from one reading of the program
and one of the reference over the same checked steps:

- ``loss_gap``: the largest ``|loss - loss_ref| / |loss_ref|`` over the
  checked steps;
- ``grad_gap``: over the trained leaves, the largest gap between the norm
  of the program's first gradient, as its optimizer state holds it after
  one step (the Lion momentum, ``(1 - b2) g``), and the reference's;
- ``change_gap``: over the leaves kept (below), the largest gap between the
  norms of the parameters' change over the checked steps;
- ``ema_gap``: over the EMA's leaves, the largest gap between the norms of
  the EMA's change over the checked steps (each EMA starts from weights
  of its own, so that it moves towards the parameters).

A leaf's gap is ``|norm - norm_ref|`` over the larger of ``norm_ref`` and
the median leaf's ``norm_ref``, so that leaves whose gradient is all but
zero weigh as the median leaf does. ``change_gap`` leaves out the leaves
whose reference gradient is under a thousandth of the median leaf's: they
move by round-off alone.
"""

import statistics
from typing import Dict, List, Optional, Tuple

NOUGHT = 1e-3


def _flat(readings: Dict[str, Dict[str, float]]) -> Dict[str, float]:
    return {f"{model}/{name}": v for model, named in readings.items() for name, v in named.items()}


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float], keep: Optional[set] = None) -> Tuple[float, str]:
    names = [n for n in ref if keep is None or n in keep]
    if not names:
        return 0.0, ""
    median = statistics.median(ref[n] for n in names)
    worst, leaf = 0.0, ""
    for n in names:
        denom = max(ref[n], median)
        gap = abs(prog[n] - ref[n]) / denom if denom > 0 else (0.0 if prog[n] == 0 else float("inf"))
        if gap > worst or not leaf:
            worst, leaf = gap, n
    return worst, leaf


def numbers(prog: Dict, ref: Dict) -> Dict[str, object]:
    """``prog`` and ``ref``: ``{"losses": [...], "grad_norms": {model:
    {leaf: norm}}, "change_norms": {model: {leaf: norm}}, "ema_change_norms":
    {model: {leaf: norm}}}``."""
    losses: List[float] = prog["losses"]
    ref_losses: List[float] = ref["losses"]
    loss_gap = max(abs(a - b) / abs(b) if b else abs(a - b) for a, b in zip(losses, ref_losses))
    g_prog, g_ref = _flat(prog["grad_norms"]), _flat(ref["grad_norms"])
    grad_gap, grad_leaf = worst_leaf(g_prog, g_ref)
    median = statistics.median(g_ref.values())
    keep = {n for n, v in g_ref.items() if v >= NOUGHT * median}
    change_gap, change_leaf = worst_leaf(_flat(prog["change_norms"]), _flat(ref["change_norms"]), keep)
    ema_ref = _flat(ref["ema_change_norms"])
    ema_gap, ema_leaf = worst_leaf(_flat(prog["ema_change_norms"]), ema_ref)
    return {
        "loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap, "ema_gap": ema_gap,
        "grad_leaf": grad_leaf, "change_leaf": change_leaf, "ema_leaf": ema_leaf,
        "leaves_kept": len(keep), "leaves": len(g_ref), "ema_leaves": len(ema_ref),
    }


def verdict(nums: Dict[str, object], limits: Dict[str, float]) -> Tuple[bool, List[List[object]]]:
    """(every number within its limit, ``[[name, number, limit], ...]``)."""
    rows = [[name, nums[name], limit] for name, limit in limits.items()]
    return all(value <= limit for _, value, limit in rows), rows
