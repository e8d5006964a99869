"""The port's own counterparts of the optax pieces the JAX train step chains.

A gradient transformation is a pair ``init(params) -> state`` and
``update(updates, state, params) -> (updates, state)`` over *trees*: dicts
from parameter names to tensors (``dict(module.named_parameters())``), in
the module's order. ``chain``, ``clip_by_global_norm``,
``add_decayed_weights``, ``scale_by_learning_rate``, the schedules that
``train.states.build_lr_schedule`` picks from, and ``apply_updates_`` follow
optax 0.2.6 op for op.

Dtypes follow JAX's: a Python scalar beside a tensor is converted to the
tensor's dtype first (JAX's weak typing; ``weak``), so a bf16 leaf times
0.07 is a bf16 product of bf16(0.07), not torch's f32 product rounded once.
"""

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.distributed

Tree = Dict[str, torch.Tensor]
Schedule = Callable[[int], float]


class GradientTransformation(NamedTuple):
    init: Callable[[Tree], Any]
    update: Callable[..., Tuple[Tree, Any]]


def weak(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar as JAX's weak typing treats it beside ``like``: a
    0-dim tensor in ``like``'s dtype. It stays on the CPU, where a CUDA op
    reads it as a scalar; built on the card it would cost a host-to-device
    copy per leaf and per op."""
    return torch.tensor(x, dtype=like.dtype)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def global_norm(updates: Tree, plan=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, summed leaf by leaf
    in the leaves' dtype as optax's Python ``sum`` does. With ``plan`` (a
    ``parallel.sharding.ShardPlan``) the leaves it splits (``plan.rows``:
    every leaf under FSDP) are the ranks' disjoint parts: each one's local
    sum of squares is summed over each group of its shard (``groups``: the
    fsdp axis's, then, for a leaf TP splits too, the model_parallel
    axis's), the partials of a dtype and group stacked into one
    ``all_reduce``, before the sum over leaves; the other leaves (whole on
    every rank, as under TP) count once."""
    squares = [(x * x).sum() for x in updates.values()]
    if plan is not None:
        by_group: Dict[tuple, list] = {}  # (dtype, group) -> leaves, in the order the groups come
        for i, (name, sq) in enumerate(zip(updates, squares)):
            shard = plan.rows.get(name)
            for group in () if shard is None else shard.groups:
                by_group.setdefault((sq.dtype, group), []).append(i)
        for (_, group), indices in by_group.items():
            stacked = torch.stack([squares[i] for i in indices])
            torch.distributed.all_reduce(stacked, group=group)
            for i, sq in zip(indices, stacked.unbind()):
                squares[i] = sq
    return torch.sqrt(sum(squares))


def clip_by_global_norm(max_norm: float, plan=None) -> GradientTransformation:
    """Leaves unchanged when the global norm is below ``max_norm``, else
    ``(t / norm) * max_norm``. Decided on the device (no host sync).
    ``plan``: the ``ShardPlan`` of the leaves' slices (``global_norm``)."""

    def update(updates, state, params=None):
        g_norm = global_norm(updates, plan)
        trigger = g_norm < max_norm
        return {
            name: torch.where(trigger, t, (t / g_norm.to(t.dtype)) * max_norm)
            for name, t in updates.items()
        }, state

    return GradientTransformation(lambda params: (), update)


def set_to_zero() -> GradientTransformation:
    """``optax.set_to_zero``: every update is zero, and there is no state."""

    def update(updates, state, params=None):
        return {name: torch.zeros_like(u) for name, u in updates.items()}, state

    return GradientTransformation(lambda params: (), update)


def add_decayed_weights(
    weight_decay: float, mask: Optional[Dict[str, bool]] = None
) -> GradientTransformation:
    """``u + weight_decay * p`` on the leaves ``mask`` selects (all when it
    is None); the others pass through."""

    def update(updates, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs the params")
        return {
            name: u + weak(weight_decay, params[name]) * params[name]
            if mask is None or mask[name] else u
            for name, u in updates.items()
        }, state

    return GradientTransformation(lambda params: (), update)


def scale_by_learning_rate(learning_rate: Union[float, Schedule]) -> GradientTransformation:
    """Multiply by ``-learning_rate(count)``, the step size taken in each
    leaf's dtype; ``count`` starts at 0 and counts updates."""
    schedule = learning_rate if callable(learning_rate) else constant_schedule(learning_rate)

    def update(updates, count, params=None):
        step_size = -1 * schedule(count)
        return {name: weak(step_size, u) * u for name, u in updates.items()}, count + 1

    return GradientTransformation(lambda params: 0, update)


@torch.no_grad()
def apply_updates_(params: Tree, updates: Tree) -> None:
    """``p + u`` cast once to the param's dtype, written into the param."""
    for name, p in params.items():
        p.copy_(p + updates[name])


# --- schedules (optax.constant_schedule, linear_schedule,
# warmup_cosine_decay_schedule), evaluated on the host in float32 --------------


def _f32(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float32))


def constant_schedule(value: float) -> Schedule:
    return lambda count: value


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    def schedule(count):
        frac = 1 - min(max(count, 0), transition_steps) / transition_steps
        return _f32((init_value - end_value) * frac + end_value)

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    def schedule(count):
        frac = min(count, decay_steps) / decay_steps
        cosine = 0.5 * (1 + math.cos(math.pi * frac))
        return _f32(init_value * ((1 - alpha) * cosine + alpha))

    return schedule


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int, end_value: float = 0.0
) -> Schedule:
    """Linear warm-up to ``peak_value`` over ``warmup_steps``, then cosine
    decay to ``end_value`` at ``decay_steps`` (counted from 0, warm-up
    included), as optax joins them."""
    alpha = 0.0 if peak_value == 0 else end_value / peak_value
    warmup = linear_schedule(init_value, peak_value, warmup_steps) if warmup_steps else None
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)

    def schedule(count):
        if warmup is not None and count < warmup_steps:
            return warmup(count)
        return decay(count - warmup_steps)

    return schedule
