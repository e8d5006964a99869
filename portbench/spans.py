"""The benchmark's spans around the port's layers, installed for the
traced steps only (``torch.profiler.record_function``, from the
benchmark's own files):

- ``portbench.attention b= sq= sk= h= d= dtype= grad=`` around each call
  into the attention dispatch (``models.attention.attention`` and
  ``models.vae.attention``); a call made while the autograd engine runs a
  backward (a recompute under gradient checkpointing) is named
  ``portbench.attention.recompute``;
- ``portbench.optimizer.apply_gradients`` around
  ``train.states.TrainState.apply_gradients`` (clip, 8-bit Lion, decay,
  learning rate, apply), and ``portbench.optimizer.ema`` around
  ``train.train_step.ema_update_``.
"""

import contextlib
import functools
import importlib

import torch
from torch.profiler import record_function

PORT = "stable_diffusion_training_tpu_torch"


def _in_backward() -> bool:
    return torch._C._current_graph_task_id() != -1


def _attention(fn):
    @functools.wraps(fn)
    def wrapped(query, key, value, *args, **kwargs):
        b, sq, h, d = query.shape
        kind = "portbench.attention.recompute" if _in_backward() else "portbench.attention"
        grad = int(torch.is_grad_enabled() and any(t.requires_grad for t in (query, key, value)))
        dtype = str(query.dtype).replace("torch.", "")
        with record_function(f"{kind} b={b} sq={sq} sk={key.shape[1]} h={h} d={d} dtype={dtype} grad={grad}"):
            return fn(query, key, value, *args, **kwargs)

    return wrapped


def _named(fn, name):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)

    return wrapped


@contextlib.contextmanager
def installed():
    """The spans in place, and the port's own functions back afterwards."""
    attention = importlib.import_module(f"{PORT}.models.attention")
    vae = importlib.import_module(f"{PORT}.models.vae")
    step = importlib.import_module(f"{PORT}.train.train_step")
    states = importlib.import_module(f"{PORT}.train.states")
    targets = [
        (attention, "attention", _attention),
        (vae, "attention", _attention),
        (step, "ema_update_", lambda fn: _named(fn, "portbench.optimizer.ema")),
        (states.TrainState, "apply_gradients", lambda fn: _named(fn, "portbench.optimizer.apply_gradients")),
    ]
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in targets]
    try:
        for owner, name, wrap in targets:
            setattr(owner, name, wrap(getattr(owner, name)))
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
