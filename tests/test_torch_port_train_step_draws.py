"""The port's train step on the CPU without JAX's draws: the draws it makes
from a ``torch.Generator`` (same shapes, the same generator state the same
step), and the side paths that once raised taking a step with a finite loss
(each is held to the JAX step in ``tests/test_torch_port_train_side_paths*.py``).
The config and batch are ``tests/test_torch_port_train_step.py``'s."""

import numpy as np
import pytest
import torch

from stable_diffusion_training_tpu_torch.train import TrainingConfig, on_device_model_training_state, train_step
from test_torch_port_train_step import BATCH, _batch, _config
from torch_threads import _one_thread  # noqa: F401 (the fixture)


def test_draw_seam_and_generator_draws_agree_in_shape():
    """Without ``draws`` the step makes its own from a torch.Generator:
    same shapes, and the same generator state gives the same step."""
    cfg = _config(TrainingConfig, "v-zero-snr")
    batch = {k: torch.tensor(v) for k, v in _batch().items()}
    losses = []
    for _ in range(2):
        states = on_device_model_training_state(cfg, device="cpu")
        out = train_step(*states[:4], batch, torch.Generator().manual_seed(3), states[4], states[5],
                         ema_rate=0.999)
        losses.append(float(out[4]["loss"]))
    assert np.isfinite(losses[0]) and losses[0] == losses[1]


@pytest.mark.parametrize(
    "kwargs,batch_extra",
    [
        (dict(grad_accumulation_steps=2), {}),
        (dict(train_text_encoder=False), {}),
        (dict(vae_encode_chunk=1), {}),
        ({}, {"latent_moments": torch.zeros(BATCH, 8, 32, 32)}),
        ({}, {"encoder_hidden_states": torch.zeros(BATCH, 227, 32)}),
    ],
    ids=["grad-accumulation", "frozen-text-encoder", "vae-encode-chunk", "latent-cache", "cached-context"],
)
def test_side_paths_raise(kwargs, batch_extra):
    """The side paths that raised NotImplementedError before they were
    ported now take a step with a finite loss; each is held to the JAX step
    in ``tests/test_torch_port_train_side_paths.py``."""
    states = on_device_model_training_state(_config(TrainingConfig, "v-zero-snr"), device="cpu")
    batch = {k: torch.tensor(v) for k, v in _batch().items()} | batch_extra
    out = train_step(*states[:4], batch, torch.Generator(), states[4], states[5], **kwargs)
    assert np.isfinite(float(out[4]["loss"]))
