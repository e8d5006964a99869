"""An SD2.1-shaped train step against the JAX package's, on the CPU in f32:
linear projections in every transformer, per-level head counts that keep
the head dim fixed, the exact-erf gelu text tower. It runs as
``tests/test_torch_port_train_step.py`` runs the ``tiny`` family's step (one
state from the JAX package, JAX's draws injected) and holds the port to
that module's bounds; its own file, so that the test runners can balance
the two."""

import jax
import jax.numpy as jnp
import pytest
import torch

from stable_diffusion_training_tpu.models import configs as jax_configs
from stable_diffusion_training_tpu.train import (
    TrainingConfig as JaxTrainingConfig,
    on_device_model_training_state as jax_training_state,
    train_step as jax_train_step,
)
from stable_diffusion_training_tpu_torch.models import configs
from stable_diffusion_training_tpu_torch.train import (
    TrainingConfig,
    on_device_model_training_state,
    train_step,
)
from test_torch_port_train_step import (
    RES,
    STEP_OPTIONS,
    _batch,
    _config,
    _jax_draws,
    _load_jax_state,
    assert_step_matches_jax,
)
from torch_threads import _one_thread  # noqa: F401 (the fixture)


@pytest.fixture(scope="module")
def jax_step():
    return jax.jit(
        jax_train_step,
        static_argnames=("strip_bos_eos_token", "ema_rate") + STEP_OPTIONS,
    )


# SD2.1's shape at tiny width: linear projections in every transformer,
# per-level head counts that keep the head dim fixed (16 here; SD2.1's 64),
# three levels with attention on two, the exact-erf gelu text tower
TINY_SD21 = dict(
    unet=dict(
        sample_size=32, in_channels=4, out_channels=4,
        down_block_types=("CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D"),
        up_block_types=("UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D"),
        block_out_channels=(32, 64, 64), layers_per_block=1, attention_head_dim=(2, 4, 4),
        cross_attention_dim=32, use_linear_projection=True,
    ),
    vae=configs.TINY_VAE,
    text_encoder=dict(configs.TINY_CLIP, hidden_act="gelu"),
)


def test_sd21_shaped_train_step_matches_jax(jax_step, monkeypatch):
    """One v-prediction, zero-SNR step of an SD2.1-shaped family against
    the JAX step, JAX's draws injected, to the module's bounds."""
    for families in (configs.MODEL_FAMILIES, jax_configs.MODEL_FAMILIES):
        monkeypatch.setitem(families, "tiny_sd21", TINY_SD21)
    family = dict(model_path="tiny_sd21", model_family="tiny_sd21")
    jax_states = jax_training_state(_config(JaxTrainingConfig, "v-zero-snr", **family))
    port_states = on_device_model_training_state(_config(TrainingConfig, "v-zero-snr", **family), device="cpu")
    assert port_states[0].model.config.use_linear_projection
    _load_jax_state(port_states, jax_states)
    before = {
        "unet": {k: v.detach().clone() for k, v in port_states[0].params.items()},
        "text_encoder": {k: v.detach().clone() for k, v in port_states[1].params.items()},
    }
    batch = _batch()
    rng = jax.random.PRNGKey(11)
    j_out = jax_step(
        *jax_states[:4], {k: jnp.asarray(v) for k, v in batch.items()}, rng,
        jax_states[4], jax_states[5], strip_bos_eos_token=True, ema_rate=0.999,
        offset_noise_magnitude=0.0, min_snr_gamma_magnitude=0.0, perturbation_noise_magnitude=0.0,
    )
    out = train_step(
        *port_states[:4], {k: torch.tensor(v) for k, v in batch.items()}, None,
        port_states[4], port_states[5], strip_bos_eos_token=True, ema_rate=0.999,
        draws=_jax_draws(rng, (RES // 2, RES // 2)),
    )
    # noise_code 15, as the SDXL step tests take it: two codes, one each in a
    # 36,864- and a 73,728-code conv kernel, sit two apart at |code| 13, in
    # blocks whose scales agree to 6e-6 (momentum at its rounding noise)
    assert_step_matches_jax(out, j_out, before, noise_code=15)
