"""The port's train step against the JAX package's on a tiny SD1.5-shaped
UNet whose 160-channel level has 2 heads of 80, every attention on the flash
route, on the CPU in f32. The state crossing, the batch, JAX's draws and the
bounds are ``tests/test_torch_port_train_step.py``'s (its docstring says
why each bound)."""

import jax
import jax.numpy as jnp
import torch

from stable_diffusion_training_tpu.train import (
    TrainingConfig as JaxTrainingConfig,
    on_device_model_training_state as jax_training_state,
)
from stable_diffusion_training_tpu_torch.train import TrainingConfig, on_device_model_training_state, train_step
from test_torch_port_train_step import (  # noqa: F401 (jax_step: the module fixture)
    CASES, RES, STEP_OPTIONS, _batch, _config, _jax_draws, _load_jax_state, assert_step_matches_jax, jax_step,
)
from torch_threads import _one_thread  # noqa: F401 (the fixture)

# A tiny SD1.5-shaped UNet (convolution projections, one head count at every
# level as SD1.5's 8) whose 160-channel level has 2 heads of 80, as SD1.5's
# 640-channel level has 8 heads of 80; its mid block too. Test-local: both
# packages' MODEL_FAMILIES get it for the test alone.
TINY_SD15_D80_UNET = dict(
    sample_size=8, in_channels=4, out_channels=4,
    down_block_types=("CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
    up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D"),
    block_out_channels=(32, 160), layers_per_block=1, attention_head_dim=2, cross_attention_dim=32,
)


def test_train_step_with_heads_of_80_matches_jax(jax_step, monkeypatch):  # noqa: F811
    """The step on ``TINY_SD15_D80_UNET`` with every attention on the flash
    route (``attention_backend="flash"``): the JAX step runs its Pallas
    kernels in interpret mode, the port's ``FlashAttention`` takes the plain
    versions on CPU tensors (on the card, the 160-channel level's backward
    is the wide-head fused kernel). Bounds as in the module docstring."""
    from stable_diffusion_training_tpu.models import configs as jax_configs
    from stable_diffusion_training_tpu_torch.models import configs

    for module in (configs, jax_configs):
        family = dict(module.MODEL_FAMILIES["tiny"], unet=TINY_SD15_D80_UNET)
        monkeypatch.setitem(module.MODEL_FAMILIES, "tiny_sd15_d80", family)
    overrides = dict(model_path="tiny_sd15_d80", model_family="tiny_sd15_d80", attention_backend="flash")
    jax_states = jax_training_state(_config(JaxTrainingConfig, "v-zero-snr", **overrides))
    port_states = on_device_model_training_state(_config(TrainingConfig, "v-zero-snr", **overrides), device="cpu")
    assert {(m.attn1.heads, m.attn1.dim_head) for m in port_states[0].model.modules()
            if hasattr(m, "attn1")} == {(2, 16), (2, 80)}
    _load_jax_state(port_states, jax_states)
    before = {
        "unet": {k: v.detach().clone() for k, v in port_states[0].params.items()},
        "text_encoder": {k: v.detach().clone() for k, v in port_states[1].params.items()},
    }
    batch = _batch()
    rng = jax.random.PRNGKey(7)
    options = {k: CASES["v-zero-snr"][k] for k in STEP_OPTIONS}
    j_out = jax_step(
        *jax_states[:4], {k: jnp.asarray(v) for k, v in batch.items()}, rng,
        jax_states[4], jax_states[5], strip_bos_eos_token=True, ema_rate=0.999, **options,
    )
    draws = _jax_draws(rng, (RES // 2, RES // 2))
    out = train_step(
        *port_states[:4], {k: torch.tensor(v) for k, v in batch.items()}, None,
        port_states[4], port_states[5], strip_bos_eos_token=True, ema_rate=0.999,
        draws=draws, **options,
    )
    # noise_code 15, as the SD2.1 and SDXL step tests take it: 9 of 5.1 M
    # codes sit more than one apart, the largest at |code| 12 (-9 against
    # -12), in blocks whose scales agree to 1e-6 (momentum at its rounding
    # noise); the same step on the plain attention route does the same
    assert_step_matches_jax(out, j_out, before, noise_code=15)
