"""The port's DDPM scheduler against the JAX package's, on the CPU in f32.

As in ``tests/test_torch_port_schedulers.py``, the step is run on the JAX
package's own tables, so it compares the step's arithmetic alone, and it is
held to that file's bound: XLA:CPU evaluates ``x ** 0.5`` with a pow that is
1 ulp off the correctly rounded sqrt (which torch uses) on ~1% of inputs,
and the step's coefficients are such square roots: 2e-6 absolute plus 4
ulps relative. ``add_noise`` and ``get_velocity`` are held to 4 ulps. The
variance noise of a step is drawn by the JAX package from its key; the test
draws it the same way and hands it to the port (``noise=``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_diffusion_training_tpu.diffusion import DDPMScheduler as JaxDDPM
from stable_diffusion_training_tpu.train.train_step import compute_snrs as jax_compute_snrs
from stable_diffusion_training_tpu_torch.diffusion import CommonSchedulerState, DDPMScheduler, compute_snrs

SD_BETAS = dict(beta_start=0.00085, beta_end=0.012, num_train_timesteps=1000)
EPS = np.finfo(np.float32).eps
STEP_ATOL, STEP_RTOL = 2e-6, 4 * EPS
VARIANCE_TYPES = ["fixed_small", "fixed_small_log", "fixed_large", "fixed_large_log", "learned_range"]


def _pair(**kw):
    return JaxDDPM(**SD_BETAS, **kw), DDPMScheduler(**SD_BETAS, **kw)


def _state_from_jax(sched, jax_state):
    common = CommonSchedulerState(
        *(torch.tensor(np.asarray(x)) for x in (
            jax_state.common.alphas, jax_state.common.betas, jax_state.common.alphas_cumprod
        ))
    )
    return sched.create_state(common)


def test_zero_snr_terminal_alphas_cumprod_is_zero():
    _, sched = _pair(beta_schedule="zero_snr_scaled_linear", prediction_type="v_prediction")
    state = sched.create_state()
    assert float(state.common.alphas_cumprod[-1]) == 0.0
    assert bool(torch.isfinite(compute_snrs(state.common.alphas_cumprod)[0]))
    assert float(compute_snrs(state.common.alphas_cumprod)[-1]) == 0.0


def test_timesteps_match_jax():
    jax_sched, sched = _pair(beta_schedule="scaled_linear")
    np.testing.assert_array_equal(
        sched.create_state().timesteps.numpy(), np.asarray(jax_sched.create_state().timesteps)
    )
    j = jax_sched.set_timesteps(jax_sched.create_state(), 50)
    t = sched.set_timesteps(sched.create_state(), 50)
    np.testing.assert_array_equal(t.timesteps.numpy(), np.asarray(j.timesteps))


@pytest.mark.parametrize("schedule", ["scaled_linear", "zero_snr_scaled_linear"])
def test_add_noise_velocity_and_snr_match_jax(schedule):
    jax_sched, sched = _pair(beta_schedule=schedule, prediction_type="v_prediction")
    j_state = jax_sched.create_state()
    t_state = _state_from_jax(sched, j_state)
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((4, 4, 8, 8)).astype(np.float32)
    noise = rng.standard_normal((4, 4, 8, 8)).astype(np.float32)
    ts = np.array([0, 321, 998, 999], dtype=np.int32)
    for jax_fn, fn in ((jax_sched.add_noise, sched.add_noise), (jax_sched.get_velocity, sched.get_velocity)):
        expected = jax_fn(j_state, jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(ts))
        got = fn(t_state, torch.tensor(x0), torch.tensor(noise), torch.tensor(ts))
        np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=4 * EPS, atol=4 * EPS)
    np.testing.assert_array_equal(
        compute_snrs(t_state.common.alphas_cumprod).numpy(),
        np.asarray(jax_compute_snrs(j_state.common.alphas_cumprod)),
    )


@pytest.mark.parametrize("variance_type", VARIANCE_TYPES)
@pytest.mark.parametrize("prediction_type", ["epsilon", "sample", "v_prediction"])
def test_step_matches_jax(prediction_type, variance_type):
    kw = dict(beta_schedule="scaled_linear", prediction_type=prediction_type,
              variance_type=variance_type)
    jax_sched, sched = _pair(**kw)
    j_state = jax_sched.create_state()
    t_state = _state_from_jax(sched, j_state)
    rng = np.random.default_rng(1)
    # learned_range: the predicted variance rides along in the channels,
    # which both packages split into sample.shape[1] sections (2 channels)
    c = 2 if variance_type == "learned_range" else 4
    sample = rng.standard_normal((2, c, 8, 8)).astype(np.float32)
    out_c = 2 * c if variance_type == "learned_range" else c
    model_output = rng.standard_normal((2, out_c, 8, 8)).astype(np.float32) * 0.5
    key = jax.random.PRNGKey(5)
    for t in (999, 500, 1, 0):
        expected = jax_sched.step(j_state, jnp.asarray(model_output), t, jnp.asarray(sample), key=key).prev_sample
        noise = jax.random.normal(jax.random.split(key, num=1)[0], shape=sample.shape)
        got = sched.step(
            t_state, torch.tensor(model_output), t, torch.tensor(sample), noise=torch.tensor(np.asarray(noise))
        ).prev_sample
        np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=STEP_RTOL, atol=STEP_ATOL)


def test_step_draws_from_a_generator():
    _, sched = _pair(beta_schedule="scaled_linear")
    state = sched.create_state()
    x = torch.zeros(1, 4, 4, 4)
    a = sched.step(state, x, 10, x, generator=torch.Generator().manual_seed(0)).prev_sample
    b = sched.step(state, x, 10, x, generator=torch.Generator().manual_seed(0)).prev_sample
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert float(a.abs().sum()) > 0
    assert float(sched.step(state, x, 0, x).prev_sample.abs().sum()) == 0.0  # no noise at t == 0


def test_config_round_trips_through_the_jax_packages_file(tmp_path):
    jax_sched = JaxDDPM(**SD_BETAS, beta_schedule="zero_snr_scaled_linear",
                        prediction_type="v_prediction", variance_type="fixed_small")
    jax_sched.save_config(str(tmp_path / "scheduler"))
    sched, state = DDPMScheduler.from_pretrained(str(tmp_path), subfolder="scheduler")
    for key in ("beta_schedule", "prediction_type", "variance_type", "clip_sample"):
        assert sched.config[key] == jax_sched.config[key]
    assert float(state.common.alphas_cumprod[-1]) == 0.0
