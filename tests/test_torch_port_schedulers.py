"""The port's DDIM scheduler against the JAX package's, on the CPU in f32.

Inputs are made with numpy from a seed and handed to both sides. What is
bitwise and what is held to a bound, and why:

- timesteps (``set_timesteps``, ``steps_offset``): integers, bitwise;
- the terminal ``alphas_cumprod`` of the zero-SNR schedule: exactly 0.0 on
  both sides;
- schedule tables: XLA orders the same f32 arithmetic differently. Its CPU
  ``cumprod`` is a blocked tree of partial products where torch multiplies
  in sequence; any two orders of 1000 f32 products agree to 1000 * eps
  relative (1.2e-4; about 20 ulps are seen). Its ``linspace`` multiplies by
  the reciprocal of (n - 1) where torch divides: 1 ulp, 3 after squaring.
  The zero-SNR rescale takes ``1 - ratio`` of cumprods, so its betas carry
  the cumprod's relative error as an absolute one.
- the DDIM step, run on identical tables: XLA:CPU evaluates ``x ** 0.5`` with
  a pow approximation that misses the correctly rounded sqrt (which torch
  uses) by 1 ulp on about 1% of inputs. The step's coefficients are square
  roots up to 1/sqrt(abar_t) ~ 25, and its two terms cancel, so an ulp in a
  coefficient moves the result by up to ~1e-6 absolute at |x| ~ 4: bound
  2e-6 absolute plus 4 ulps relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_diffusion_training_tpu.diffusion import DDIMScheduler as JaxDDIM
from stable_diffusion_training_tpu_torch.diffusion import (
    CommonSchedulerState,
    DDIMScheduler,
    add_noise,
    get_velocity,
)

SCHEDULES = ["linear", "scaled_linear", "zero_snr_scaled_linear", "squaredcos_cap_v2"]
SD_BETAS = dict(beta_start=0.00085, beta_end=0.012, num_train_timesteps=1000)
EPS = np.finfo(np.float32).eps
STEP_ATOL, STEP_RTOL = 2e-6, 4 * EPS


def _pair(**kw):
    return JaxDDIM(**SD_BETAS, **kw), DDIMScheduler(**SD_BETAS, **kw)


def _state_from_jax(sched, jax_state):
    """The port's state on the JAX package's own tables, so a step test
    compares the step's arithmetic alone."""
    common = CommonSchedulerState(
        *(torch.tensor(np.asarray(x)) for x in (
            jax_state.common.alphas, jax_state.common.betas, jax_state.common.alphas_cumprod
        ))
    )
    state = sched.create_state(common)
    return state.replace(final_alpha_cumprod=torch.tensor(np.asarray(jax_state.final_alpha_cumprod)))


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_schedule_tables_match_jax(schedule):
    jax_sched, sched = _pair(beta_schedule=schedule)
    j = jax_sched.create_state().common
    t = sched.create_state().common
    ac_j, ac_t = np.asarray(j.alphas_cumprod), t.alphas_cumprod.numpy()
    np.testing.assert_allclose(ac_t, ac_j, rtol=1000 * EPS, atol=0)
    betas_j, betas_t = np.asarray(j.betas), t.betas.numpy()
    if schedule == "zero_snr_scaled_linear":
        np.testing.assert_allclose(betas_t, betas_j, rtol=0, atol=2 * 1000 * EPS)
        assert ac_t[-1] == 0.0 and ac_j[-1] == 0.0
    else:
        np.testing.assert_allclose(betas_t, betas_j, rtol=4 * EPS, atol=0)
    np.testing.assert_array_equal(t.alphas.numpy(), 1.0 - betas_t)


@pytest.mark.parametrize("steps,offset", [(50, 0), (50, 1), (7, 1), (1000, 0)])
def test_set_timesteps_bitwise(steps, offset):
    jax_sched, sched = _pair(beta_schedule="scaled_linear", steps_offset=offset)
    j = jax_sched.set_timesteps(jax_sched.create_state(), steps)
    t = sched.set_timesteps(sched.create_state(), steps)
    assert t.timesteps.dtype == torch.int32
    np.testing.assert_array_equal(t.timesteps.numpy(), np.asarray(j.timesteps))
    np.testing.assert_array_equal(
        sched.create_state().timesteps.numpy(), np.asarray(jax_sched.create_state().timesteps)
    )


@pytest.mark.parametrize("eta", [0.0, 0.5])
@pytest.mark.parametrize("prediction_type", ["epsilon", "sample", "v_prediction"])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_ddim_step_matches_jax(schedule, prediction_type, eta):
    kw = dict(beta_schedule=schedule, prediction_type=prediction_type,
              set_alpha_to_one=False, steps_offset=1)
    jax_sched, sched = _pair(**kw)
    j_state = jax_sched.set_timesteps(jax_sched.create_state(), 10)
    t_state = sched.set_timesteps(_state_from_jax(sched, j_state), 10)
    rng = np.random.default_rng(0)
    sample = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    model_output = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    for t in np.asarray(j_state.timesteps):
        expected = jax_sched.step(
            j_state, jnp.asarray(model_output), int(t), jnp.asarray(sample), eta=eta
        ).prev_sample
        got = sched.step(
            t_state, torch.tensor(model_output), int(t), torch.tensor(sample), eta=eta
        ).prev_sample
        np.testing.assert_allclose(
            got.numpy(), np.asarray(expected), rtol=STEP_RTOL, atol=STEP_ATOL
        )


def test_ddim_step_on_own_tables_matches_jax():
    """The port end to end (its own tables): the cumprod bound above carries
    into the step as a relative error of the coefficients."""
    kw = dict(beta_schedule="scaled_linear", prediction_type="epsilon")
    jax_sched, sched = _pair(**kw)
    j_state = jax_sched.set_timesteps(jax_sched.create_state(), 25)
    t_state = sched.set_timesteps(sched.create_state(), 25)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    eps = rng.standard_normal((25, 1, 4, 8, 8)).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.tensor(x)
    for i, t in enumerate(np.asarray(j_state.timesteps)):
        xj = jax_sched.step(j_state, jnp.asarray(eps[i]), int(t), xj).prev_sample
        xt = sched.step(t_state, torch.tensor(eps[i]), int(t), xt).prev_sample
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-4, atol=1e-5)


def test_step_needs_set_timesteps():
    sched = DDIMScheduler(**SD_BETAS)
    with pytest.raises(ValueError, match="set_timesteps"):
        sched.step(sched.create_state(), torch.zeros(1), 10, torch.zeros(1))


@pytest.mark.parametrize("schedule", ["scaled_linear", "zero_snr_scaled_linear"])
def test_add_noise_and_velocity_match_jax(schedule):
    jax_sched, sched = _pair(beta_schedule=schedule)
    j_state = jax_sched.create_state()
    t_state = _state_from_jax(sched, j_state)
    rng = np.random.default_rng(2)
    x0 = rng.standard_normal((3, 4, 8, 8)).astype(np.float32)
    noise = rng.standard_normal((3, 4, 8, 8)).astype(np.float32)
    ts = np.array([0, 500, 999], dtype=np.int32)
    for jax_fn, fn in ((jax_sched.add_noise, add_noise), (jax_sched.get_velocity, get_velocity)):
        expected = jax_fn(j_state, jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(ts))
        got = fn(t_state.common, torch.tensor(x0), torch.tensor(noise), torch.tensor(ts))
        np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=4 * EPS, atol=4 * EPS)


def test_scheduler_config_from_jax_checkpoint(tmp_path):
    jax_sched = JaxDDIM(**SD_BETAS, beta_schedule="zero_snr_scaled_linear",
                        prediction_type="v_prediction", steps_offset=1)
    jax_sched.save_config(str(tmp_path / "scheduler"))
    sched, state = DDIMScheduler.from_pretrained(str(tmp_path), subfolder="scheduler")
    for key in ("beta_schedule", "prediction_type", "steps_offset", "set_alpha_to_one"):
        assert sched.config[key] == jax_sched.config[key]
    assert float(state.common.alphas_cumprod[-1]) == 0.0
