"""The port's train step against the JAX package's, on the CPU in f32.

Both sides start from one state: the JAX package builds the ``tiny`` family
(``on_device_model_training_state``) and its params, EMA params and 8-bit
Lion state cross into the port through ``models.hf_io``
(``jax_params_to_state_dict``, ``lion_momentum_from_jax``). One batch made
with numpy from a seed (64x64 pixels, 3 context windows of 77 ids) goes
through the JAX ``train_step`` (jitted, as ``tests/test_train.py`` runs it)
and through the port's, which gets JAX's own random draws (the same
``split`` tree, the VAE eps drawn NHWC and transposed) through its
``draws`` seam.

The step on an SD1.5-shaped UNet with heads of 80 is
``tests/test_torch_port_train_step_heads_of_80.py``; the step's own draws
and its side paths' finite losses are ``tests/test_torch_port_train_step_draws.py``
(each file runs whole on one worker under ``--dist loadfile``). Both import
this module's helpers and bounds.

Tolerances, and why:
- loss: 1e-5 relative. Both sides compute the same f32 forward; convolution
  and matmul sums run in other orders (the models agree to 1e-5 absolute,
  ``tests/test_torch_port_models.py``).
- params and EMA after the step: 2 * lr + 1e-6 absolute, lr = 1e-6 / 7. A
  Lion update is lr * sign(...) plus a decay of 0.07 * lr * p, so one flipped
  sign moves a param by 2 * lr. A sign flips where a grad element is within
  its rounding error of 0: at most 1e-3 of the update signs may differ.
- momentum codes: at most one apart wherever the momentum is above
  (10/127)^5 ~ 3e-6 of its block's absmax (|code| > 10). XLA's f32 pow
  differs from torch's by an ulp on some inputs (and XLA fuses the
  momentum lerp into an FMA under jit), which moves a code by one where
  127 |x|^(1/5) sits at a rounding boundary; the grads' own rounding
  differences do the same. Below that the momentum is a grad at its rounding
  noise, whose sign may differ between the two sides (codes of opposite
  signs for a momentum ~1e-7 of its block's absmax): at most 1e-4 of all
  codes may be more than one apart.
- scales: 1e-2 relative. A scale is 1 / (0.01 max |g|) over its block, so it
  carries the grads' own agreement, which is loosest (~1e-3) for the
  ``time_emb_proj`` kernels, whose grads are sums over every spatial
  position that cancel to a small fraction of their terms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_diffusion_training_tpu.train import (
    TrainingConfig as JaxTrainingConfig,
    on_device_model_training_state as jax_training_state,
    train_step as jax_train_step,
)
from stable_diffusion_training_tpu_torch.models.hf_io import (
    jax_param_paths,
    jax_params_to_state_dict,
    lion_momentum_from_jax,
)
from stable_diffusion_training_tpu_torch.optim import QuantizedMomentum, add_decayed_weights
from stable_diffusion_training_tpu_torch.train import (
    TrainingConfig,
    on_device_model_training_state,
    train_step,
)
from stable_diffusion_training_tpu_torch.train.train_step import ema_update_
from torch_threads import _one_thread  # noqa: F401 (the fixture)

LR = 1e-6 / 7
PARAM_ATOL = 2 * LR + 1e-6
BATCH, RES, CONCAT = 2, 64, 3

CASES = {
    "v-zero-snr": dict(
        beta_scheduler="zero_snr_scaled_linear", prediction_type="v_prediction",
        offset_noise_magnitude=0.0, min_snr_gamma_magnitude=0.0,
        perturbation_noise_magnitude=0.0,
    ),
    "eps-min-snr-offset-perturb": dict(
        beta_scheduler="scaled_linear", prediction_type="epsilon",
        offset_noise_magnitude=0.1, min_snr_gamma_magnitude=5.0,
        perturbation_noise_magnitude=0.1,
    ),
}
STEP_OPTIONS = (
    "offset_noise_magnitude", "min_snr_gamma_magnitude", "perturbation_noise_magnitude",
)


def _config(cls, case, **overrides):
    return cls(**{**dict(
        model_path="tiny", batch_size=BATCH, learning_rate=1e-4, unet_learning_rate=1e-4,
        text_encoder_learning_rate=1e-4, lr_scheduler="constant",
        adam_to_lion_scale_factor=7.0, compilation_cache_path="/tmp/jax_cache_test",
        keep_compiled_fn_in_cache=False, text_encoder_context_window=77,
        context_window_concatenation_count=CONCAT, aot_compile=False,
        strip_bos_eos_token=True, image_area_root=[RES], minimum_axis_length=[RES],
        excluded_layer_pattern_from_weight_decay=["bias", "scale", "embedding"],
        excluded_layer_from_quantization=["bias", "scale", "embedding"],
        quant_block_size=16, quantize_unet_state=True, quantize_text_encoder_state=True,
        accumulate_unet_ema=True, accumulate_text_encoder_ema=True, ema_rate=0.999,
        mixed_precision="float32", model_family="tiny", **CASES[case],
    ), **overrides})


def _batch():
    rng = np.random.default_rng(0)
    return {
        "pixel_values": rng.uniform(-1.0, 1.0, (BATCH, 3, RES, RES)).astype(np.float32),
        "input_ids": rng.integers(0, 1000, (BATCH * CONCAT, 77)).astype(np.int32),
    }


def _jax_draws(rng, latent_hw):
    """The JAX step's draws, made with its own split tree."""
    _, sample_rng, _ = jax.random.split(rng, num=3)
    h, w = latent_hw
    eps = jax.random.normal(sample_rng, (BATCH, h, w, 4), dtype=jnp.float32)
    offset_rng, noise_rng, perturb_rng, t_rng = jax.random.split(key=sample_rng, num=4)
    draws = {
        "latent_eps": np.asarray(eps).transpose(0, 3, 1, 2),
        "noise": np.asarray(jax.random.normal(noise_rng, (BATCH, 4, h, w))),
        "noise_offset": np.asarray(jax.random.normal(offset_rng, (BATCH, 4, 1, 1))),
        "perturb_noise": np.asarray(jax.random.normal(perturb_rng, (BATCH, 4, h, w))),
        "timesteps": np.asarray(jax.random.randint(t_rng, (BATCH,), 0, 1000)),
    }
    return {k: torch.tensor(v) for k, v in draws.items()}


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _load_jax_state(port_states, jax_states, train_text_encoder=True):
    """Params, EMA params and Lion momentum of the JAX states into the port's
    (a frozen text encoder has no Lion state)."""
    unet_state, te_state, unet_ema, te_ema, frozen_vae = port_states[:5]
    j_unet, j_te, j_unet_ema, j_te_ema, j_vae = jax_states[:5]
    for model, params in ((unet_state.model, j_unet.params), (te_state.model, j_te.params),
                          (frozen_vae.call, j_vae.params)):
        model.load_state_dict(jax_params_to_state_dict(_numpy(params)), strict=True)
    for ema, j_ema in ((unet_ema, j_unet_ema), (te_ema, j_te_ema)):
        for name, value in jax_params_to_state_dict(_numpy(j_ema)).items():
            ema[name].copy_(value)
    for state, j_state in ((unet_state, j_unet), (te_state, j_te))[: 1 + int(train_text_encoder)]:
        lion = state.opt_state[1][0]
        mu = lion_momentum_from_jax(_numpy(j_state.opt_state[1][0].mu_quant), state.model, "cpu")
        state.opt_state = (state.opt_state[0], (lion._replace(mu_quant=mu),) + state.opt_state[1][1:])


def assert_step_matches_jax(out, j_out, before, train_text_encoder=True, noise_code=10, noise_leaves=()):
    """The port's step output against the JAX step's, to the bounds in the
    module docstring; ``before`` holds each model's params before the step.
    A frozen text encoder must come out unchanged, with no optimizer state.
    ``noise_code``: the |code| up to which codes may be further than one
    apart (the rounding-noise level of the momentum). ``noise_leaves``:
    quantized leaves whose exact grad is 0, so that both sides' momentum is
    rounding noise; their params are held as every other's, their codes and
    scales are not compared."""
    j_loss, loss = float(j_out[4]["loss"]), float(out[4]["loss"])
    assert np.isfinite(loss)
    assert abs(loss - j_loss) <= 1e-5 * abs(j_loss), (loss, j_loss)

    for key, idx in (("unet", 0), ("text_encoder", 1)):
        state = out[idx]
        j_params = jax_params_to_state_dict(_numpy(j_out[idx].params))
        j_ema = jax_params_to_state_dict(_numpy(j_out[idx + 2]))
        flipped = total = 0
        for name, p in state.params.items():
            expected = j_params[name]
            np.testing.assert_allclose(p.detach().numpy(), expected.numpy(), atol=PARAM_ATOL, rtol=0, err_msg=name)
            np.testing.assert_allclose(out[idx + 2][name].numpy(), j_ema[name].numpy(), atol=PARAM_ATOL, rtol=0, err_msg=name)
            step = (p.detach() - before[key][name]).numpy()
            j_step = (expected - before[key][name]).numpy()
            flipped += int((np.abs(step - j_step) > LR).sum())
            total += step.size
        assert flipped <= 1e-3 * total, (key, flipped, total)
        if key == "text_encoder" and not train_text_encoder:
            for name, p in state.params.items():
                assert torch.equal(p, before[key][name]), name
            assert state.opt_state == () and state.step == 0
            continue

        mu = state.opt_state[1][0].mu_quant
        j_mu = lion_momentum_from_jax(_numpy(j_out[idx].opt_state[1][0].mu_quant), state.model, "cpu")
        n_codes = n_far = 0
        for name, m in mu.items():
            if name in noise_leaves:
                continue
            if isinstance(m, QuantizedMomentum):
                codes, j_codes = m.codes.int(), j_mu[name].codes.int()
                far = (codes - j_codes).abs() > 1
                assert not (far & (torch.maximum(codes.abs(), j_codes.abs()) > noise_code)).any(), name
                n_codes += codes.numel()
                n_far += int(far.sum())
                np.testing.assert_allclose(m.scales.numpy(), j_mu[name].scales.numpy(), rtol=1e-2, err_msg=name)
            else:
                np.testing.assert_allclose(m.numpy(), j_mu[name].numpy(), atol=1e-6, rtol=1e-4, err_msg=name)
        assert n_codes > 0 and n_far <= 1e-4 * n_codes, (key, n_far, n_codes)


@pytest.fixture(scope="module")
def jax_step():
    return jax.jit(
        jax_train_step,
        static_argnames=("strip_bos_eos_token", "ema_rate") + STEP_OPTIONS,
    )


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(case, jax_step):
    jax_states = jax_training_state(_config(JaxTrainingConfig, case))
    port_states = on_device_model_training_state(_config(TrainingConfig, case), device="cpu")
    _load_jax_state(port_states, jax_states)
    before = {
        "unet": {k: v.detach().clone() for k, v in port_states[0].params.items()},
        "text_encoder": {k: v.detach().clone() for k, v in port_states[1].params.items()},
    }
    batch = _batch()
    rng = jax.random.PRNGKey(7)
    options = {k: CASES[case][k] for k in STEP_OPTIONS}
    j_out = jax_step(
        *jax_states[:4], {k: jnp.asarray(v) for k, v in batch.items()}, rng,
        jax_states[4], jax_states[5], strip_bos_eos_token=True, ema_rate=0.999, **options,
    )
    draws = _jax_draws(rng, (RES // 2, RES // 2))  # the tiny VAE downsamples once
    out = train_step(
        *port_states[:4], {k: torch.tensor(v) for k, v in batch.items()}, None,
        port_states[4], port_states[5], strip_bos_eos_token=True, ema_rate=0.999,
        draws=draws, **options,
    )

    assert_step_matches_jax(out, j_out, before)


def test_state_assembly_quirks():
    """lr = 1e-6 / 7 whatever the configured rate, decay 0.07; EMA buffers
    distinct from the params; masks on the JAX paths (norm weights are
    ``scale`` there, so excluded from quantization)."""
    states = on_device_model_training_state(_config(TrainingConfig, "v-zero-snr"), device="cpu")
    unet_state, _, unet_ema = states[:3]
    schedule_state = unet_state.opt_state[1][2]
    assert schedule_state == 0
    for name, p in unet_state.params.items():
        assert unet_ema[name].data_ptr() != p.data_ptr()
        torch.testing.assert_close(unet_ema[name], p.detach(), atol=0, rtol=0)
    flags = unet_state.opt_state[1][0].mu_quant_flag
    paths = jax_param_paths(unet_state.model)
    for name, flag in flags.items():
        assert flag == (paths[name][0][-1] == "kernel"), name


def test_bf16_weak_typing_matches_jax():
    """bf16 leaves times Python floats, as the JAX package computes them
    (the scalar in bf16 first): the EMA at 0.99998 (which rounds to 1.0 in
    bf16) and the decoupled weight decay. Bitwise."""
    rng = np.random.default_rng(11)
    ema, p, u = (rng.standard_normal((64, 48)).astype(np.float32) for _ in range(3))
    bf = lambda x: jnp.asarray(x).astype(jnp.bfloat16)
    expected_ema = jax.jit(lambda e, q: 0.99998 * e + (1 - 0.99998) * q)(bf(ema), bf(p))
    expected_u = jax.jit(lambda u, q: u + 0.07 * q)(bf(u), bf(p))
    t = lambda x: torch.tensor(x).bfloat16()
    got_ema = {"w": t(ema)}
    ema_update_(got_ema, {"w": t(p)}, 0.99998)
    got_u, _ = add_decayed_weights(0.07).update({"w": t(u)}, (), {"w": t(p)})
    for got, want in ((got_ema["w"], expected_ema), (got_u["w"], expected_u)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    # the EMA moved only where (1 - rate) * p reached half an ulp of it
    assert 0 < int((got_ema["w"] != t(ema)).sum()) < ema.size


@pytest.mark.parametrize(
    "kind,kw",
    [("constant", {}), ("constant", dict(warmup_steps=10)), ("cosine", dict(decay_steps=100)),
     ("warmup_cosine", dict(warmup_steps=10, decay_steps=100))],
)
def test_lr_schedules_match_jax(kind, kw):
    """``build_lr_schedule`` against the JAX package's optax schedules: f32
    arithmetic there, double rounded to f32 here, so 1e-6 of the peak rate
    (near the cosine's end its f32 cos of ~pi is only that good)."""
    from stable_diffusion_training_tpu.train import build_lr_schedule as jax_build
    from stable_diffusion_training_tpu_torch.train import build_lr_schedule

    j_sched, sched = jax_build(1e-4, kind, **kw), build_lr_schedule(1e-4, kind, **kw)
    for count in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        assert sched(count) == pytest.approx(float(j_sched(count)), rel=0, abs=1e-6 * 1e-4), count


def test_training_config_is_the_jax_packages():
    """Every field and default of the JAX ``TrainingConfig``, and the same
    subset rule for raw JSON dicts."""
    import dataclasses

    from stable_diffusion_training_tpu.train import training_config_from_dict as jax_from_dict
    from stable_diffusion_training_tpu_torch.train import training_config_from_dict

    fields = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert fields(TrainingConfig) == fields(JaxTrainingConfig)
    raw = dict(_config(TrainingConfig, "v-zero-snr").__dict__, extra_runtime_key=1)
    assert training_config_from_dict(raw).__dict__ == jax_from_dict(raw).__dict__
    with pytest.raises(KeyError):
        training_config_from_dict({"model_path": "x"})
