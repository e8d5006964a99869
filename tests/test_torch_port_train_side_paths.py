"""The train step's side paths in the port against the JAX package's, on the
CPU in f32: grad accumulation, a frozen text encoder, the latent cache
(``latent_moments`` batches), the cached context (``encoder_hidden_states``
batches), ``vae_encode_chunk`` and gradient checkpointing (UNet blocks and
feed-forwards). Grad accumulation, the cached context with
``vae_encode_chunk``, and the checkpointing cases run from
``tests/test_torch_port_train_side_paths_accum.py``, ``_encode.py`` and
``_remat.py`` (``CASES_BY_FILE``).

Each case starts both sides from one state (the JAX package's ``tiny``
family, crossed into the port as ``tests/test_torch_port_train_step.py``
does), runs one step of the jitted JAX ``train_step`` and one of the port's
with JAX's own draws injected (per micro-batch under grad accumulation: the
JAX step splits its ``sample`` key into one key per micro-batch), and holds
the results to the bounds of ``tests/test_torch_port_train_step.py`` (see
its docstring for why): loss 1e-5 relative; params and EMA 2 * lr + 1e-6
absolute with at most 1e-3 of the update signs flipped; momentum codes at
most one apart where |code| > 10 and at most 1e-4 of them further; scales
1e-2 relative. Under grad accumulation each grad is the sum of two
micro-batches' grads, each with its own rounding noise, so a momentum at
that noise reaches a little higher: codes further than one apart may have
|code| up to 15 there (a momentum below (15/127)^5 ~ 2e-5 of its block's
absmax; seen: 9 against 11, 3e-6 of the absmax apart). Recomputation
changes no value, so the gradient-checkpointing cases must also give the
port's step without it exactly.
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
from stable_diffusion_training_tpu_torch.optim import QuantizedMomentum
from stable_diffusion_training_tpu_torch.train import TrainingConfig, on_device_model_training_state, train_step
from test_torch_port_train_step import BATCH, RES, _batch, _config, _load_jax_state, assert_step_matches_jax
from torch_threads import _one_thread  # noqa: F401 (the fixture)

LATENT = RES // 2  # the tiny VAE downsamples once
TOKENS = 227  # 3 windows of 77, BOS/EOS stripped at the joins

CASES = {  # id: (config overrides, batch change)
    "grad-accumulation": (dict(grad_accumulation_steps=2), None),
    "frozen-text-encoder": (dict(train_text_encoder=False), None),
    "latent-cache": (dict(use_latent_cache=True), "latent_moments"),
    "cached-context": (dict(train_text_encoder=False, cached_text_context=True), "encoder_hidden_states"),
    "vae-encode-chunk": (dict(vae_encode_chunk=1), None),
    "gradient-checkpointing": (dict(gradient_checkpointing=True), None),
    "ff-gradient-checkpointing": (dict(ff_gradient_checkpointing=True), None),
}
# the cases by file: each file runs whole on one worker (``--dist loadfile``),
# so the others go to test_torch_port_train_side_paths_accum.py, _encode.py
# and _remat.py, which import this module's check and its JAX fixture
CASES_BY_FILE = {
    "train_side_paths": ("frozen-text-encoder", "latent-cache"),
    "train_side_paths_accum": ("grad-accumulation",),
    "train_side_paths_encode": ("cached-context", "vae-encode-chunk"),
    "train_side_paths_remat": ("gradient-checkpointing", "ff-gradient-checkpointing"),
}
assert sorted(sum(CASES_BY_FILE.values(), ())) == sorted(CASES)
RNG = jax.random.PRNGKey(7)
STATICS = ("strip_bos_eos_token", "ema_rate", "grad_accumulation_steps", "train_text_encoder",
           "vae_encode_chunk")


def _case_batch(change):
    batch = _batch()
    rng = np.random.default_rng(1)
    if change == "latent_moments":
        del batch["pixel_values"]
        batch["latent_moments"] = rng.standard_normal((BATCH, 8, LATENT, LATENT)).astype(np.float32)
    elif change == "encoder_hidden_states":
        batch["encoder_hidden_states"] = rng.standard_normal((BATCH, TOKENS, 32)).astype(np.float32)
    return batch


def _draws(sample_rng, b):
    """One micro-batch's draws from its ``sample`` key, as the JAX step makes
    them (the VAE eps NHWC, transposed)."""
    eps = jax.random.normal(sample_rng, (b, LATENT, LATENT, 4), dtype=jnp.float32)
    offset_rng, noise_rng, perturb_rng, t_rng = jax.random.split(key=sample_rng, num=4)
    draws = {
        "latent_eps": np.asarray(eps).transpose(0, 3, 1, 2),
        "noise": np.asarray(jax.random.normal(noise_rng, (b, 4, LATENT, LATENT))),
        "noise_offset": np.asarray(jax.random.normal(offset_rng, (b, 4, 1, 1))),
        "perturb_noise": np.asarray(jax.random.normal(perturb_rng, (b, 4, LATENT, LATENT))),
        "timesteps": np.asarray(jax.random.randint(t_rng, (b,), 0, 1000)),
    }
    return {k: torch.tensor(v) for k, v in draws.items()}


def _jax_draws(rng, accum):
    _, sample_rng, _ = jax.random.split(rng, num=3)
    if accum == 1:
        return _draws(sample_rng, BATCH)
    return [_draws(key, BATCH // accum) for key in jax.random.split(sample_rng, accum)]


def _port_step(case, draws, jax_states):
    overrides, change = CASES[case]
    cfg = _config(TrainingConfig, "v-zero-snr").replace(**overrides)
    states = on_device_model_training_state(cfg, device="cpu")
    _load_jax_state(states, jax_states, cfg.train_text_encoder)
    before = {
        key: {k: v.detach().clone() for k, v in s.params.items()}
        for key, s in (("unet", states[0]), ("text_encoder", states[1]))
    }
    batch = {k: torch.tensor(v) for k, v in _case_batch(change).items()}
    out = train_step(
        *states[:4], batch, None, states[4], states[5], strip_bos_eos_token=True, ema_rate=0.999,
        grad_accumulation_steps=cfg.grad_accumulation_steps, train_text_encoder=cfg.train_text_encoder,
        vae_encode_chunk=cfg.vae_encode_chunk, draws=draws,
    )
    return out, before


@pytest.fixture(scope="module")
def jax_base():
    """One JAX state for every case (the side paths change the step, not the
    state: a frozen text encoder's state passes through the JAX step
    untouched), its jitted step, and that step's output without side paths,
    which the gradient-checkpointing cases are held to (recomputation does
    not change the JAX step's values either)."""
    jax_states = jax_training_state(_config(JaxTrainingConfig, "v-zero-snr"))
    step = jax.jit(jax_train_step, static_argnames=STATICS)
    plain = _jax_step(step, jax_states, CASES["gradient-checkpointing"])
    return jax_states, step, plain


def _jax_step(step, jax_states, case):
    overrides, change = case
    return step(
        *jax_states[:4], {k: jnp.asarray(v) for k, v in _case_batch(change).items()}, RNG,
        jax_states[4], jax_states[5], strip_bos_eos_token=True, ema_rate=0.999,
        grad_accumulation_steps=overrides.get("grad_accumulation_steps", 1),
        train_text_encoder=overrides.get("train_text_encoder", True),
        vae_encode_chunk=overrides.get("vae_encode_chunk", 0),
    )


@pytest.mark.parametrize("case", CASES_BY_FILE["train_side_paths"])
def test_side_path_matches_jax(case, jax_base):
    check_side_path(case, jax_base)


def check_side_path(case, jax_base):
    """One side path's step against the JAX step's, and under gradient
    checkpointing against the port's step without it, bit for bit."""
    jax_states, step, plain = jax_base
    overrides = CASES[case][0]
    j_out = plain if "checkpointing" in case else _jax_step(step, jax_states, CASES[case])
    accum = overrides.get("grad_accumulation_steps", 1)
    draws = _jax_draws(RNG, accum)
    out, before = _port_step(case, draws, jax_states)
    assert_step_matches_jax(out, j_out, before, overrides.get("train_text_encoder", True),
                            noise_code=15 if accum > 1 else 10)

    if "checkpointing" in case:
        # the same step without recomputation: equal, bit for bit
        ref = _plain_step(draws, jax_states)
        assert torch.equal(out[4]["loss"], ref[4]["loss"])
        for idx in (0, 1, 2, 3):
            got = out[idx].params if idx < 2 else out[idx]
            want = ref[idx].params if idx < 2 else ref[idx]
            for name in got:
                assert torch.equal(got[name], want[name]), (idx, name)
        for idx in (0, 1):
            for name, m in out[idx].opt_state[1][0].mu_quant.items():
                r = ref[idx].opt_state[1][0].mu_quant[name]
                if isinstance(m, QuantizedMomentum):
                    assert torch.equal(m.codes, r.codes) and torch.equal(m.scales, r.scales), name
                else:
                    assert torch.equal(m, r), name


@pytest.mark.parametrize(
    "overrides",
    [dict(cached_text_context=True, train_text_encoder=True), dict(vae_encode_chunk=3)],
    ids=["cached-context-trains-text-encoder", "vae-encode-chunk-not-dividing"],
)
def test_config_rejects_what_the_jax_config_rejects(overrides):
    """The side paths' config checks, with the JAX package's messages up to
    its reason in parentheses (a batch of 2 is not split into chunks of 3)."""
    with pytest.raises(ValueError) as jax_error:
        _config(JaxTrainingConfig, "v-zero-snr").replace(**overrides)
    with pytest.raises(ValueError) as port_error:
        _config(TrainingConfig, "v-zero-snr").replace(**overrides)
    assert str(port_error.value).split(" (")[0] == str(jax_error.value).split(" (")[0]


def _plain_step(draws, jax_states):
    """The port's step from the same state, with no recomputation."""
    states = on_device_model_training_state(_config(TrainingConfig, "v-zero-snr"), device="cpu")
    _load_jax_state(states, jax_states, True)
    batch = {k: torch.tensor(v) for k, v in _batch().items()}
    return train_step(*states[:4], batch, None, states[4], states[5], strip_bos_eos_token=True,
                      ema_rate=0.999, draws=draws)
