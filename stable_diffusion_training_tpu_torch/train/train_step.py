"""The SD1.5 train step: VAE encode -> noise -> text encode -> UNet -> loss ->
grads -> each model's optimizer chain -> EMA.

Port of ``stable_diffusion_training_tpu/train/train_step.py``, eager on the
card where the JAX package traces one XLA program. Same signature groups
and return order, same options (offset and perturbation noise, uniform
timesteps, BOS/EOS window stripping, epsilon or velocity targets,
min-SNR-gamma) and the EMA after the update.

Random draws go through one seam. By default a ``torch.Generator`` makes
them; ``draws`` may supply ``latent_eps`` (NCHW, the VAE sample's noise),
``noise`` (NCHW), ``noise_offset`` ``(B, C, 1, 1)`` and ``perturb_noise``
(NCHW), both before their magnitudes, and ``timesteps`` ``(B,)``. The JAX
package draws them from ``dropout, sample, next = split(rng, 3)`` and
``offset, noise, perturb, timestep = split(sample, 4)``, the VAE eps with
``sample`` in NHWC and the mean's dtype; torch cannot reproduce threefry, so
the tests make those draws with ``jax.random`` and pass them here.

The side paths of the JAX step (``grad_accumulation_steps > 1``,
``train_text_encoder=False``, ``latent_moments`` and
``encoder_hidden_states`` batches, ``vae_encode_chunk``) raise
``NotImplementedError``; they are ROADMAP Queue 1's next items.
"""

from typing import Any, Dict, Optional

import torch

from ..diffusion import compute_snrs
from ..optim.transforms import weak
from ..utils.context import concat_context_windows

def make_draws(
    generator: torch.Generator,
    latent_shape,
    dtype: torch.dtype,
    num_train_timesteps: int,
    device,
) -> Dict[str, torch.Tensor]:
    """The step's random draws from ``generator``: the VAE eps in the
    latents' dtype, the noises in f32, uniform int timesteps."""
    b, c = latent_shape[:2]

    def normal(shape, dt=torch.float32):
        return torch.randn(shape, generator=generator, device=device, dtype=dt)

    return {
        "latent_eps": normal(latent_shape, dtype),
        "noise": normal(latent_shape),
        "noise_offset": normal((b, c, 1, 1)),
        "perturb_noise": normal(latent_shape),
        "timesteps": torch.randint(
            0, num_train_timesteps, (b,), generator=generator, device=device
        ),
    }


@torch.no_grad()
def ema_update_(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor], rate: float) -> None:
    """``ema = rate * ema + (1 - rate) * p`` in place, the scalars in each
    leaf's dtype as JAX's weak typing has them: for bf16 leaves 0.99998
    becomes 1.0 and 1 - 0.99998 becomes bf16(2e-5), as in the JAX package."""
    for name, p in params.items():
        e = ema[name]
        e.copy_(weak(rate, e) * e + weak(1 - rate, p) * p)


def _side_path(name: str) -> NotImplementedError:
    return NotImplementedError(f"{name} is a side path of the train step not ported yet (ROADMAP Queue 1)")


def train_step(
    # states updated in place and returned
    unet_state: Any,
    text_encoder_state: Any,
    unet_ema_params: Optional[Dict[str, torch.Tensor]],
    text_encoder_ema_params: Optional[Dict[str, torch.Tensor]],
    # variable args
    batch: Dict[str, torch.Tensor],
    train_rng: Optional[torch.Generator],
    # frozen states
    frozen_vae_state: Any,
    frozen_noise_scheduler_state: Any,
    # options
    strip_bos_eos_token: bool = True,
    offset_noise_magnitude: float = 0.0,
    min_snr_gamma_magnitude: float = 0.0,
    perturbation_noise_magnitude: float = 0.0,
    ema_rate: float = 0.0,
    text_context_window: int = 77,
    grad_accumulation_steps: int = 1,
    train_text_encoder: bool = True,
    vae_encode_chunk: int = 0,
    draws: Optional[Dict[str, torch.Tensor]] = None,
):
    """One optimization step. Returns ``(unet_state, text_encoder_state,
    unet_ema, text_ema, {"loss"}, train_rng)`` in the JAX package's order;
    the states and EMA buffers are updated in place. ``batch`` holds NCHW
    ``pixel_values`` and ``input_ids`` ``(B * concat, window)``."""
    if grad_accumulation_steps > 1:
        raise _side_path("grad_accumulation_steps > 1")
    if not train_text_encoder:
        raise _side_path("train_text_encoder=False")
    if vae_encode_chunk:
        raise _side_path("vae_encode_chunk")
    for key in ("latent_moments", "encoder_hidden_states"):
        if key in batch:
            raise _side_path(f"a batch with {key!r}")

    scheduler = frozen_noise_scheduler_state.call
    scheduler_state = frozen_noise_scheduler_state.params
    vae = frozen_vae_state.call
    unet = unet_state.model
    text_encoder = text_encoder_state.model

    with torch.no_grad():
        pixels = batch["pixel_values"].to(vae.dtype)
        latent_dist = vae.encode(pixels).latent_dist
    if draws is None:
        draws = make_draws(
            train_rng, latent_dist.mean.shape, latent_dist.mean.dtype,
            scheduler.config.num_train_timesteps, pixels.device,
        )
    latents = latent_dist.mean + latent_dist.std * draws["latent_eps"].to(latent_dist.mean.dtype)
    latents = latents * weak(0.18215, latents)
    b = latents.shape[0]

    noise = draws["noise"]
    if offset_noise_magnitude:
        noise = noise + draws["noise_offset"] * weak(offset_noise_magnitude, noise)
    if perturbation_noise_magnitude:
        perturb = draws["perturb_noise"]
        noise = noise + weak(perturbation_noise_magnitude, perturb) * perturb
    timesteps = draws["timesteps"]
    noisy_latents = scheduler.add_noise(scheduler_state, latents, noise, timesteps)

    hidden = text_encoder(batch["input_ids"])[0]
    # (batch*concat, win, dim) -> (batch, concat, win, dim) -> context
    hidden = hidden.reshape(b, -1, text_context_window, hidden.shape[-1])
    context = concat_context_windows(hidden, strip_bos_eos_token)

    model_pred = unet(noisy_latents.to(unet.dtype), timesteps, context)
    prediction_type = scheduler.config.prediction_type
    if prediction_type == "epsilon":
        target = noise
    elif prediction_type == "v_prediction":
        target = scheduler.get_velocity(scheduler_state, latents, noise, timesteps)
    else:
        raise ValueError(f"Unknown prediction type {prediction_type}")

    loss = (target - model_pred) ** 2
    if min_snr_gamma_magnitude:
        # weight = min(snr, gamma) / snr (epsilon) or / (snr + 1) (velocity)
        snr = compute_snrs(scheduler_state.common.alphas_cumprod)[timesteps]
        min_snr_gamma = torch.clamp(snr, max=min_snr_gamma_magnitude)
        denom = snr + 1 if prediction_type == "v_prediction" else snr
        loss = loss * (min_snr_gamma / denom).float()[:, None, None, None]
    loss = loss.mean()

    unet_params = unet_state.params
    text_params = text_encoder_state.params
    grads = torch.autograd.grad(loss, [*unet_params.values(), *text_params.values()])
    unet_grads = dict(zip(unet_params, grads[: len(unet_params)]))
    text_grads = dict(zip(text_params, grads[len(unet_params):]))
    del grads
    unet_state.apply_gradients(unet_grads)
    text_encoder_state.apply_gradients(text_grads)

    if not ema_rate:
        unet_ema_params = text_encoder_ema_params = None
    for ema, state in ((unet_ema_params, unet_state), (text_encoder_ema_params, text_encoder_state)):
        if ema is not None:
            ema_update_(ema, state.params, ema_rate)
    return (
        unet_state,
        text_encoder_state,
        unet_ema_params,
        text_encoder_ema_params,
        {"loss": loss.detach()},
        train_rng,
    )
