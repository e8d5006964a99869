"""The train step (SD1.5, SD2.1, SDXL): VAE encode -> noise -> text encode ->
UNet -> loss -> grads -> each model's optimizer chain -> EMA.

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

The JAX step's side paths are here too: ``grad_accumulation_steps > 1``
(per-micro draws: the JAX package splits ``sample`` and ``dropout`` into one
key per micro-batch, and the seam takes one dict of draws per micro-batch),
``train_text_encoder=False``, ``latent_moments`` batches (the latent cache),
``encoder_hidden_states`` batches (the cached context) and
``vae_encode_chunk``.

SDXL's micro-conditioning: a batch with ``pooled_text_embeds`` ``(B,
pooled)`` and ``time_ids`` ``(B, 6)`` (5 for the refiner) passes them to the
UNet's ``text_time`` add-embedding as ``added_cond_kwargs``, as the batch
holds them (``data/latent_cache.py`` writes both, f32). At SDXL's width the
2048-wide context comes from the batch's ``encoder_hidden_states`` (both
frozen towers, precomputed): the in-step encode carries tower 1 alone.

Data parallelism (``mesh``, ``core.create_mesh``): each of the W = data x
fsdp ranks steps on its own rows of the global batch (``core.mesh.row_index``).
It scales its local loss by ``1 / W`` before the grads, so that their sum
over the ranks is the gradient of the global batch's mean, in JAX's order of
scaling (local partials of the global mean, then a sum); the returned loss
is summed too, the global mean on every rank. The draws are made at the
global batch's shape from the generator, which every rank seeds alike, and
each rank keeps its rows, so one seed trains the same on any world size;
``draws`` then holds global draws. With ``grad_accumulation_steps = a`` each
rank splits its own rows into ``a`` micro-batches (micro-batch ``j`` across
the ranks is rank 0's ``j``-th slice, then rank 1's ...; the JAX step's
``j`` is a slice of the global batch: the sum over rows is the same).

With replicated state the grads are summed by ``parallel.all_reduce_grads_``
(in the grads' dtype) and every rank runs the same clip, Lion, decay and EMA
on the same grads, so their states stay bitwise equal. With FSDP-sharded
models (``TrainState.plan.fsdp``) the grads come from ``loss.backward()``:
``torch.autograd.grad`` cannot reach the sharded parameters, since the
forward runs on FSDP2's gathered ones. FSDP2's reduce-scatter sums them
into each rank's shard (and all-reduces the shards over the data axis under
HSDP), and the chain runs on the local shards (``optim.lion8bit``).

Under tensor parallelism (``TrainState.plan`` from
``parallel.tensor_parallel_``) the ``model_parallel`` ranks of a row block
take the same rows and draws; their split layers' sums over the axis run
inside the autograd graph (``parallel.sharding.tp_copy`` and
``tp_row_linear``; gradient checkpointing repeats the forward's sums in
its recompute), so ``torch.autograd.grad`` gives each rank the grads of its
slices and its own copy of every whole leaf's. Grads and loss are then
summed over the data x fsdp ranks only, and every whole leaf's grad becomes
the ``model_parallel`` axis's first rank's (``parallel.replicate_`` over
that axis): the copies differ only by the kernels' run-to-run rounding
(cuDNN's weight-grad sums, the flash backward's dQ sum), and the whole
leaves' replicas stay bitwise alike, as XLA's do. A ``model_parallel`` axis
without ``tensor_parallel_shard_params`` holds replicas of every leaf, which
take the first rank's grads the same way. With FSDP too, each rank's
grads are FSDP2's shards of its own leaves (``loss.backward()``, the
reduce-scatter over fsdp), and the model_parallel ranks then take the
first rank's shards of the leaves that TP leaves whole.
"""

from typing import Any, Dict, Optional, Sequence, Union

import torch

from ..core.mesh import AXIS_TENSOR, row_index
from ..diffusion import compute_snrs
from ..models.vae import DiagonalGaussianDistribution
from ..optim.transforms import weak
from ..parallel import all_reduce_grads_, replicate_
from ..parallel.sharding import all_reduce_, local_tensor
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


def rank_rows(draws: Dict[str, torch.Tensor], index: int, count: int) -> Dict[str, torch.Tensor]:
    """Rank ``index`` of ``count``'s rows of each of ``draws`` (made at the
    global batch's shape): the ``index``-th of ``count`` equal row blocks."""
    if count == 1:
        return draws
    out = {}
    for key, value in draws.items():
        if value.shape[0] % count:
            raise ValueError(f"draws[{key!r}] has {value.shape[0]} rows, not a multiple of {count} ranks")
        per = value.shape[0] // count
        out[key] = value[index * per : (index + 1) * per]
    return out


@torch.no_grad()
def ema_update_(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor], rate: float) -> None:
    """``ema = rate * ema + (1 - rate) * p`` in place, the scalars in each
    leaf's dtype as JAX's weak typing has them: for bf16 leaves 0.99998
    becomes 1.0 and 1 - 0.99998 becomes bf16(2e-5), as in the JAX package."""
    for name, p in params.items():
        e = ema[name]
        e.copy_(weak(rate, e) * e + weak(1 - rate, p) * p)


def _latent_dist(batch: Dict[str, torch.Tensor], vae, vae_encode_chunk: int):
    """The latents' posterior: from the batch's ``latent_moments`` (the
    offline latent cache; the VAE is skipped), else from the frozen VAE, over
    the whole batch or ``vae_encode_chunk`` samples at a time (the same
    values: the encode is per-sample)."""
    if "latent_moments" in batch:
        return DiagonalGaussianDistribution(batch["latent_moments"], dim=1)
    with torch.no_grad():
        pixels = batch["pixel_values"].to(vae.dtype)
        if not vae_encode_chunk:
            return vae.encode(pixels).latent_dist
        if pixels.shape[0] % vae_encode_chunk:
            raise ValueError(
                f"vae_encode_chunk={vae_encode_chunk} must divide batch size {pixels.shape[0]}"
            )
        moments = []
        for chunk in pixels.split(vae_encode_chunk):
            d = vae.encode(chunk).latent_dist
            # logvar is clipped already; the distribution clips again (idempotent)
            moments.append(torch.cat([d.mean, d.logvar], dim=1))
        return DiagonalGaussianDistribution(torch.cat(moments), dim=1)


def _loss(
    unet_state, text_encoder_state, frozen_vae_state, frozen_noise_scheduler_state,
    batch, train_rng, draws, *, strip_bos_eos_token, offset_noise_magnitude,
    min_snr_gamma_magnitude, perturbation_noise_magnitude, text_context_window,
    train_text_encoder, vae_encode_chunk, shard=(0, 1),
) -> torch.Tensor:
    """The JAX step's ``_compute_loss_with_rngs`` for one (micro-)batch:
    this rank's rows, ``shard = (rank, ranks)`` of the global batch, whose
    draws are made (or given) at the global shape."""
    scheduler = frozen_noise_scheduler_state.call
    scheduler_state = frozen_noise_scheduler_state.params
    unet = unet_state.model

    latent_dist = _latent_dist(batch, frozen_vae_state.call, vae_encode_chunk)
    mean = latent_dist.mean
    if draws is None:
        global_shape = (mean.shape[0] * shard[1],) + tuple(mean.shape[1:])
        draws = make_draws(
            train_rng, global_shape, mean.dtype, scheduler.config.num_train_timesteps, mean.device
        )
    draws = rank_rows(draws, *shard)
    latents = mean + latent_dist.std * draws["latent_eps"].to(mean.dtype)
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

    if "encoder_hidden_states" in batch:
        # the cached context (a frozen text encoder's, precomputed offline)
        context = batch["encoder_hidden_states"]
    else:
        with torch.set_grad_enabled(train_text_encoder and torch.is_grad_enabled()):
            hidden = text_encoder_state.model(batch["input_ids"])[0]
        # (batch*concat, win, dim) -> (batch, concat, win, dim) -> context
        hidden = hidden.reshape(b, -1, text_context_window, hidden.shape[-1])
        context = concat_context_windows(hidden, strip_bos_eos_token)

    added_cond_kwargs = None
    if "pooled_text_embeds" in batch:
        # SDXL micro-conditioning: the frozen second tower's pooled embeds
        # and the size/crop time ids, precomputed with the latent cache. As
        # in the JAX step they go in as the batch holds them (f32): the
        # UNet takes the ids' sinusoids in f32, then casts to its dtype
        added_cond_kwargs = {"text_embeds": batch["pooled_text_embeds"], "time_ids": batch["time_ids"]}
    model_pred = unet(noisy_latents.to(unet.dtype), timesteps, context.to(unet.dtype), added_cond_kwargs)
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
    return loss.mean()


def _grads(loss: torch.Tensor, params: Dict[str, torch.Tensor], sharded: bool = False):
    """d loss / d params; zeros for params the loss does not use (a trained
    text encoder under a cached context), as JAX's grad gives them.
    ``sharded``: the params are FSDP2's, and each grad is this rank's shard
    of the reduce-scattered sum, read from ``.grad`` after
    ``loss.backward()`` (and cleared)."""
    if not sharded:
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params.values())]
    loss.backward()
    grads = [torch.zeros_like(local_tensor(p)) if p.grad is None else local_tensor(p.grad) for p in params.values()]
    for p in params.values():
        p.grad = None
    return grads


def _split_names(state, prefix: str) -> set:
    """The grads' names of the leaves that ``state``'s plan splits over the
    ``model_parallel`` axis."""
    plan = None if state is None else state.plan
    return set() if plan is None else {prefix + name for name in plan.tp_names}


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
    draws: Union[None, Dict[str, torch.Tensor], Sequence[Dict[str, torch.Tensor]]] = None,
    mesh=None,
):
    """One optimization step. Returns ``(unet_state, text_encoder_state,
    unet_ema, text_ema, {"loss"}, train_rng)`` in the JAX package's order;
    the states and EMA buffers are updated in place. ``batch`` holds NCHW
    ``pixel_values`` (or ``latent_moments``, NCHW with twice the latent
    channels), ``input_ids`` ``(B * concat, window)`` and optionally
    ``encoder_hidden_states`` ``(B, tokens, cross_attention_dim)`` and
    SDXL's ``pooled_text_embeds`` and ``time_ids``.

    ``grad_accumulation_steps = n > 1`` splits every batch entry into ``n``
    micro-batches along its leading axis, each with its own draws (``draws``
    is then a sequence of ``n`` dicts), sums ``grad / n`` and ``loss / n`` in
    f32, casts the grads back to the params' dtype and applies one update.
    ``train_text_encoder=False`` takes no text-encoder grads and applies no
    text-encoder update; its EMA, if any, still follows its params.

    ``mesh``: ``batch`` is this rank's rows of the global batch, and the
    grads and the loss are summed over the mesh's data x fsdp ranks (module
    docstring); None is one process."""
    index, ranks = row_index(mesh)
    loss_kw = dict(
        strip_bos_eos_token=strip_bos_eos_token, offset_noise_magnitude=offset_noise_magnitude,
        min_snr_gamma_magnitude=min_snr_gamma_magnitude,
        perturbation_noise_magnitude=perturbation_noise_magnitude,
        text_context_window=text_context_window, train_text_encoder=train_text_encoder,
        vae_encode_chunk=vae_encode_chunk, shard=(index, ranks),
    )
    states = (unet_state, text_encoder_state, frozen_vae_state, frozen_noise_scheduler_state)
    sharded = unet_state.plan is not None and unet_state.plan.fsdp
    # the modules' parameters: the grads' targets (FSDP2's DTensors when sharded)
    diff_params = dict(unet_state.model.named_parameters())
    if train_text_encoder:
        diff_params.update({f"text_encoder/{k}": v for k, v in text_encoder_state.model.named_parameters()})

    if grad_accumulation_steps <= 1:
        loss = _loss(*states, batch, train_rng, draws, **loss_kw)
        grads = dict(zip(diff_params, _grads(loss / ranks, diff_params, sharded)))
    else:
        accum = grad_accumulation_steps
        image_key = "pixel_values" if "pixel_values" in batch else "latent_moments"
        total_b = batch[image_key].shape[0]
        if total_b % accum:
            raise ValueError(
                f"batch size {total_b} not divisible by grad_accumulation_steps={accum}"
            )
        if draws is not None and len(draws) != accum:
            raise ValueError(f"draws: one dict per micro-batch ({accum}), got {len(draws)}")
        # leading dims are batch-derived (pixel_values B; ids B * concat)
        micro = {k: v.chunk(accum) for k, v in batch.items()}
        loss = torch.zeros((), dtype=torch.float32, device=batch[image_key].device)
        grads = {k: torch.zeros_like(local_tensor(p), dtype=torch.float32) for k, p in diff_params.items()}
        for i in range(accum):
            mb = {k: v[i] for k, v in micro.items()}
            micro_loss = _loss(*states, mb, train_rng, None if draws is None else draws[i], **loss_kw)
            micro_grads = _grads(micro_loss / ranks, diff_params, sharded)
            with torch.no_grad():
                for acc, g in zip(grads.values(), micro_grads):
                    acc.add_(g / weak(accum, g))  # JAX's a + b / n: b / n in b's dtype
                loss = loss + micro_loss.detach() / accum
            del micro_loss, micro_grads
        grads = {k: g.to(diff_params[k].dtype) for k, g in grads.items()}

    if mesh is not None:
        if not sharded:  # FSDP2 has summed the sharded grads in the backward
            all_reduce_grads_(grads, mesh)
        # the leaves alike on the model_parallel ranks (their local shards under FSDP)
        split = _split_names(unet_state, "") | _split_names(text_encoder_state, "text_encoder/")
        replicate_([g for k, g in grads.items() if k not in split], mesh, (AXIS_TENSOR,))
        loss = all_reduce_((loss.detach() / ranks).reshape(1), mesh)[0]
    unet_state.apply_gradients({k: grads[k] for k in unet_state.params})
    if train_text_encoder:
        text_encoder_state.apply_gradients(
            {k: grads[f"text_encoder/{k}"] for k in text_encoder_state.params}
        )
    del grads

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
