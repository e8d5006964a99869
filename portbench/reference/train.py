"""The plain reference of the train step: noise schedule, v-prediction loss,
gradients, the optimizer chain (clip by global norm, 8-bit Lion with
decoupled weight decay, learning rate) and the EMA.

Each step takes the whole batch as the program does, computed in blocks of
rows so that it fits: the loss is the mean of the blocks' means (equal
blocks) and each gradient the f32 sum of the blocks' gradients over the
block count, cast to the parameter's dtype once.

The optimizer follows the recipe that the configuration states (the JAX
trainer's, which the program ports): for each trained model
``clip_by_global_norm(1)`` -> Lion (b1 0.9, b2 0.99) whose momentum is
int8 codes and f32 inverse-absmax scales per block of ``block_size``
elements (signed 5th-power compander, zero-crossing offset, blocks over
the JAX leaf's flat order: a Dense kernel transposed, a Conv kernel as
``(kh, kw, I, O)``) on the leaves the quantization mask keeps, an f32
momentum on the others -> ``+ decay * p`` on the decay mask -> ``* -lr``,
added to the parameter in its dtype. Scalars meet a tensor in the tensor's
dtype, as JAX's weak typing has them. The EMA is ``rate * e + (1 - rate) *
p`` in the EMA's dtype.
"""

from typing import Dict, List, Optional, Sequence

import torch

from .numerics import Numerics

ZERO_CROSSING_OFFSET = 3.7398995e-09
B1, B2 = 0.9, 0.99


# --- the noise schedule ------------------------------------------------------


def alphas_cumprod(schedule: str, steps: int = 1000, start: float = 0.00085, end: float = 0.012,
                   device=None) -> torch.Tensor:
    """f32 ``alpha_bar`` of ``scaled_linear``, or of ``zero_snr_scaled_linear``
    (rescaled so the last step has zero SNR, arXiv 2305.08891 Alg. 1)."""
    betas = torch.linspace(start**0.5, end**0.5, steps, dtype=torch.float32) ** 2
    if schedule == "zero_snr_scaled_linear":
        root = torch.cumprod(1.0 - betas, dim=0).sqrt()
        first, last = root[0].clone(), root[-1].clone()
        root = (root - last) * first / (first - last)
        bar = root**2
        betas = 1.0 - torch.cat([bar[0:1], bar[1:] / bar[:-1]])
    elif schedule != "scaled_linear":
        raise ValueError(f"the reference has no schedule {schedule!r}")
    return torch.cumprod(1.0 - betas.to(device), dim=0)


def _coefs(bar: torch.Tensor, t: torch.Tensor):
    a = bar[t]
    return (a**0.5).reshape(-1, 1, 1, 1), ((1 - a) ** 0.5).reshape(-1, 1, 1, 1)


def context_windows(hidden: torch.Tensor, strip: bool) -> torch.Tensor:
    """``(B, concat, win, dim)`` -> the ``(B, tokens, dim)`` context: window
    0 without its EOS, middle windows without BOS and EOS, the last without
    its BOS (all of each window without ``strip``)."""
    b, dim = hidden.shape[0], hidden.shape[-1]
    if not strip:
        return hidden.reshape(b, -1, dim)
    return torch.cat([hidden[:, 0, :-1], hidden[:, 1:-1, 1:-1].reshape(b, -1, dim), hidden[:, -1, 1:]], dim=1)


def block_loss(models: Dict, recipe: Dict, batch: Dict, draws: Dict, bar: torch.Tensor) -> torch.Tensor:
    """The loss of one block of rows: its latents (from the frozen VAE
    encoder, or the batch's cached moments), the noised latents, the
    context (the text tower, or the batch's cached context), the UNet's
    prediction against the velocity (or noise) target, the mean square."""
    unet = models["unet"]
    dtype = unet.conv_in.weight.dtype
    if "latent_moments" in batch:
        moments = batch["latent_moments"]
    else:
        with torch.no_grad():
            moments = models["vae"](batch["pixel_values"].to(dtype))
    mean, logvar = moments.chunk(2, dim=1)
    std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
    latents = mean + std * draws["latent_eps"].to(mean.dtype)
    latents = latents * torch.tensor(0.18215, dtype=latents.dtype)
    noise = draws["noise"]
    t = draws["timesteps"]
    sa, sb = _coefs(bar, t)
    noisy = sa * latents + sb * noise
    if "encoder_hidden_states" in batch:
        context = batch["encoder_hidden_states"]
    else:
        text = models["text"]
        window = recipe["text_encoder_context_window"]
        with torch.set_grad_enabled(recipe["train_text_encoder"] and torch.is_grad_enabled()):
            hidden = text(batch["input_ids"])
        hidden = hidden.reshape(latents.shape[0], -1, window, hidden.shape[-1])
        context = context_windows(hidden, recipe["strip_bos_eos_token"])
    added = None
    if "pooled_text_embeds" in batch:
        added = {"text_embeds": batch["pooled_text_embeds"], "time_ids": batch["time_ids"]}
    pred = unet(noisy.to(dtype), t, context.to(dtype), added)
    if recipe["prediction_type"] == "v_prediction":
        target = sa * noise - sb * latents
    elif recipe["prediction_type"] == "epsilon":
        target = noise
    else:
        raise ValueError(recipe["prediction_type"])
    return ((target - pred) ** 2).mean()


def _rows(value: torch.Tensor, rows: int, block: int, per_row: int):
    """Block ``block`` of ``rows`` rows of a batch entry with ``per_row``
    entries a row (the token ids: one per context window)."""
    return value[block * rows * per_row : (block + 1) * rows * per_row]


def loss_and_grads(models: Dict, trained: Dict[str, Dict[str, torch.Tensor]], recipe: Dict, batch: Dict,
                   draws: Dict, bar: torch.Tensor, block_rows: int):
    """The whole batch's loss and ``{model: {name: grad}}`` over blocks of
    ``block_rows`` rows."""
    b = draws["timesteps"].shape[0]
    if b % block_rows:
        raise ValueError(f"block of {block_rows} rows does not divide the batch of {b}")
    blocks = b // block_rows
    leaves = [(m, n, p) for m, params in trained.items() for n, p in params.items()]
    acc = [torch.zeros_like(p, dtype=torch.float32) for _, _, p in leaves]
    total = torch.zeros((), dtype=torch.float32, device=draws["noise"].device)
    for i in range(blocks):
        part = {k: _rows(v, block_rows, i, v.shape[0] // b) for k, v in batch.items()}
        part_draws = {k: _rows(v, block_rows, i, v.shape[0] // b) for k, v in draws.items()}
        loss = block_loss(models, recipe, part, part_draws, bar)
        grads = torch.autograd.grad(loss, [p for _, _, p in leaves], allow_unused=True)
        for a, g in zip(acc, grads):
            if g is not None:
                a.add_(g.float())
        total += loss.detach().float()
        del loss, grads
    out: Dict[str, Dict[str, torch.Tensor]] = {m: {} for m in trained}
    for (m, n, p), a in zip(leaves, acc):
        out[m][n] = (a / blocks).to(p.dtype)
    return total / blocks, out


# --- 8-bit Lion ----------------------------------------------------------------


def quantize(x: torch.Tensor) -> torch.Tensor:
    shifted = x + ZERO_CROSSING_OFFSET
    return torch.round(torch.pow(shifted.abs(), 0.2) * torch.sign(shifted) * 127).to(torch.int8)


def dequantize(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """f32 values of ``(n_blocks, bs)`` codes under ``(n_blocks,)`` inverse
    scales: ``((q / 127)^5 - offset) / scale``."""
    x = codes.float() / torch.tensor(127.0, device=codes.device)
    x2 = x * x
    return (x * (x2 * x2) - ZERO_CROSSING_OFFSET) / scales[:, None]


def block_quantize(mu: torch.Tensor, bs: int):
    blocks = mu.reshape(-1, bs)
    absmax = blocks.abs().amax(dim=1)
    scales = 1.0 / torch.where(absmax <= 0.0, torch.ones_like(absmax), absmax)
    return quantize(blocks * scales[:, None]), scales


def jax_order(t: torch.Tensor) -> torch.Tensor:
    """A Dense or Conv kernel in the JAX layout's flat order."""
    perm = {2: (1, 0), 4: (2, 3, 1, 0)}.get(t.dim())
    return (t.permute(*perm) if perm else t).reshape(-1)


def leaf_kind(module: torch.nn.Module, name: str) -> str:
    """``bias``, ``scale`` (a norm's weight), ``embedding`` or ``kernel``."""
    owner_name, _, leaf = name.rpartition(".")
    if leaf == "bias":
        return "bias"
    owner = module.get_submodule(owner_name)
    if isinstance(owner, torch.nn.Embedding):
        return "embedding"
    if isinstance(owner, (torch.nn.GroupNorm, torch.nn.LayerNorm)):
        return "scale"
    return "kernel"


def excluded(module: torch.nn.Module, name: str, patterns: Sequence[str]) -> bool:
    """Whether a pattern is a component of the leaf's path, the path being
    the module names as the JAX trainer nests them (``down_blocks_0``,
    ``to_out``; CLIP without ``text_model``, ``embeddings`` and
    ``encoder``) and the leaf's kind last."""
    owner, _, _ = name.rpartition(".")
    parts = owner.split(".") if owner else []
    if parts[:1] == ["text_model"]:
        parts = parts[1:]
        if parts[:1] in (["embeddings"], ["encoder"]):
            parts = parts[1:]
    path: List[str] = []
    for part in parts:
        if part.isdigit():
            if path and path[-1] != "to_out":
                path[-1] = f"{path[-1]}_{part}"
        else:
            path.append(part)
    path.append(leaf_kind(module, name))
    return any(p in path for p in patterns)


class Lion8bit:
    """One model's chain and state, over ``params`` (updated in place)."""

    def __init__(self, module: torch.nn.Module, params: Dict[str, torch.Tensor], recipe: Dict, lr: float,
                 factor: float):
        self.params = params
        self.lr = lr
        self.decay = 1e-2 * factor
        self.bs = recipe["quant_block_size"]
        self.quantized = {n: not excluded(module, n, recipe["excluded_layer_from_quantization"])
                          for n in params}
        self.decayed = {n: not excluded(module, n, recipe["excluded_layer_pattern_from_weight_decay"])
                        for n in params}
        self.mu: Dict[str, object] = {}
        for n, p in params.items():
            if self.quantized[n]:
                nb = p.numel() // self.bs
                codes = torch.full((nb, self.bs), int(quantize(torch.zeros(()))), dtype=torch.int8, device=p.device)
                self.mu[n] = (codes, torch.ones(nb, dtype=torch.float32, device=p.device))
            else:
                self.mu[n] = torch.zeros_like(p, dtype=torch.float32)

    def momentum(self, name: str) -> torch.Tensor:
        """The f32 momentum of one leaf (in the JAX flat order if quantized)."""
        m = self.mu[name]
        return dequantize(*m).reshape(-1) if isinstance(m, tuple) else m

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], norm: torch.Tensor) -> None:
        """One update from this model's grads and the global norm."""
        for n, p in self.params.items():
            g = grads[n]
            if norm >= 1.0:
                g = (g / norm.to(g.dtype)) * torch.tensor(1.0, dtype=g.dtype)
            m = self.mu[n]
            if isinstance(m, tuple):
                gj = jax_order(g).float()
                mu = dequantize(*m).reshape(-1)
                upd_j = torch.sign((1.0 - B1) * gj + B1 * mu).to(g.dtype)
                self.mu[n] = block_quantize((1.0 - B2) * gj + B2 * mu, self.bs)
                perm = {2: (1, 0), 4: (2, 3, 1, 0)}.get(g.dim())
                if perm:
                    shape = [g.shape[i] for i in perm]
                    inverse = [perm.index(i) for i in range(len(perm))]
                    upd = upd_j.reshape(shape).permute(*inverse)
                else:
                    upd = upd_j.reshape(g.shape)
            else:
                upd = torch.sign(torch.tensor(1.0 - B1, dtype=g.dtype) * g + B1 * m).to(
                    torch.promote_types(g.dtype, torch.float32))
                self.mu[n] = torch.tensor(1 - B2, dtype=g.dtype) * g + B2 * m
            if self.decayed[n]:
                upd = upd + torch.tensor(self.decay, dtype=p.dtype) * p
            upd = torch.tensor(-self.lr, dtype=upd.dtype) * upd
            p.copy_(p + upd)


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor], rate: float) -> None:
    for n, p in params.items():
        e = ema[n]
        e.copy_(torch.tensor(rate, dtype=e.dtype) * e + torch.tensor(1 - rate, dtype=p.dtype) * p)


class ReferenceTrainer:
    """The reference's models, optimizers and EMA, stepped on the batches
    and draws that the program was given."""

    def __init__(self, models: Dict, recipe: Dict, ema: Dict[str, Dict[str, torch.Tensor]],
                 num: Optional[Numerics] = None):
        """``ema``: the starting EMA of each model that keeps one, ``{model:
        {name: tensor}}`` (taken, not copied)."""
        self.models, self.recipe = models, recipe
        self.num = num or Numerics()
        device = models["unet"].conv_in.weight.device
        self.bar = alphas_cumprod(recipe["beta_scheduler"], device=device)
        self.trained = {"unet": dict(models["unet"].named_parameters())}
        if recipe["train_text_encoder"]:
            self.trained["text_encoder"] = dict(models["text"].named_parameters())
        owners = {"unet": models["unet"], "text_encoder": models.get("text")}
        # the trainer takes the scale factor 7 and both learning rates 1e-6,
        # whatever the recipe states
        factor = 7
        self.opt = {m: Lion8bit(owners[m], params, recipe, 1e-6 / factor, factor)
                    for m, params in self.trained.items()}
        self.ema = ema

    def step(self, batch: Dict, draws: Dict, block_rows: int) -> float:
        with self.num.products(self.models["unet"].conv_in.weight.dtype):
            loss, grads = loss_and_grads(self.models, self.trained, self.recipe, batch, draws, self.bar,
                                         block_rows)
        for m, opt in self.opt.items():
            norm = global_norm(list(grads[m].values()))
            opt.step(grads[m], norm)
        del grads
        for m, ema in self.ema.items():
            ema_update(ema, self.trained[m], self.recipe["ema_rate"])
        return float(loss)
