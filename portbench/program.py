"""The system under test: the port's train step, built through its normal
entry (``train.states.on_device_model_training_state``) and called as the
trainer's loop calls it.

``Program`` owns the states; ``step(batch, draws)`` enqueues one step and
returns its loss tensor without waiting for the device. SD1.5's cells call
``train.train_step.train_step`` with the configuration's options; a cell
whose recipe uses the latent cache calls the step table of
``train.aot.bucket_train_steps``, picked by ``batch_dispatch_key``, as the
trainer does. The port is imported only here, and only when a run builds
it.
"""

from typing import Dict

import torch

from .traffic import tiers


def training_config_fields(config: Dict, traffic: Dict) -> Dict:
    """The ``TrainingConfig`` of a cell: the configuration's recipe at the
    traffic's precision, batch and bucket tiers."""
    return {
        **config["recipe"],
        "mixed_precision": traffic["mixed_precision"],
        "batch_size": traffic["batch_size"],
        "image_area_root": [area for area, _ in tiers(traffic)],
        "minimum_axis_length": [axis for _, axis in tiers(traffic)],
    }


class Program:
    def __init__(self, config: Dict, traffic: Dict, device):
        from stable_diffusion_training_tpu_torch import train

        self.config, self.traffic = config, traffic
        self.cfg = train.TrainingConfig(**training_config_fields(config, traffic))
        (self.unet_state, self.text_state, self.unet_ema, self.text_ema,
         self.frozen_vae, self.frozen_sched, self.models) = train.on_device_model_training_state(self.cfg, device)
        if self.cfg.use_latent_cache:
            table = train.bucket_train_steps(self.cfg, self.frozen_vae)
            key_of = train.batch_dispatch_key
            self._call = lambda *args, draws: table[key_of(args[4])](*args, draws=draws)
        else:
            cfg = self.cfg
            options = dict(
                strip_bos_eos_token=cfg.strip_bos_eos_token, offset_noise_magnitude=cfg.offset_noise_magnitude,
                min_snr_gamma_magnitude=cfg.min_snr_gamma_magnitude,
                perturbation_noise_magnitude=cfg.perturbation_noise_magnitude, ema_rate=cfg.ema_rate,
                text_context_window=cfg.text_encoder_context_window,
                grad_accumulation_steps=cfg.grad_accumulation_steps, train_text_encoder=cfg.train_text_encoder,
                vae_encode_chunk=cfg.vae_encode_chunk,
            )
            self._call = lambda *args, draws: train.train_step(*args, draws=draws, **options)

    def modules(self) -> Dict[str, torch.nn.Module]:
        return {"unet": self.models["unet"], "text": self.models["text_encoder"], "vae": self.models["vae"]}

    @torch.no_grad()
    def load_weights(self, weights: Dict[str, Dict[str, torch.Tensor]],
                     ema: Dict[str, Dict[str, torch.Tensor]]) -> None:
        """Copy ``{module: {name: tensor}}`` into the port's parameters, and
        ``{model: {name: tensor}}`` into its EMA copies (one for each model
        that keeps an EMA)."""
        for key, named in weights.items():
            _copy_into(dict(self.modules()[key].named_parameters()), named, key)
        if set(ema) != set(self.ema()):
            raise ValueError(f"the port keeps an EMA of {sorted(self.ema())}, the benchmark made {sorted(ema)}")
        for model, named in ema.items():
            _copy_into(self.ema()[model], named, f"{model} EMA", whole=True)

    def step(self, batch: Dict, draws: Dict) -> torch.Tensor:
        out = self._call(self.unet_state, self.text_state, self.unet_ema, self.text_ema, batch, None,
                         self.frozen_vae, self.frozen_sched, draws=draws)
        return out[4]["loss"]

    def trained(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """``{model: {name: parameter}}`` of the trained models."""
        out = {"unet": self.unet_state.params}
        if self.cfg.train_text_encoder:
            out["text_encoder"] = self.text_state.params
        return out

    def ema(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """``{model: {name: EMA tensor}}`` of the models that keep an EMA."""
        out = {"unet": self.unet_ema, "text_encoder": self.text_ema}
        return {m: e for m, e in out.items() if e is not None}

    @torch.no_grad()
    def momentum_norms(self) -> Dict[str, Dict[str, float]]:
        """Each trained leaf's momentum norm, read from its optimizer state:
        the codes and scales of a quantized leaf dequantized
        (``reference.train.dequantize``, the compander that the recipe
        states), an f32 momentum as it is."""
        from .reference.train import dequantize

        out = {}
        for model, state in (("unet", self.unet_state), ("text_encoder", self.text_state)):
            if model not in self.trained():
                continue
            mu = _find_momentum(state.opt_state, set(state.params))
            norms = {}
            for name, m in mu.items():
                value = dequantize(m.codes, m.scales) if hasattr(m, "codes") else m
                norms[name] = float(torch.linalg.vector_norm(value.float()))
            out[model] = norms
        return out

    def free(self) -> None:
        for name in ("unet_state", "text_state", "unet_ema", "text_ema", "frozen_vae", "frozen_sched",
                     "models", "_call"):
            setattr(self, name, None)


def _copy_into(dest: Dict[str, torch.Tensor], named: Dict[str, torch.Tensor], what: str, whole: bool = False) -> None:
    """Copy ``named`` into ``dest`` by name: into some of its leaves, or
    into each of them if ``whole``."""
    if not set(named) <= set(dest) or (whole and set(named) != set(dest)):
        raise ValueError(f"{what}: the benchmark's leaves are not the port's: "
                         f"{sorted(set(named) ^ set(dest))[:4]}")
    for name, w in named.items():
        if dest[name].shape != w.shape:
            raise ValueError(f"{what}.{name}: the port holds {tuple(dest[name].shape)}, "
                             f"the benchmark made {tuple(w.shape)}")
        dest[name].copy_(w)


def _find_momentum(tree, names: set) -> Dict:
    """The first dict in an optimizer state whose keys are the model's leaf
    names: the Lion momentum (the clip and the decay keep none)."""
    stack = [tree]
    while stack:
        node = stack.pop(0)
        if isinstance(node, dict) and set(node) == names and all(
                torch.is_tensor(v) or hasattr(v, "codes") for v in node.values()):
            return node
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (tuple, list)):
            stack.extend(node)
        elif hasattr(node, "_fields"):
            stack.extend(getattr(node, f) for f in node._fields)
    raise LookupError("no momentum keyed by the model's leaves in its optimizer state")


@torch.no_grad()
def change_norms(now: Dict[str, torch.Tensor], before: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(now[n].float() - before[n].float())) for n in now}


@torch.no_grad()
def clone_all(named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: t.detach().clone() for n, t in named.items()}
