"""Text-to-image pipeline: CLIP text encoding, classifier-free-guided DDIM
denoise loop, VAE decode.

Port of ``stable_diffusion_training_tpu/pipeline/stable_diffusion.py``:
the CFG batch is ``[uncond, text]``, latents are scaled by
``init_noise_sigma``, the UNet's prediction is cast to f32 before the CFG
combine and the scheduler step, the decode divides by the VAE's
``scaling_factor``, and images come out NHWC in ``[0, 1]``. The loop is a
Python loop (PyTorch runs eagerly); timesteps are read as ints on the host.
``save_pretrained`` writes the diffusers layout that ``from_pretrained``
(and the JAX package's) reads.
"""

import json
import os
from typing import Dict, Optional

import torch

from ..diffusion import DDIMScheduler
from ..models import hf_io

_MODEL_INDEX = {
    "_class_name": "FlaxStableDiffusionPipeline",
    "_diffusers_version": "0.21.4",
    "scheduler": ["diffusers", "FlaxDDIMScheduler"],
    "text_encoder": ["transformers", "FlaxCLIPTextModel"],
    "tokenizer": ["transformers", "CLIPTokenizer"],
    "unet": ["diffusers", "FlaxUNet2DConditionModel"],
    "vae": ["diffusers", "FlaxAutoencoderKL"],
}


def load_tokenizer(directory: str, subfolder: str):
    """transformers' ``CLIPTokenizer`` from ``directory/subfolder``, or None
    when the checkpoint has no such folder."""
    tok_dir = os.path.join(directory, subfolder)
    if not os.path.isdir(tok_dir):
        return None
    from transformers import CLIPTokenizer

    return CLIPTokenizer.from_pretrained(tok_dir)


def write_model_index(directory: str, index: Dict[str, object]) -> None:
    with open(os.path.join(directory, "model_index.json"), "w") as f:
        json.dump(index, f, indent=2, sort_keys=True)


class StableDiffusionPipeline:
    """text_encoder + vae + unet + scheduler (+ an optional tokenizer)."""

    def __init__(self, text_encoder, vae, unet, scheduler, tokenizer=None):
        self.text_encoder = text_encoder
        self.vae = vae
        self.unet = unet
        self.scheduler = scheduler
        self.tokenizer = tokenizer
        self.vae_scale_factor = 2 ** (len(vae.config.block_out_channels) - 1)
        self.scheduler_state = scheduler.create_state()

    @property
    def device(self) -> torch.device:
        return self.unet.device

    @property
    def dtype(self) -> torch.dtype:
        return self.unet.dtype

    @classmethod
    def from_pretrained(
        cls, directory: str, device=None, dtype=torch.float32, attention_backend: str = "auto"
    ) -> "StableDiffusionPipeline":
        """Load a diffusers-layout checkpoint directory (as the JAX package's
        ``save_pretrained`` writes it). A ``tokenizer/`` folder is loaded
        with transformers' ``CLIPTokenizer`` when present."""
        unet = hf_io.load_unet(os.path.join(directory, "unet"), device, dtype, attention_backend)
        vae = hf_io.load_vae(os.path.join(directory, "vae"), device, dtype, attention_backend)
        text_encoder = hf_io.load_text_encoder(
            os.path.join(directory, "text_encoder"), device, dtype
        )
        scheduler = DDIMScheduler.from_config(
            DDIMScheduler.load_config(directory, subfolder="scheduler"), device=unet.device
        )
        return cls(text_encoder, vae, unet, scheduler, load_tokenizer(directory, "tokenizer"))

    def save_pretrained(self, save_directory: str) -> None:
        """Write the pipeline in diffusers layout: the scheduler as
        configured, each model's config and f32 weights, the tokenizer when
        there is one, ``model_index.json``."""
        os.makedirs(save_directory, exist_ok=True)
        self.scheduler.save_config(os.path.join(save_directory, "scheduler"))
        hf_io.save_model_folder(self.unet, os.path.join(save_directory, "unet"))
        hf_io.save_model_folder(self.vae, os.path.join(save_directory, "vae"))
        if self.text_encoder is not None:
            hf_io.save_text_encoder(self.text_encoder, os.path.join(save_directory, "text_encoder"))
        if self.tokenizer is not None:
            self.tokenizer.save_pretrained(os.path.join(save_directory, "tokenizer"))
        write_model_index(save_directory, _MODEL_INDEX)

    def _uncond_tokenizer(self):
        return self.tokenizer

    def _negative_ids(
        self, prompt_ids: torch.Tensor, neg_prompt_ids: Optional[torch.Tensor]
    ) -> torch.Tensor:
        """``neg_prompt_ids``, or the empty prompt tokenized to the prompt's
        length, which needs a tokenizer."""
        if neg_prompt_ids is not None:
            return neg_prompt_ids
        tokenizer = self._uncond_tokenizer()
        if tokenizer is None:
            raise ValueError("neg_prompt_ids is required when the pipeline has no tokenizer")
        batch_size, max_length = prompt_ids.shape
        return tokenizer(
            [""] * batch_size, padding="max_length", max_length=max_length, return_tensors="pt",
        ).input_ids.to(self.device)

    @torch.no_grad()
    def encode_prompt(
        self, prompt_ids: torch.Tensor, neg_prompt_ids: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """CFG context ``[uncond, text]``, ``(2B, S, C)``. Without negative
        ids the empty prompt is tokenized, which needs a tokenizer."""
        neg_prompt_ids = self._negative_ids(prompt_ids, neg_prompt_ids)
        prompt_embeds = self.text_encoder(prompt_ids)[0]
        negative_embeds = self.text_encoder(neg_prompt_ids)[0]
        return torch.cat([negative_embeds, prompt_embeds])

    @torch.no_grad()
    def denoise(
        self,
        latents: torch.Tensor,
        context: torch.Tensor,
        num_inference_steps: int,
        guidance_scale: float,
        added_cond_kwargs: Optional[Dict[str, torch.Tensor]] = None,
        start_step: int = 0,
    ) -> torch.Tensor:
        """The CFG DDIM loop from NCHW f32 latents (already scaled by
        ``init_noise_sigma``, or noised to ``timesteps[start_step]``) to the
        final latents, over the schedule's steps from ``start_step`` on.
        ``added_cond_kwargs`` goes to the UNet unchanged (SDXL)."""
        state = self.scheduler.set_timesteps(self.scheduler_state, num_inference_steps)
        for t in state.timesteps[start_step:].tolist():
            latents_input = torch.cat([latents] * 2)
            latents_input = self.scheduler.scale_model_input(state, latents_input, t)
            t_vec = torch.full((latents_input.shape[0],), t, dtype=torch.int32, device=latents.device)
            noise_pred = self.unet(
                latents_input.to(self.dtype), t_vec, context, added_cond_kwargs
            ).float()
            noise_uncond, noise_text = noise_pred.chunk(2)
            noise_pred = noise_uncond + guidance_scale * (noise_text - noise_uncond)
            latents = self.scheduler.step(state, noise_pred, t, latents).prev_sample
        return latents

    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents -> NHWC f32 images in ``[0, 1]``."""
        latents = latents / self.vae.config.scaling_factor
        image = self.vae.decode(latents.to(self.vae.dtype)).sample
        image = image.float().permute(0, 2, 3, 1)
        return (image / 2 + 0.5).clamp(0, 1)

    @torch.no_grad()
    def __call__(
        self,
        prompt_ids: torch.Tensor,
        num_inference_steps: int = 50,
        height: Optional[int] = None,
        width: Optional[int] = None,
        guidance_scale: float = 7.5,
        latents: Optional[torch.Tensor] = None,
        neg_prompt_ids: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, object]:
        """Generate images. ``latents`` (NCHW, f32) override the initial
        noise, which is otherwise drawn from ``generator`` on the pipeline's
        device. Returns ``{"images": (B, H, W, 3) f32 in [0, 1],
        "nsfw_content_detected": False}``."""
        height, width = self._image_size(height, width)
        context = self.encode_prompt(prompt_ids, neg_prompt_ids)
        latents = self.prepare_latents(prompt_ids.shape[0], height, width, latents, generator)
        latents = self.denoise(latents, context, num_inference_steps, guidance_scale)
        # the NSFW checker is stubbed out, as in the JAX package
        return {"images": self.decode_latents(latents), "nsfw_content_detected": False}

    def _image_size(self, height: Optional[int], width: Optional[int]):
        height = height or self.unet.config.sample_size * self.vae_scale_factor
        width = width or self.unet.config.sample_size * self.vae_scale_factor
        if height % 8 != 0 or width % 8 != 0:
            raise ValueError(f"`height`/`width` must be multiples of 8: {height}, {width}")
        return height, width

    def prepare_latents(
        self,
        batch_size: int,
        height: int,
        width: int,
        latents: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """The loop's start: ``latents`` (NCHW) or noise drawn from
        ``generator`` on the pipeline's device, f32, times
        ``init_noise_sigma``."""
        shape = (
            batch_size,
            self.unet.config.in_channels,
            height // self.vae_scale_factor,
            width // self.vae_scale_factor,
        )
        if latents is None:
            latents = torch.randn(shape, generator=generator, device=self.device)
        elif tuple(latents.shape) != shape:
            raise ValueError(f"Unexpected latents shape, got {tuple(latents.shape)}, expected {shape}")
        return latents.to(self.device, torch.float32) * self.scheduler_state.init_noise_sigma
