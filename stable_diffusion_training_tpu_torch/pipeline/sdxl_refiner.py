"""SDXL refiner: image-to-image from a noised encoding of an input image.

Port of ``stable_diffusion_training_tpu/pipeline/sdxl_refiner.py``. The
refiner checkpoint conditions on the second text tower only (its
penultimate hidden states, 1280 channels, and its pooled embedding) and has
no ``text_encoder`` or ``tokenizer``; its micro-conditioning replaces the
target size with an aesthetic score (5 time ids, the negative score on the
negative half). ``strength`` picks how much of the DDIM schedule runs again:
the image is VAE-encoded, sampled, scaled, noised to
``timesteps[start_step]`` and denoised from there.

The two random draws (the latent sample's eps, then the noise) come from a
``torch.Generator`` on the pipeline's device, or are passed in
(``sample_eps=``, ``noise=``): the tests feed the JAX package's
``jax.random.split(prng_seed)`` draws through that seam.
"""

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..diffusion import DDIMScheduler
from ..models import hf_io
from .sdxl import StableDiffusionXLPipeline
from .stable_diffusion import load_tokenizer, write_model_index


def prepare_image(image) -> torch.Tensor:
    """A PIL image, a uint8 array or a float array in ``[0, 1]`` (NHWC or
    HWC) -> the pipeline's NCHW f32 in ``[-1, 1]``, on the CPU."""
    arr = np.asarray(image)
    if arr.ndim == 3:
        arr = arr[None]
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    arr = arr.astype(np.float32) * 2.0 - 1.0
    return torch.from_numpy(np.ascontiguousarray(arr.transpose(0, 3, 1, 2)))


def start_step_for(strength: float, num_inference_steps: int) -> int:
    """The first of ``num_inference_steps`` that img2img runs at
    ``strength``; the JAX package's checks and messages."""
    if not 0.0 < strength <= 1.0:
        raise ValueError(f"strength must be in (0, 1], got {strength}")
    init_timestep = min(int(num_inference_steps * strength), num_inference_steps)
    if init_timestep < 1:
        raise ValueError(
            f"strength={strength} runs no denoise steps at "
            f"num_inference_steps={num_inference_steps}; use strength "
            f">= {1.0 / num_inference_steps:.4f} or more steps"
        )
    return max(num_inference_steps - init_timestep, 0)


class StableDiffusionXLImg2ImgPipeline(StableDiffusionXLPipeline):
    """The SDXL refiner (``text_encoder`` None: tower 2 alone), or an SDXL
    base checkpoint driven as img2img (both towers)."""

    def __init__(
        self,
        text_encoder,
        text_encoder_2,
        vae,
        unet,
        scheduler,
        tokenizer=None,
        tokenizer_2=None,
        requires_aesthetics_score: bool = True,
    ):
        super().__init__(text_encoder, text_encoder_2, vae, unet, scheduler, tokenizer, tokenizer_2)
        self.requires_aesthetics_score = requires_aesthetics_score

    @classmethod
    def from_pretrained(
        cls, directory: str, device=None, dtype=torch.float32, attention_backend: str = "auto"
    ) -> "StableDiffusionXLImg2ImgPipeline":
        """Load a refiner directory (no ``text_encoder/`` or ``tokenizer/``),
        or a base one. ``requires_aesthetics_score`` is True without a first
        tower unless ``model_index.json`` says otherwise."""
        unet = hf_io.load_unet(os.path.join(directory, "unet"), device, dtype, attention_backend)
        vae = hf_io.load_vae(os.path.join(directory, "vae"), device, dtype, attention_backend)
        text_encoder_2 = hf_io.load_text_encoder_2(
            os.path.join(directory, "text_encoder_2"), device, dtype
        )
        scheduler = DDIMScheduler.from_config(
            DDIMScheduler.load_config(directory, subfolder="scheduler"), device=unet.device
        )
        te1_dir = os.path.join(directory, "text_encoder")
        text_encoder = (
            hf_io.load_text_encoder(te1_dir, device, dtype) if os.path.isdir(te1_dir) else None
        )
        requires_aesthetics_score = text_encoder is None
        index_path = os.path.join(directory, "model_index.json")
        if os.path.isfile(index_path):
            with open(index_path) as f:
                requires_aesthetics_score = bool(
                    json.load(f).get("requires_aesthetics_score", requires_aesthetics_score)
                )
        return cls(
            text_encoder, text_encoder_2, vae, unet, scheduler,
            load_tokenizer(directory, "tokenizer"), load_tokenizer(directory, "tokenizer_2"),
            requires_aesthetics_score=requires_aesthetics_score,
        )

    def save_pretrained(self, save_directory: str) -> None:
        """The refiner's diffusers layout (the base's when a first tower is
        present), with ``requires_aesthetics_score`` in
        ``model_index.json``."""
        super().save_pretrained(save_directory)
        index = {
            "_class_name": "FlaxStableDiffusionXLImg2ImgPipeline",
            "_diffusers_version": "0.21.4",
            "requires_aesthetics_score": self.requires_aesthetics_score,
            "scheduler": ["diffusers", "FlaxDDIMScheduler"],
            "text_encoder_2": ["transformers", "FlaxCLIPTextModelWithProjection"],
            "tokenizer_2": ["transformers", "CLIPTokenizer"],
            "unet": ["diffusers", "FlaxUNet2DConditionModel"],
            "vae": ["diffusers", "FlaxAutoencoderKL"],
        }
        if self.text_encoder is not None:
            index["text_encoder"] = ["transformers", "FlaxCLIPTextModel"]
            index["tokenizer"] = ["transformers", "CLIPTokenizer"]
        write_model_index(save_directory, index)

    def _uncond_tokenizer(self):
        return self.tokenizer_2 if self.tokenizer is None else self.tokenizer

    @torch.no_grad()
    def encode_prompt_pair(
        self, prompt_ids: torch.Tensor, prompt_2_ids: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Tower 2's penultimate hidden states and pooled embedding; both
        towers' when the pipeline has a first one."""
        if self.text_encoder is not None:
            return super().encode_prompt_pair(prompt_ids, prompt_2_ids)
        out_2 = self.text_encoder_2(prompt_2_ids, output_hidden_states=True)
        return out_2.hidden_states[-2], out_2.text_embeds

    def _time_ids(
        self,
        batch_size: int,
        height: int,
        width: int,
        crops_coords_top_left=(0, 0),
        aesthetic_score: float = 6.0,
        negative_aesthetic_score: float = 2.5,
    ) -> torch.Tensor:
        """``(2B, 5)`` f32 ``[h, w, crop_top, crop_left, score]``, the
        negative half with the negative score; the base's ``(2B, 6)`` ids
        when the UNet was trained without aesthetics."""
        if not self.requires_aesthetics_score:
            return super()._time_ids(batch_size, height, width, crops_coords_top_left)
        ids = torch.tensor(
            [[height, width, *crops_coords_top_left, negative_aesthetic_score],
             [height, width, *crops_coords_top_left, aesthetic_score]],
            dtype=torch.float32, device=self.device,
        )
        return ids.repeat_interleave(batch_size, dim=0)

    @torch.no_grad()
    def prepare_image_latents(
        self,
        image: torch.Tensor,
        start_step: int,
        num_inference_steps: int,
        generator: Optional[torch.Generator] = None,
        sample_eps: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """The loop's start: the image's latent sample (``sample_eps`` or a
        draw from ``generator`` in the VAE's dtype) in f32 times the VAE's
        ``scaling_factor``, noised (``noise`` or the next draw, f32) to
        ``timesteps[start_step]``."""
        dist = self.vae.encode(image.to(self.device, self.vae.dtype)).latent_dist
        mean = dist.mean
        if sample_eps is None:
            sample_eps = torch.randn(mean.shape, generator=generator, device=self.device, dtype=mean.dtype)
        init_latents = (mean + dist.std * sample_eps.to(self.device, mean.dtype)).float()
        init_latents = init_latents * self.vae.config.scaling_factor
        if noise is None:
            noise = torch.randn(init_latents.shape, generator=generator, device=self.device)
        state = self.scheduler.set_timesteps(self.scheduler_state, num_inference_steps)
        tables = state.common.alphas_cumprod.device
        timesteps = state.timesteps[start_step].to(tables).expand(init_latents.shape[0])
        return self.scheduler.add_noise(state, init_latents, noise.to(self.device), timesteps)

    @torch.no_grad()
    def __call__(
        self,
        prompt_ids: torch.Tensor,
        image: torch.Tensor,
        strength: float = 0.3,
        num_inference_steps: int = 50,
        guidance_scale: float = 5.0,
        neg_prompt_ids: Optional[torch.Tensor] = None,
        prompt_2_ids: Optional[torch.Tensor] = None,
        neg_prompt_2_ids: Optional[torch.Tensor] = None,
        aesthetic_score: float = 6.0,
        negative_aesthetic_score: float = 2.5,
        generator: Optional[torch.Generator] = None,
        sample_eps: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> Dict[str, object]:
        """Refine ``image`` (NCHW f32 in ``[-1, 1]``; see ``prepare_image``).
        ``strength`` 0.3 keeps most of it, 1.0 redraws it from almost pure
        noise. Returns ``{"images": (B, H, W, 3) f32 in [0, 1],
        "nsfw_content_detected": False}``."""
        start_step = start_step_for(strength, num_inference_steps)
        batch_size = prompt_ids.shape[0]
        height, width = image.shape[2], image.shape[3]
        context, pooled = self.encode_prompt(
            prompt_ids, neg_prompt_ids, prompt_2_ids, neg_prompt_2_ids
        )
        added_cond = {
            "text_embeds": pooled,
            "time_ids": self._time_ids(
                batch_size, height, width, (0, 0), aesthetic_score, negative_aesthetic_score
            ),
        }
        latents = self.prepare_image_latents(
            image, start_step, num_inference_steps, generator, sample_eps, noise
        )
        latents = self.denoise(
            latents, context, num_inference_steps, guidance_scale, added_cond, start_step
        )
        return {"images": self.decode_latents(latents), "nsfw_content_detected": False}
