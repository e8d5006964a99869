"""SDXL text-to-image pipeline: two text towers and micro-conditioning.

Port of ``stable_diffusion_training_tpu/pipeline/sdxl.py``. The UNet is
conditioned on the concatenated penultimate hidden states of both towers
(768 + 1280 = 2048 channels for SDXL), on the pooled, projected embedding of
the second tower, and on the size and crop ``time_ids`` ``[h, w, crop_top,
crop_left, h, w]``; the CFG batch is ``[negative, text]``. The denoise loop
and the decode are the SD pipeline's. The JAX package decodes one sample at
a time at 768² and above to steer XLA's convolutions; the result is the
same, so the port decodes the batch at once.
"""

import os
from typing import Dict, Optional, Tuple

import torch

from ..diffusion import DDIMScheduler
from ..models import hf_io
from .stable_diffusion import StableDiffusionPipeline, load_tokenizer, write_model_index

_MODEL_INDEX = {
    "_class_name": "FlaxStableDiffusionXLPipeline",
    "_diffusers_version": "0.21.4",
    "scheduler": ["diffusers", "FlaxDDIMScheduler"],
    "text_encoder": ["transformers", "FlaxCLIPTextModel"],
    "text_encoder_2": ["transformers", "FlaxCLIPTextModelWithProjection"],
    "tokenizer": ["transformers", "CLIPTokenizer"],
    "tokenizer_2": ["transformers", "CLIPTokenizer"],
    "unet": ["diffusers", "FlaxUNet2DConditionModel"],
    "vae": ["diffusers", "FlaxAutoencoderKL"],
}


class StableDiffusionXLPipeline(StableDiffusionPipeline):
    """text_encoder + text_encoder_2 + vae + unet + scheduler (+ optional
    tokenizers)."""

    def __init__(
        self, text_encoder, text_encoder_2, vae, unet, scheduler, tokenizer=None, tokenizer_2=None
    ):
        super().__init__(text_encoder, vae, unet, scheduler, tokenizer)
        self.text_encoder_2 = text_encoder_2
        self.tokenizer_2 = tokenizer_2

    @classmethod
    def from_pretrained(
        cls, directory: str, device=None, dtype=torch.float32, attention_backend: str = "auto"
    ) -> "StableDiffusionXLPipeline":
        """Load an SDXL diffusers-layout directory (as the JAX package's
        ``save_pretrained`` writes it): the SD folders plus
        ``text_encoder_2/`` and, when present, ``tokenizer_2/``."""
        unet = hf_io.load_unet(os.path.join(directory, "unet"), device, dtype, attention_backend)
        vae = hf_io.load_vae(os.path.join(directory, "vae"), device, dtype, attention_backend)
        text_encoder = hf_io.load_text_encoder(
            os.path.join(directory, "text_encoder"), device, dtype
        )
        text_encoder_2 = hf_io.load_text_encoder_2(
            os.path.join(directory, "text_encoder_2"), device, dtype
        )
        scheduler = DDIMScheduler.from_config(
            DDIMScheduler.load_config(directory, subfolder="scheduler"), device=unet.device
        )
        return cls(
            text_encoder, text_encoder_2, vae, unet, scheduler,
            load_tokenizer(directory, "tokenizer"), load_tokenizer(directory, "tokenizer_2"),
        )

    def save_pretrained(self, save_directory: str) -> None:
        super().save_pretrained(save_directory)
        self._save_tower_2(save_directory)
        write_model_index(save_directory, _MODEL_INDEX)

    def _save_tower_2(self, save_directory: str) -> None:
        hf_io.save_text_encoder(self.text_encoder_2, os.path.join(save_directory, "text_encoder_2"))
        if self.tokenizer_2 is not None:
            self.tokenizer_2.save_pretrained(os.path.join(save_directory, "tokenizer_2"))

    @torch.no_grad()
    def encode_prompt_pair(
        self, prompt_ids: torch.Tensor, prompt_2_ids: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both towers' penultimate hidden states, concatenated on the
        channel axis, and tower 2's pooled, projected embedding."""
        hidden_1 = self.text_encoder(prompt_ids, output_hidden_states=True).hidden_states[-2]
        out_2 = self.text_encoder_2(prompt_2_ids, output_hidden_states=True)
        return torch.cat([hidden_1, out_2.hidden_states[-2]], dim=-1), out_2.text_embeds

    @torch.no_grad()
    def encode_prompt(
        self,
        prompt_ids: torch.Tensor,
        neg_prompt_ids: Optional[torch.Tensor] = None,
        prompt_2_ids: Optional[torch.Tensor] = None,
        neg_prompt_2_ids: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """CFG context ``(2B, S, C)`` and pooled embeddings ``(2B, P)``, both
        ``[negative, text]``. ``prompt_2_ids`` defaults to ``prompt_ids``,
        ``neg_prompt_2_ids`` to the negative ids."""
        neg_prompt_ids = self._negative_ids(prompt_ids, neg_prompt_ids)
        if prompt_2_ids is None:
            prompt_2_ids = prompt_ids
        if neg_prompt_2_ids is None:
            neg_prompt_2_ids = neg_prompt_ids
        context_text, pooled_text = self.encode_prompt_pair(prompt_ids, prompt_2_ids)
        context_neg, pooled_neg = self.encode_prompt_pair(neg_prompt_ids, neg_prompt_2_ids)
        return torch.cat([context_neg, context_text]), torch.cat([pooled_neg, pooled_text])

    def _time_ids(
        self, batch_size: int, height: int, width: int, crops_coords_top_left=(0, 0)
    ) -> torch.Tensor:
        """``(2B, 6)`` f32 micro-conditioning: original size, crop, target
        size."""
        ids = torch.tensor(
            [[height, width, *crops_coords_top_left, height, width]],
            dtype=torch.float32, device=self.device,
        )
        return ids.expand(2 * batch_size, 6)

    @torch.no_grad()
    def __call__(
        self,
        prompt_ids: torch.Tensor,
        num_inference_steps: int = 50,
        height: Optional[int] = None,
        width: Optional[int] = None,
        guidance_scale: float = 5.0,
        latents: Optional[torch.Tensor] = None,
        neg_prompt_ids: Optional[torch.Tensor] = None,
        prompt_2_ids: Optional[torch.Tensor] = None,
        neg_prompt_2_ids: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, object]:
        """Generate images, as the SD pipeline does, conditioned on both
        prompts. Returns ``{"images": (B, H, W, 3) f32 in [0, 1],
        "nsfw_content_detected": False}``."""
        height, width = self._image_size(height, width)
        context, pooled = self.encode_prompt(
            prompt_ids, neg_prompt_ids, prompt_2_ids, neg_prompt_2_ids
        )
        added_cond = {
            "text_embeds": pooled,
            "time_ids": self._time_ids(prompt_ids.shape[0], height, width),
        }
        latents = self.prepare_latents(prompt_ids.shape[0], height, width, latents, generator)
        latents = self.denoise(latents, context, num_inference_steps, guidance_scale, added_cond)
        return {"images": self.decode_latents(latents), "nsfw_content_detected": False}
