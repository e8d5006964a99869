"""Periodic DDIM eval sampling inside the training loop.

Port of ``stable_diffusion_training_tpu/train/eval_sampler.py`` (BASELINE
config 2: "DDIM eval sampling every N steps"; the reference trainer has no
in-loop eval). Config keys (all optional, in the raw config dict):

- ``eval_sample_interval``: sample every N train steps (0/absent = off);
- ``eval_sample_prompts``: prompt strings, tokenized with the run's
  tokenizer, or ``eval_sample_prompt_ids``: id rows for runs without one;
- ``eval_sample_dir``: output directory (default ``eval_samples``);
- ``eval_num_inference_steps`` (default 20), ``eval_guidance_scale``
  (default 7.5), ``eval_sample_resolution`` (default: the UNet's
  ``sample_size`` times the VAE's factor);
- a refiner UNet (``sdxl_time_ids_count != 6``) has no text-to-image path:
  ``eval_sample_images`` (image paths or a directory) turns on img2img
  eval instead, the live UNet refining the fixed images at
  ``eval_refine_strength`` (default 0.3).

The pipeline follows the UNet: ``StableDiffusionPipeline`` for ``sd15``,
``sd21`` and the tiny families, ``StableDiffusionXLPipeline`` for an SDXL
UNet and ``StableDiffusionXLImg2ImgPipeline`` for a refiner. SDXL's tower 2
stays out of the train state: it is loaded here, for eval only, from
``model_path/text_encoder_2`` or built from the model family with seeded
weights. The scheduler is DDIM with the run's betas and prediction type.
Images come from the live weights (the models the train step updates in
place, not the EMA), under ``torch.no_grad`` with the models in eval mode
(their modes are restored after the call), and are written as PNGs under
``eval_sample_dir/step_<N>/`` with the ``eval/sample_mean`` scalar.

Random draws come from a ``torch.Generator`` on the run's device seeded
with the config's ``master_seed`` and the step; the initial latents (and
img2img's two draws) can be passed in instead, as the tests pass the JAX
package's. The port runs in one process, so the JAX module's gather of the
images across hosts has no counterpart here.
"""

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .states import _DTYPES


def save_png_images(images: np.ndarray, directory: str) -> list:
    """NHWC images in ``[0, 1]`` as ``sample_<i>.png`` (8-bit RGB, rounded
    as the JAX pipeline's ``numpy_to_pil``); returns the paths."""
    from PIL import Image

    os.makedirs(directory, exist_ok=True)
    paths = []
    for i, im in enumerate((np.asarray(images) * 255).round().astype("uint8")):
        path = os.path.join(directory, f"sample_{i}.png")
        Image.fromarray(im).save(path)
        paths.append(path)
    return paths


class EvalSampler:
    """Opt-in in-loop sampler; every call is a no-op when disabled."""

    def __init__(
        self,
        config_dict: Dict[str, Any],
        model_object_dict: Dict[str, Any],
        tokenizer: Optional[Any],
        metrics_writer: Optional[Any] = None,
        device=None,
    ):
        self.interval = int(config_dict.get("eval_sample_interval", 0) or 0)
        self._pipe = None
        self._prompt_ids = None
        self._neg_ids = None
        self._init_image = None
        self._img2img = False
        if not self.interval:
            return

        from ..diffusion import DDIMScheduler
        from ..pipeline import StableDiffusionPipeline

        self.device = resolve_device(device)
        self.out_dir = config_dict.get("eval_sample_dir", "eval_samples")
        self.num_steps = int(config_dict.get("eval_num_inference_steps", 20))
        self.guidance = float(config_dict.get("eval_guidance_scale", 7.5))
        self.resolution = config_dict.get("eval_sample_resolution")
        self.seed = int(config_dict.get("master_seed", 0))
        self.metrics_writer = metrics_writer

        # the run's noise schedule (betas and prediction type), so that eval
        # images come from the model's own process
        scheduler = DDIMScheduler(
            beta_start=0.00085,
            beta_end=0.012,
            beta_schedule=config_dict.get("beta_scheduler", "scaled_linear"),
            num_train_timesteps=1000,
            prediction_type=config_dict.get("prediction_type", "v_prediction"),
            device=self.device,
        )
        unet = model_object_dict["unet"]
        self._models = [m for m in (unet, model_object_dict.get("vae"), model_object_dict.get("text_encoder"))
                        if m is not None]
        if getattr(unet, "addition_embed_type", None) == "text_time":
            refiner = int(config_dict.get("sdxl_time_ids_count", 6)) != 6
            images_cfg = config_dict.get("eval_sample_images")
            if refiner and not images_cfg:
                # a refiner UNet (5 aesthetic-score ids) has no text-to-image
                # path, only img2img on fixed images from eval_sample_images
                print(
                    "eval sampling disabled: refiner-style UNet "
                    "(sdxl_time_ids_count != 6) has no text-to-image "
                    "path; set eval_sample_images for img2img eval"
                )
                self.interval = 0
                return
            te2, tokenizer_2 = self._load_text_encoder_2(config_dict, self.device)
            if refiner:
                from ..pipeline import StableDiffusionXLImg2ImgPipeline

                if te2 is None:
                    print("eval sampling disabled: refiner UNet but no text_encoder_2 found")
                    self.interval = 0
                    return
                self._refine_strength = float(config_dict.get("eval_refine_strength", 0.3))
                self._init_image = self._load_eval_images(images_cfg, self.resolution)
                # the refiner conditions on the second tower only
                self._pipe = StableDiffusionXLImg2ImgPipeline(
                    None, te2, model_object_dict["vae"], unet, scheduler, tokenizer, tokenizer_2,
                )
                self._img2img = True
                self._finish_prompts(config_dict, tokenizer)
                return
            from ..pipeline import StableDiffusionXLPipeline

            if te2 is None:
                print(
                    "eval sampling disabled: SDXL UNet but no text_encoder_2 "
                    "found (model_path has no text_encoder_2/ and the model "
                    "family defines none)"
                )
                self.interval = 0
                return
            self._pipe = StableDiffusionXLPipeline(
                model_object_dict["text_encoder"], te2, model_object_dict["vae"], unet, scheduler,
                tokenizer, tokenizer_2,
            )
        else:
            self._pipe = StableDiffusionPipeline(
                model_object_dict["text_encoder"], model_object_dict["vae"], unet, scheduler, tokenizer,
            )
        self._finish_prompts(config_dict, tokenizer)

    def _finish_prompts(self, config_dict, tokenizer):
        # a refiner checkpoint has no first-tower tokenizer: string prompts
        # then go through the second tower's
        tok = tokenizer or getattr(self._pipe, "tokenizer_2", None)

        def tokenize(texts):
            return np.asarray(
                tok(list(texts), padding="max_length", max_length=tok.model_max_length, truncation=True,
                    return_tensors="np").input_ids,
                np.int64,
            )

        prompts = config_dict.get("eval_sample_prompts")
        prompt_ids = config_dict.get("eval_sample_prompt_ids")
        if prompt_ids is not None:
            ids = np.asarray(prompt_ids, np.int64)
        elif prompts and tok is not None:
            ids = tokenize(prompts)
        else:
            # nothing to sample from: disabled rather than failing mid-run
            self.interval = 0
            self._pipe = None
            return
        self._prompt_ids = torch.from_numpy(ids).to(self.device)
        if tokenizer is None:
            # the pipeline has no first tokenizer to build the unconditional
            # branch: the empty prompt through the second tower's
            # tokenizer, else an all-pad row (id 0)
            neg = tokenize([""] * ids.shape[0]) if tok is not None else np.zeros_like(ids)
            self._neg_ids = torch.from_numpy(neg).to(self.device)
        if self._init_image is not None:
            # one base image per prompt row: tiled or cut to match
            b = ids.shape[0]
            img = self._init_image
            if img.shape[0] < b:
                img = np.tile(img, (-(-b // img.shape[0]), 1, 1, 1))
            self._init_image = torch.from_numpy(img[:b]).to(self.device)

    @staticmethod
    def _load_eval_images(images_cfg, resolution=None) -> np.ndarray:
        """The img2img base images, NCHW f32 in ``[-1, 1]``: a list of
        paths, one path or a directory of images; resized to
        ``resolution`` when set (else they must share one size)."""
        from PIL import Image

        from ..pipeline import prepare_image

        if isinstance(images_cfg, str) and os.path.isdir(images_cfg):
            paths = sorted(
                os.path.join(images_cfg, f)
                for f in os.listdir(images_cfg)
                if f.lower().endswith((".png", ".jpg", ".jpeg", ".webp"))
            )
        elif isinstance(images_cfg, str):
            paths = [images_cfg]
        else:
            paths = list(images_cfg)
        if not paths:
            raise ValueError(f"eval_sample_images matched no files: {images_cfg!r}")
        arrays = []
        for p in paths:
            with Image.open(p) as im:
                im = im.convert("RGB")
                if resolution:
                    im = im.resize((int(resolution), int(resolution)))
                arrays.append(prepare_image(im)[0].numpy())
        return np.stack(arrays)

    @staticmethod
    def _load_text_encoder_2(config_dict, device):
        """Tower 2 for SDXL eval: from ``model_path/text_encoder_2`` when
        ``model_path`` is a checkpoint directory, else built from the model
        family with weights seeded by ``seed_init``. Returns (model,
        tokenizer_2) or (None, None)."""
        from ..models import CLIPTextModelWithProjection, configs, hf_io, random_init_
        from ..pipeline.stable_diffusion import load_tokenizer

        dtype = _DTYPES[config_dict.get("mixed_precision", "bfloat16")]
        model_dir = config_dict["model_path"]
        te2_dir = os.path.join(model_dir, "text_encoder_2")
        if os.path.isdir(te2_dir):
            try:
                tokenizer_2 = load_tokenizer(model_dir, "tokenizer_2")
            except (ImportError, OSError, ValueError):  # a checkpoint's tokenizer is optional here
                tokenizer_2 = None
            return hf_io.load_text_encoder_2(te2_dir, device, dtype), tokenizer_2
        fam_name = model_dir if model_dir in configs.MODEL_FAMILIES else config_dict.get("model_family")
        fam = configs.MODEL_FAMILIES.get(fam_name, {})
        if "text_encoder_2" not in fam:
            return None, None
        te2 = CLIPTextModelWithProjection(**fam["text_encoder_2"], device=device, dtype=dtype)
        random_init_(te2, torch.Generator(device).manual_seed(int(config_dict.get("seed_init", 0))))
        return te2.requires_grad_(False), None

    @property
    def active(self) -> bool:
        return bool(self.interval)

    def generator(self, step: int) -> torch.Generator:
        """The draws of the call at ``step``: seeded with the run's seed and
        the step, so sampling takes nothing from the training generator."""
        seed = int(np.random.SeedSequence([self.seed, step]).generate_state(1, np.uint64)[0] >> 1)
        return torch.Generator(self.device).manual_seed(seed)

    def maybe_sample(
        self,
        step: int,
        latents: Optional[torch.Tensor] = None,
        sample_eps: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> Optional[str]:
        """Sample and save when ``step`` hits the interval; returns the
        step's directory (None otherwise). ``latents`` are the initial
        noise of text-to-image; ``sample_eps`` and ``noise`` img2img's two
        draws; each is drawn from ``generator(step)`` when not given."""
        if not self.interval or step % self.interval:
            return None
        generator = self.generator(step)
        modes = [m.training for m in self._models]
        try:
            for m in self._models:
                m.eval()
            with torch.no_grad():
                if self._img2img:
                    out = self._pipe(
                        self._prompt_ids, self._init_image, strength=self._refine_strength,
                        num_inference_steps=self.num_steps, guidance_scale=self.guidance,
                        neg_prompt_ids=self._neg_ids, generator=generator, sample_eps=sample_eps, noise=noise,
                    )
                else:
                    size = int(self.resolution) if self.resolution else None
                    out = self._pipe(
                        self._prompt_ids, num_inference_steps=self.num_steps, height=size, width=size,
                        guidance_scale=self.guidance, latents=latents, neg_prompt_ids=self._neg_ids,
                        generator=generator,
                    )
                arr = out["images"].float().cpu().numpy()
        finally:
            for m, mode in zip(self._models, modes):
                m.train(mode)
        step_dir = os.path.join(self.out_dir, f"step_{step:08d}")
        save_png_images(arr, step_dir)
        if self.metrics_writer is not None and self.metrics_writer.active:
            self.metrics_writer.scalar("eval/sample_mean", float(arr.mean()), step)
        return step_dir
