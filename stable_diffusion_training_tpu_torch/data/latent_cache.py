"""Offline VAE-latent caching (BASELINE config 5).

Port of ``stable_diffusion_training_tpu/data/latent_cache.py``, function by
function. For frozen-VAE training the encoder output never changes, so the
VAE encode runs once offline; the train step then takes the cached
posterior *moments* (mean and logvar, twice the latent channels, NCHW) and
still draws a fresh latent sample each step, so training sees the same
distribution as with the encode in the step.

Cached batches carry ``latent_moments`` instead of ``pixel_values``; the
train step finds the key and skips the VAE (``train/train_step.py``). With
SDXL's frozen towers the shards also carry ``pooled_text_embeds``,
``time_ids`` and the dual-tower ``encoder_hidden_states``.

Where the JAX package takes ``(module, params)`` pairs, these functions take
torch modules and run on each module's own device, under
``torch.no_grad()``; they return numpy, as the JAX package's do, in f32 (a
bf16 model's outputs upcast exactly, where the JAX package keeps bf16). The
shards are the JAX package's: ``latents_{i:06d}.npz`` with the same keys
and shapes, and of f32 models the same dtypes, so either package reads a
cache that the other wrote.
"""

import os
from typing import Dict, Iterable, List

import numpy as np
import torch

from ..utils.context import concat_context_windows


def _device_and_dtype(module: torch.nn.Module):
    p = next(module.parameters())
    return p.device, p.dtype


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


@torch.no_grad()
def encode_batch_to_moments(vae, pixel_values_nchw, chunk: int = 0) -> np.ndarray:
    """Run the VAE encoder on an NCHW pixel batch; returns NCHW moments
    ``[mean, logvar]``.

    ``chunk=n`` encodes ``n`` samples at a time, as the JAX package's
    ``lax.map`` does (its lever against whole-batch encodes at >= 768 px);
    the default 0 means per-sample at a spatial size >= 768 and the whole
    batch below. A batch that ``chunk`` does not divide is encoded whole.
    The encode is per sample, so every setting gives the same values."""
    device, dtype = _device_and_dtype(vae)
    pixels = torch.as_tensor(np.asarray(pixel_values_nchw), device=device).to(dtype)
    if chunk == 0:
        chunk = 1 if max(pixels.shape[-2:]) >= 768 else None
    if not chunk or pixels.shape[0] % chunk:
        chunk = pixels.shape[0]
    moments = []
    for piece in pixels.split(chunk):
        dist = vae.encode(piece).latent_dist
        moments.append(torch.cat([dist.mean, dist.logvar], dim=1))
    return _numpy(torch.cat(moments))


def sdxl_time_ids(
    batch_size: int,
    original_size,
    crop_coords,
    target_size,
    aesthetic_score=None,
) -> np.ndarray:
    """SDXL micro-conditioning ids, f32. Base model: ``(B, 6)``
    (orig_h, orig_w, crop_top, crop_left, target_h, target_w). With
    ``aesthetic_score`` set (refiner training): ``(B, 5)``
    (orig_h, orig_w, crop_top, crop_left, aesthetic_score)."""
    if aesthetic_score is not None:
        row = np.array([[*original_size, *crop_coords, float(aesthetic_score)]], dtype=np.float32)
        return np.broadcast_to(row, (batch_size, 5)).copy()
    row = np.array([[*original_size, *crop_coords, *target_size]], dtype=np.float32)
    return np.broadcast_to(row, (batch_size, 6)).copy()


def _window_rows(input_ids, context_window: int) -> np.ndarray:
    """Ids as ``(rows, window)``: ``(B, concat, win)`` and ``(B, concat *
    win)`` are flattened to one row per window."""
    ids = np.asarray(input_ids)
    if ids.ndim == 3:  # (B, concat, win)
        ids = ids.reshape(-1, ids.shape[-1])
    elif ids.ndim == 2 and ids.shape[1] > context_window:
        ids = ids.reshape(-1, context_window)
    return ids


@torch.no_grad()
def _encode_context_one_tower(text_encoder, ids_2d: np.ndarray, penultimate: bool) -> torch.Tensor:
    """One tower's windows: ``(N, win)`` ids -> ``(N, win, dim)`` hidden
    states, or the penultimate layer's (the SDXL convention). Uses
    ``last_hidden_state`` by name: for ``CLIPTextModelWithProjection``,
    ``out[0]`` is the pooled ``text_embeds``, not the token states."""
    device, _ = _device_and_dtype(text_encoder)
    out = text_encoder(torch.as_tensor(ids_2d, device=device).long(), output_hidden_states=penultimate)
    return out.hidden_states[-2] if penultimate else out.last_hidden_state


def compute_encoder_hidden_states(
    text_encoder,
    input_ids,
    concat_count: int = 1,
    context_window: int = 77,
    text_encoder_2=None,
    strip_bos_eos_token: bool = True,
    penultimate: bool = False,
    input_ids_2=None,
) -> np.ndarray:
    """The UNet's cross-attention context from FROZEN text towers.

    One tower: the in-step encode's math (77-token windows, the BOS/EOS
    strip and concat of ``utils.context``). With ``text_encoder_2``, the two
    towers' per-token states are concatenated on the FEATURE axis after the
    window concat: SDXL's 768 + 1280 = 2048-channel context, which the step
    cannot make in line (it carries only tower 1). ``penultimate=True``
    takes each tower's second-to-last hidden layer (the SDXL convention).

    SDXL tokenizes the prompt once per tower (the two tokenizers pad
    differently); ``input_ids_2`` feeds tower 2 its own ids, else it reuses
    ``input_ids``. Ids are ``(B * concat, win)``, ``(B, concat * win)`` or
    ``(B, concat, win)``. Feed the result as ``batch["encoder_hidden_states"]``
    with ``train_text_encoder=False``."""
    ids = _window_rows(input_ids, context_window)
    if ids.shape[0] % concat_count:
        raise ValueError(
            f"{ids.shape[0]} id rows do not group into concat_count="
            f"{concat_count} windows per sample"
        )

    def strip_concat(h):  # (B * concat, win, dim) -> (B, tokens, dim)
        h = h.reshape(h.shape[0] // concat_count, concat_count, h.shape[-2], h.shape[-1])
        return concat_context_windows(h, strip_bos_eos_token)

    towers = [strip_concat(_encode_context_one_tower(text_encoder, ids, penultimate))]
    if text_encoder_2 is not None:
        ids2 = ids if input_ids_2 is None else _window_rows(input_ids_2, context_window)
        h2 = strip_concat(_encode_context_one_tower(text_encoder_2, ids2, penultimate))
        towers.append(h2.to(towers[0].device))
    return np.concatenate([_numpy(t) for t in towers], axis=-1)


@torch.no_grad()
def compute_pooled_text_embeds(text_encoder_2, input_ids, context_window: int = 77) -> np.ndarray:
    """Pooled, projected embeds of the frozen second tower (SDXL's
    ``text_embeds`` micro-conditioning), ``(B, projection_dim)``.

    SDXL pools from the FIRST 77-token window of each sample only. Ids are
    ``(B, win)`` (already the first window), ``(B, concat * win)`` or
    ``(B, concat, win)``; a flat ``(B * concat, win)`` batch is ambiguous,
    so reshape it to one of those at the call site."""
    ids = np.asarray(input_ids)
    if ids.ndim == 3:
        ids = ids[:, 0, :]
    elif ids.ndim == 2 and ids.shape[1] > context_window:
        if ids.shape[1] % context_window:
            raise ValueError(
                f"ids width {ids.shape[1]} is not a multiple of the "
                f"{context_window}-token window"
            )
        ids = ids.reshape(ids.shape[0], -1, context_window)[:, 0, :]
    device, _ = _device_and_dtype(text_encoder_2)
    return _numpy(text_encoder_2(torch.as_tensor(ids, device=device).long()).text_embeds)


def cache_batches_to_dir(
    batches: Iterable[Dict[str, np.ndarray]],
    vae,
    cache_dir: str,
    text_encoder_2=None,
    context_window: int = 77,
    aesthetic_score=None,
    text_encoder=None,
    concat_count: int = 1,
    strip_bos_eos_token: bool = True,
    penultimate: bool = False,
    context_use_tower_2: bool = True,
) -> List[str]:
    """Offline pass: encode every batch's pixels, write npz shards.

    With ``text_encoder_2`` given, each shard also carries SDXL's
    micro-conditioning: ``pooled_text_embeds`` from the frozen second tower
    and the size/crop ``time_ids`` (``aesthetic_score`` switches them to
    the refiner's 5-id form). With ``text_encoder`` given too, shards carry
    the frozen cross-attention context (``encoder_hidden_states``; both
    towers' feature concat unless ``context_use_tower_2=False``), so the
    step encodes no text (``train_text_encoder=False``)."""
    os.makedirs(cache_dir, exist_ok=True)
    paths = []
    for i, batch in enumerate(batches):
        moments = encode_batch_to_moments(vae, batch["pixel_values"])
        extras = {}
        if text_encoder_2 is not None:
            b, _, h, w = batch["pixel_values"].shape
            # the first 77-token window of each sample is the pooled source
            first_windows = np.asarray(batch["input_ids"]).reshape(b, -1, context_window)[:, 0, :]
            extras["pooled_text_embeds"] = compute_pooled_text_embeds(
                text_encoder_2, first_windows, context_window
            )
            extras["time_ids"] = sdxl_time_ids(b, (h, w), (0, 0), (h, w), aesthetic_score=aesthetic_score)
        if text_encoder is not None:
            # context_use_tower_2=False: a tower-1 context even when tower 2
            # gives the pooled micro-conditioning (a UNet of tower 1's width)
            extras["encoder_hidden_states"] = compute_encoder_hidden_states(
                text_encoder,
                batch["input_ids"],
                concat_count=concat_count,
                context_window=context_window,
                text_encoder_2=text_encoder_2 if context_use_tower_2 else None,
                strip_bos_eos_token=strip_bos_eos_token,
                penultimate=penultimate,
            )
        path = os.path.join(cache_dir, f"latents_{i:06d}.npz")
        np.savez(
            path,
            latent_moments=moments,
            input_ids=batch["input_ids"],
            attention_mask=batch["attention_mask"],
            **extras,
        )
        paths.append(path)
    return paths


class CachedLatentLoader:
    """Streamer-protocol loader over an offline latent cache directory."""

    def __init__(self, cache_dir: str):
        self.cache_dir = cache_dir
        self._paths = sorted(
            os.path.join(cache_dir, f) for f in os.listdir(cache_dir) if f.endswith(".npz")
        )
        self._cursor = 0
        self._print_debug = False
        self.chunk_number = 0
        self._bulk_batch_count = len(self._paths)
        self._first_batch_count = 0

    # --- streamer protocol ---------------------------------------------------
    def delete_prev_chunks(self, prev_chunk: int) -> None:
        pass

    def grab_and_prefetch_chunk(self, numb_of_prefetched_batch: int = 1) -> None:
        pass

    def prepare_training_dataframe(self) -> None:
        pass

    def create_training_dataframe(self) -> None:
        pass

    def dispatch_worker(self) -> None:
        self._cursor = 0

    def grab_next_batch(self):
        if self._cursor >= len(self._paths):
            return "end_of_batch"
        with np.load(self._paths[self._cursor]) as z:
            batch = {k: z[k] for k in z.files}
        self._cursor += 1
        return batch


def precompute_latent_cache(
    pixel_loader,
    vae,
    cache_dir: str,
    text_encoder_2=None,
    context_window: int = 77,
    aesthetic_score=None,
    **context_kwargs,
) -> CachedLatentLoader:
    """Drain a pixel loader through the VAE (and the frozen SDXL towers,
    where given) into a cache; return the cached loader.
    ``context_kwargs`` (``text_encoder``, ``concat_count`` ...) go to
    ``cache_batches_to_dir`` for the frozen-tower context."""

    def batches():
        pixel_loader.dispatch_worker()
        while True:
            b = pixel_loader.grab_next_batch()
            if isinstance(b, str):
                return
            if b is None:
                continue
            yield b

    cache_batches_to_dir(
        batches(),
        vae,
        cache_dir,
        text_encoder_2=text_encoder_2,
        context_window=context_window,
        aesthetic_score=aesthetic_score,
        **context_kwargs,
    )
    return CachedLatentLoader(cache_dir)
