"""UNet2DConditionModel — the denoiser, NCHW, SD1.5-capable.

Port of ``stable_diffusion_training_tpu/models/unet.py``. Attention goes
through ``ops.attention`` (the CUDA flash kernel for the 64x64 latent level
on the card). ``set_gradient_checkpointing`` is the JAX package's
``gradient_checkpointing`` (``nn.remat`` around each down, mid and up block)
and ``ff_gradient_checkpointing`` (around each transformer feed-forward),
with ``torch.utils.checkpoint``: the wrapped forward runs again in the
backward, the flash kernel included, and its launch counter counts that
run. SDXL's ``addition_embed_type="text_time"`` micro-conditioning adds
``add_embedding`` (the pooled text embedding and the sinusoidal embedding of
each time id, through a ``TimestepEmbedding``) to the time embedding; the
base's 6 ids and the refiner's 5 differ only in its input width.
"""

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..utils.configuration import ConfigurableMixin
from ..utils.device import resolve_device
from .attention import BasicTransformerBlock
from .blocks import (
    CrossAttnDownBlock2D,
    CrossAttnUpBlock2D,
    DownBlock2D,
    TimestepEmbedding,
    UNetMidBlock2DCrossAttn,
    UpBlock2D,
    get_sinusoidal_embeddings,
)


def _per_block(value, num_blocks: int) -> Tuple:
    """Broadcast a scalar-or-sequence config entry to one value per block."""
    if isinstance(value, (list, tuple)):
        if len(value) != num_blocks:
            raise ValueError(f"expected {num_blocks} per-block values, got {value}")
        return tuple(value)
    return (value,) * num_blocks


class UNet2DConditionModel(ConfigurableMixin, nn.Module):
    """``forward(sample, timesteps, encoder_hidden_states)``: NCHW latents,
    ``(B,)`` or scalar timesteps, ``(B, S, cross_attention_dim)`` context;
    returns the noise/velocity prediction, NCHW. Built on ``device`` (cuda
    unless told otherwise) in ``dtype``."""

    ignore_for_config = ("dtype", "device", "attention_backend")

    def __init__(
        self,
        sample_size: int = 64,
        in_channels: int = 4,
        out_channels: int = 4,
        down_block_types: Sequence[str] = (
            "CrossAttnDownBlock2D",
            "CrossAttnDownBlock2D",
            "CrossAttnDownBlock2D",
            "DownBlock2D",
        ),
        up_block_types: Sequence[str] = (
            "UpBlock2D",
            "CrossAttnUpBlock2D",
            "CrossAttnUpBlock2D",
            "CrossAttnUpBlock2D",
        ),
        block_out_channels: Sequence[int] = (320, 640, 1280, 1280),
        layers_per_block: int = 2,
        transformer_layers_per_block=1,
        attention_head_dim=8,
        num_attention_heads=None,
        cross_attention_dim: int = 768,
        use_linear_projection: bool = False,
        only_cross_attention=False,
        flip_sin_to_cos: bool = True,
        freq_shift: float = 0.0,
        addition_embed_type: Optional[str] = None,
        addition_time_embed_dim: Optional[int] = None,
        projection_class_embeddings_input_dim: Optional[int] = None,
        attention_backend: str = "auto",
        device=None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self._register_config(dict(locals()))
        if addition_embed_type not in (None, "text_time"):
            raise ValueError(f"unsupported addition_embed_type {addition_embed_type!r}")
        n = len(block_out_channels)
        # SD1.5 configs store the head *count* in attention_head_dim
        # (diffusers' historical naming); num_attention_heads overrides
        heads = _per_block(
            num_attention_heads if num_attention_heads is not None else attention_head_dim, n
        )
        tf_layers = _per_block(transformer_layers_per_block, n)
        only_cross = _per_block(only_cross_attention, n)
        self.flip_sin_to_cos = flip_sin_to_cos
        self.freq_shift = freq_shift
        self.addition_embed_type = addition_embed_type
        self.addition_time_embed_dim = addition_time_embed_dim
        ch0 = block_out_channels[0]
        temb_ch = ch0 * 4

        with torch.device(resolve_device(device)):
            self.conv_in = nn.Conv2d(in_channels, ch0, 3, padding=1)
            self.time_embedding = TimestepEmbedding(ch0, temb_ch)
            if addition_embed_type == "text_time":
                self.add_embedding = TimestepEmbedding(
                    projection_class_embeddings_input_dim, temb_ch
                )

            skip_channels = [ch0]  # the skip stack, as forward fills it
            self.down_blocks = nn.ModuleList()
            ch = ch0
            for i, block_type in enumerate(down_block_types):
                out_ch = block_out_channels[i]
                add_downsample = i < n - 1
                if block_type == "CrossAttnDownBlock2D":
                    block = CrossAttnDownBlock2D(
                        ch, out_ch, temb_ch, layers_per_block, heads[i], cross_attention_dim,
                        add_downsample, tf_layers[i], use_linear_projection, only_cross[i],
                        attention_backend,
                    )
                elif block_type == "DownBlock2D":
                    block = DownBlock2D(ch, out_ch, temb_ch, layers_per_block, add_downsample)
                else:
                    raise ValueError(f"unknown down block type {block_type!r}")
                self.down_blocks.append(block)
                skip_channels += [out_ch] * (layers_per_block + int(add_downsample))
                ch = out_ch

            self.mid_block = UNetMidBlock2DCrossAttn(
                ch, temb_ch, heads[-1], cross_attention_dim, tf_layers[-1],
                use_linear_projection, attention_backend,
            )

            self.up_blocks = nn.ModuleList()
            rev_channels = tuple(reversed(block_out_channels))
            rev_heads = tuple(reversed(heads))
            rev_tf = tuple(reversed(tf_layers))
            rev_only_cross = tuple(reversed(only_cross))
            for i, block_type in enumerate(up_block_types):
                out_ch = rev_channels[i]
                add_upsample = i < n - 1
                in_chs = []
                for j in range(layers_per_block + 1):
                    in_chs.append((ch if j == 0 else out_ch) + skip_channels.pop())
                if block_type == "CrossAttnUpBlock2D":
                    block = CrossAttnUpBlock2D(
                        in_chs, out_ch, temb_ch, rev_heads[i], cross_attention_dim,
                        add_upsample, rev_tf[i], use_linear_projection, rev_only_cross[i],
                        attention_backend,
                    )
                elif block_type == "UpBlock2D":
                    block = UpBlock2D(in_chs, out_ch, temb_ch, add_upsample)
                else:
                    raise ValueError(f"unknown up block type {block_type!r}")
                self.up_blocks.append(block)
                ch = out_ch

            self.conv_norm_out = nn.GroupNorm(32, ch0, eps=1e-5)
            self.conv_out = nn.Conv2d(ch0, out_channels, 3, padding=1)
        self.to(dtype)
        self.gradient_checkpointing = False

    def set_gradient_checkpointing(self, blocks: bool, feed_forward: bool = False) -> None:
        """Recompute each down, mid and up block (``blocks``) and each
        transformer feed-forward (``feed_forward``) in the backward instead of
        saving their activations. The values do not change."""
        self.gradient_checkpointing = bool(blocks)
        for module in self.modules():
            if isinstance(module, BasicTransformerBlock):
                module.ff_gradient_checkpointing = bool(feed_forward)

    def _block(self, fn, *args):
        if self.gradient_checkpointing and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    @property
    def device(self) -> torch.device:
        return self.conv_in.weight.device

    def forward(
        self,
        sample: torch.Tensor,
        timesteps: torch.Tensor,
        encoder_hidden_states: torch.Tensor,
        added_cond_kwargs: Optional[Dict[str, torch.Tensor]] = None,
    ) -> torch.Tensor:
        """``added_cond_kwargs`` (``text_time`` UNets only):
        ``{"text_embeds": (B, P), "time_ids": (B, n_ids)}``."""
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.dim() == 0:
            timesteps = timesteps[None].expand(sample.shape[0])
        t_emb = get_sinusoidal_embeddings(
            timesteps, self.conv_in.out_channels, self.flip_sin_to_cos, self.freq_shift
        ).to(self.dtype)
        t_emb = self.time_embedding(t_emb)

        if self.addition_embed_type == "text_time":
            if added_cond_kwargs is None:
                raise ValueError(
                    "SDXL UNet requires added_cond_kwargs={'text_embeds', 'time_ids'}"
                )
            text_embeds = added_cond_kwargs["text_embeds"]
            time_embeds = get_sinusoidal_embeddings(
                added_cond_kwargs["time_ids"].reshape(-1), self.addition_time_embed_dim,
                self.flip_sin_to_cos, self.freq_shift,
            ).reshape(text_embeds.shape[0], -1)
            add_embeds = torch.cat([text_embeds.to(self.dtype), time_embeds.to(self.dtype)], dim=-1)
            t_emb = t_emb + self.add_embedding(add_embeds)

        hidden_states = self.conv_in(sample)
        skips = [hidden_states]
        for block in self.down_blocks:
            hidden_states, res = self._block(block, hidden_states, t_emb, encoder_hidden_states)
            skips.extend(res)

        hidden_states = self._block(self.mid_block, hidden_states, t_emb, encoder_hidden_states)

        for block in self.up_blocks:
            # each call gets its own list of skips: an up block pops from the
            # list, and a recompute calls it again on the same arguments
            n = len(block.resnets)
            res, skips = skips[-n:], skips[:-n]
            hidden_states = self._block(
                lambda h, t, c, *r, block=block: block(h, list(r), t, c),
                hidden_states, t_emb, encoder_hidden_states, *res,
            )

        hidden_states = F.silu(self.conv_norm_out(hidden_states))
        return self.conv_out(hidden_states)
