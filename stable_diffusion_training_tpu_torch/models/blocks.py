"""UNet building blocks: timestep embeddings, ResNet blocks, resampling, and
the composite down/mid/up blocks.

Port of ``stable_diffusion_training_tpu/models/blocks.py`` in NCHW, with
diffusers' attribute names. Norm epsilons follow the JAX package: GroupNorm
1e-5 in every ``ResnetBlock2D`` (the VAE's too), 1e-6 in the spatial
transformer's norm. The polyphase stride-2 downsample (off by default in the
JAX package) is not ported yet.
"""

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .attention import Transformer2DModel


def get_sinusoidal_embeddings(
    timesteps: torch.Tensor,
    embedding_dim: int,
    flip_sin_to_cos: bool = True,
    freq_shift: float = 0.0,
    max_period: float = 10000.0,
    scale: float = 1.0,
) -> torch.Tensor:
    """Sinusoidal timestep embedding (SD uses flip_sin_to_cos=True,
    freq_shift=0)."""
    half_dim = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half_dim, dtype=torch.float32, device=timesteps.device
    )
    exponent = exponent / (half_dim - freq_shift)
    emb = torch.exp(exponent)
    emb = timesteps.float()[:, None] * emb[None, :]
    emb = scale * emb
    if flip_sin_to_cos:
        return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


class TimestepEmbedding(nn.Module):
    """Two-layer MLP lifting the sinusoidal embedding to the UNet time dim."""

    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, temb: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(temb)))


class ResnetBlock2D(nn.Module):
    """GroupNorm-SiLU-Conv x2 with an additive time embedding and a skip
    (1x1 conv when the channel count changes)."""

    def __init__(
        self, in_channels: int, out_channels: int, temb_channels: Optional[int] = None,
        groups: int = 32,
    ):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=1e-5)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        if temb_channels is not None:
            self.time_emb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=1e-5)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, hidden_states: torch.Tensor, temb: Optional[torch.Tensor] = None):
        residual = hidden_states
        hidden_states = self.conv1(F.silu(self.norm1(hidden_states)))
        if temb is not None:
            hidden_states = hidden_states + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        hidden_states = self.conv2(F.silu(self.norm2(hidden_states)))
        if hasattr(self, "conv_shortcut"):
            residual = self.conv_shortcut(residual)
        return hidden_states + residual


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv downsample. The VAE encoder pads (0, 1) on each
    spatial axis; the UNet pads 1 on both sides."""

    def __init__(self, channels: int, asymmetric_padding: bool = False):
        super().__init__()
        self.asymmetric_padding = asymmetric_padding
        self.conv = nn.Conv2d(
            channels, channels, 3, stride=2, padding=0 if asymmetric_padding else 1
        )

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        if self.asymmetric_padding:
            hidden_states = F.pad(hidden_states, (0, 1, 0, 1))
        return self.conv(hidden_states)


class Upsample2D(nn.Module):
    """Nearest 2x upsample followed by a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(hidden_states, scale_factor=2.0, mode="nearest"))


class CrossAttnDownBlock2D(nn.Module):
    """N x (ResNet + Transformer2D), optional downsample; returns skips."""

    def __init__(
        self, in_channels: int, out_channels: int, temb_channels: int, num_layers: int,
        heads: int, cross_attention_dim: int, add_downsample: bool,
        transformer_layers_per_block: int = 1, use_linear_projection: bool = False,
        only_cross_attention: bool = False, attention_backend: str = "auto",
    ):
        super().__init__()
        self.resnets = nn.ModuleList(
            [
                ResnetBlock2D(in_channels if i == 0 else out_channels, out_channels, temb_channels)
                for i in range(num_layers)
            ]
        )
        self.attentions = nn.ModuleList(
            [
                Transformer2DModel(
                    out_channels, heads, out_channels // heads, transformer_layers_per_block,
                    cross_attention_dim, use_linear_projection, only_cross_attention,
                    attention_backend,
                )
                for _ in range(num_layers)
            ]
        )
        if add_downsample:
            self.downsamplers = nn.ModuleList([Downsample2D(out_channels)])

    def forward(self, hidden_states, temb, context) -> Tuple[torch.Tensor, Tuple]:
        output_states = ()
        for resnet, attn in zip(self.resnets, self.attentions):
            hidden_states = attn(resnet(hidden_states, temb), context)
            output_states += (hidden_states,)
        if hasattr(self, "downsamplers"):
            hidden_states = self.downsamplers[0](hidden_states)
            output_states += (hidden_states,)
        return hidden_states, output_states


class DownBlock2D(nn.Module):
    """N x ResNet, optional downsample; returns skips."""

    def __init__(
        self, in_channels: int, out_channels: int, temb_channels: int, num_layers: int,
        add_downsample: bool,
    ):
        super().__init__()
        self.resnets = nn.ModuleList(
            [
                ResnetBlock2D(in_channels if i == 0 else out_channels, out_channels, temb_channels)
                for i in range(num_layers)
            ]
        )
        if add_downsample:
            self.downsamplers = nn.ModuleList([Downsample2D(out_channels)])

    def forward(self, hidden_states, temb, context=None) -> Tuple[torch.Tensor, Tuple]:
        output_states = ()
        for resnet in self.resnets:
            hidden_states = resnet(hidden_states, temb)
            output_states += (hidden_states,)
        if hasattr(self, "downsamplers"):
            hidden_states = self.downsamplers[0](hidden_states)
            output_states += (hidden_states,)
        return hidden_states, output_states


class UNetMidBlock2DCrossAttn(nn.Module):
    """ResNet -> Transformer2D -> ResNet."""

    def __init__(
        self, in_channels: int, temb_channels: int, heads: int, cross_attention_dim: int,
        transformer_layers_per_block: int = 1, use_linear_projection: bool = False,
        attention_backend: str = "auto",
    ):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(in_channels, in_channels, temb_channels) for _ in range(2)]
        )
        self.attentions = nn.ModuleList(
            [
                Transformer2DModel(
                    in_channels, heads, in_channels // heads, transformer_layers_per_block,
                    cross_attention_dim, use_linear_projection, False, attention_backend,
                )
            ]
        )

    def forward(self, hidden_states, temb, context) -> torch.Tensor:
        hidden_states = self.resnets[0](hidden_states, temb)
        hidden_states = self.attentions[0](hidden_states, context)
        return self.resnets[1](hidden_states, temb)


class CrossAttnUpBlock2D(nn.Module):
    """N x (ResNet over [hidden, skip] + Transformer2D), optional upsample.
    ``in_channels[i]`` is resnet i's input width, skip included."""

    def __init__(
        self, in_channels: Sequence[int], out_channels: int, temb_channels: int, heads: int,
        cross_attention_dim: int, add_upsample: bool, transformer_layers_per_block: int = 1,
        use_linear_projection: bool = False, only_cross_attention: bool = False,
        attention_backend: str = "auto",
    ):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(c, out_channels, temb_channels) for c in in_channels]
        )
        self.attentions = nn.ModuleList(
            [
                Transformer2DModel(
                    out_channels, heads, out_channels // heads, transformer_layers_per_block,
                    cross_attention_dim, use_linear_projection, only_cross_attention,
                    attention_backend,
                )
                for _ in in_channels
            ]
        )
        if add_upsample:
            self.upsamplers = nn.ModuleList([Upsample2D(out_channels)])

    def forward(self, hidden_states, res_hidden_states: List[torch.Tensor], temb, context):
        for resnet, attn in zip(self.resnets, self.attentions):
            hidden_states = torch.cat([hidden_states, res_hidden_states.pop()], dim=1)
            hidden_states = attn(resnet(hidden_states, temb), context)
        if hasattr(self, "upsamplers"):
            hidden_states = self.upsamplers[0](hidden_states)
        return hidden_states


class UpBlock2D(nn.Module):
    """N x ResNet over [hidden, skip], optional upsample."""

    def __init__(
        self, in_channels: Sequence[int], out_channels: int, temb_channels: int,
        add_upsample: bool,
    ):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(c, out_channels, temb_channels) for c in in_channels]
        )
        if add_upsample:
            self.upsamplers = nn.ModuleList([Upsample2D(out_channels)])

    def forward(self, hidden_states, res_hidden_states: List[torch.Tensor], temb, context=None):
        for resnet in self.resnets:
            hidden_states = torch.cat([hidden_states, res_hidden_states.pop()], dim=1)
            hidden_states = resnet(hidden_states, temb)
        if hasattr(self, "upsamplers"):
            hidden_states = self.upsamplers[0](hidden_states)
        return hidden_states
