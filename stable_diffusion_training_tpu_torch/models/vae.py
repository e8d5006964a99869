"""AutoencoderKL — the latent VAE, NCHW.

Port of ``stable_diffusion_training_tpu/models/vae.py``. The serving path
runs ``decode``; ``encode`` and ``DiagonalGaussianDistribution`` are ported
with it for training. The mid-block attention keeps the legacy
``query/key/value/proj_attn`` names of diffusers 0.21 (``hf_io`` maps the
newer ``to_q/...`` names onto them) and goes through ``ops.attention``: one
head over the spatial tokens, the flash kernel at head dim 512 on the card.
"""

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from ..utils.configuration import ConfigurableMixin
from ..utils.device import resolve_device
from .blocks import Downsample2D, ResnetBlock2D, Upsample2D


class DiagonalGaussianDistribution:
    """Latent posterior q(z|x): mean/logvar split from the encoder moments
    along ``dim`` (the channel axis of NCHW)."""

    def __init__(self, parameters: torch.Tensor, dim: int = 1):
        self.mean, self.logvar = parameters.chunk(2, dim=dim)
        self.logvar = self.logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)
        self.var = torch.exp(self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        noise = torch.randn(
            self.mean.shape, generator=generator, device=self.mean.device, dtype=self.mean.dtype
        )
        return self.mean + self.std * noise

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        return 0.5 * torch.sum(
            self.mean**2 + self.var - 1.0 - self.logvar, dim=tuple(range(1, self.mean.dim()))
        )


class _EncodeOutput:
    def __init__(self, latent_dist):
        self.latent_dist = latent_dist


class _DecodeOutput:
    def __init__(self, sample):
        self.sample = sample


class VaeAttentionBlock(nn.Module):
    """Single-head full self-attention over spatial tokens (VAE mid block)."""

    def __init__(self, channels: int, attention_backend: str = "auto"):
        super().__init__()
        self.attention_backend = attention_backend
        self.group_norm = nn.GroupNorm(32, channels, eps=1e-6)
        self.query = nn.Linear(channels, channels)
        self.key = nn.Linear(channels, channels)
        self.value = nn.Linear(channels, channels)
        self.proj_attn = nn.Linear(channels, channels)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        b, c, h, w = hidden_states.shape
        residual = hidden_states
        hidden_states = self.group_norm(hidden_states).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q = self.query(hidden_states)[:, :, None, :]
        k = self.key(hidden_states)[:, :, None, :]
        v = self.value(hidden_states)[:, :, None, :]
        out = attention(q, k, v, backend=self.attention_backend)[:, :, 0, :]
        out = self.proj_attn(out)
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2) + residual


class DownEncoderBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int, add_downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [
                ResnetBlock2D(in_channels if j == 0 else out_channels, out_channels)
                for j in range(num_layers)
            ]
        )
        if add_downsample:
            self.downsamplers = nn.ModuleList([Downsample2D(out_channels, asymmetric_padding=True)])

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            sample = resnet(sample)
        if hasattr(self, "downsamplers"):
            sample = self.downsamplers[0](sample)
        return sample


class UpDecoderBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int, add_upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [
                ResnetBlock2D(in_channels if j == 0 else out_channels, out_channels)
                for j in range(num_layers)
            ]
        )
        if add_upsample:
            self.upsamplers = nn.ModuleList([Upsample2D(out_channels)])

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            sample = resnet(sample)
        if hasattr(self, "upsamplers"):
            sample = self.upsamplers[0](sample)
        return sample


class VaeMidBlock(nn.Module):
    def __init__(self, channels: int, attention_backend: str = "auto"):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(channels, channels) for _ in range(2)])
        self.attentions = nn.ModuleList([VaeAttentionBlock(channels, attention_backend)])

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        sample = self.resnets[0](sample)
        sample = self.attentions[0](sample)
        return self.resnets[1](sample)


class Encoder(nn.Module):
    def __init__(
        self, in_channels: int, block_out_channels: Sequence[int], layers_per_block: int,
        latent_channels: int, attention_backend: str = "auto",
    ):
        super().__init__()
        self.conv_in = nn.Conv2d(in_channels, block_out_channels[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        ch = block_out_channels[0]
        for i, out_ch in enumerate(block_out_channels):
            self.down_blocks.append(
                DownEncoderBlock2D(ch, out_ch, layers_per_block, i < len(block_out_channels) - 1)
            )
            ch = out_ch
        self.mid_block = VaeMidBlock(ch, attention_backend)
        self.conv_norm_out = nn.GroupNorm(32, ch, eps=1e-6)
        self.conv_out = nn.Conv2d(ch, 2 * latent_channels, 3, padding=1)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        sample = self.conv_in(sample)
        for block in self.down_blocks:
            sample = block(sample)
        sample = self.mid_block(sample)
        return self.conv_out(F.silu(self.conv_norm_out(sample)))


class Decoder(nn.Module):
    def __init__(
        self, out_channels: int, block_out_channels: Sequence[int], layers_per_block: int,
        latent_channels: int, attention_backend: str = "auto",
    ):
        super().__init__()
        ch = block_out_channels[-1]
        self.conv_in = nn.Conv2d(latent_channels, ch, 3, padding=1)
        self.mid_block = VaeMidBlock(ch, attention_backend)
        self.up_blocks = nn.ModuleList()
        reversed_channels = tuple(reversed(block_out_channels))
        for i, out_ch in enumerate(reversed_channels):
            self.up_blocks.append(
                UpDecoderBlock2D(
                    ch, out_ch, layers_per_block + 1, i < len(reversed_channels) - 1
                )
            )
            ch = out_ch
        self.conv_norm_out = nn.GroupNorm(32, ch, eps=1e-6)
        self.conv_out = nn.Conv2d(ch, out_channels, 3, padding=1)

    def forward(self, latents: torch.Tensor) -> torch.Tensor:
        sample = self.mid_block(self.conv_in(latents))
        for block in self.up_blocks:
            sample = block(sample)
        return self.conv_out(F.silu(self.conv_norm_out(sample)))


class AutoencoderKL(ConfigurableMixin, nn.Module):
    """``encode(x).latent_dist`` and ``decode(z).sample``, NCHW, as diffusers
    exposes them. Built on ``device`` (cuda unless told otherwise) in
    ``dtype``."""

    ignore_for_config = ("dtype", "device", "attention_backend")

    def __init__(
        self,
        in_channels: int = 3,
        out_channels: int = 3,
        block_out_channels: Sequence[int] = (128, 256, 512, 512),
        layers_per_block: int = 2,
        latent_channels: int = 4,
        sample_size: int = 512,
        scaling_factor: float = 0.18215,
        attention_backend: str = "auto",
        device=None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self._register_config(dict(locals()))
        with torch.device(resolve_device(device)):
            self.encoder = Encoder(
                in_channels, block_out_channels, layers_per_block, latent_channels,
                attention_backend,
            )
            self.decoder = Decoder(
                out_channels, block_out_channels, layers_per_block, latent_channels,
                attention_backend,
            )
            self.quant_conv = nn.Conv2d(2 * latent_channels, 2 * latent_channels, 1)
            self.post_quant_conv = nn.Conv2d(latent_channels, latent_channels, 1)
        self.to(dtype)

    @property
    def dtype(self) -> torch.dtype:
        return self.post_quant_conv.weight.dtype

    def encode(self, sample: torch.Tensor) -> _EncodeOutput:
        moments = self.quant_conv(self.encoder(sample))
        return _EncodeOutput(DiagonalGaussianDistribution(moments, dim=1))

    def decode(self, latents: torch.Tensor) -> _DecodeOutput:
        return _DecodeOutput(self.decoder(self.post_quant_conv(latents)))
