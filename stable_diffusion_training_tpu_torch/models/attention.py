"""Transformer blocks for the UNet: multi-head attention, GEGLU FF,
BasicTransformerBlock, and the spatial Transformer2DModel.

Port of ``stable_diffusion_training_tpu/models/attention.py``. Attribute
names follow diffusers, so ``state_dict()`` keys are the checkpoint keys
(``to_out.0``, ``ff.net.0.proj``, ``ff.net.2``). Self- and cross-attention
both go through ``ops.attention.attention``, which sends long unmasked
self-attention on CUDA tensors to the flash kernel. Spatial tensors are NCHW.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention


class Attention(nn.Module):
    """Multi-head (self or cross) attention; context defaults to the hidden
    states (self-attention)."""

    def __init__(
        self,
        query_dim: int,
        heads: int = 8,
        dim_head: int = 64,
        context_dim: Optional[int] = None,
        attention_backend: str = "auto",
    ):
        super().__init__()
        inner_dim = heads * dim_head
        context_dim = query_dim if context_dim is None else context_dim
        self.heads = heads
        self.dim_head = dim_head
        self.attention_backend = attention_backend
        self.to_q = nn.Linear(query_dim, inner_dim, bias=False)
        self.to_k = nn.Linear(context_dim, inner_dim, bias=False)
        self.to_v = nn.Linear(context_dim, inner_dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner_dim, query_dim), nn.Dropout(0.0)])

    def forward(self, hidden_states: torch.Tensor, context: Optional[torch.Tensor] = None):
        context = hidden_states if context is None else context
        b, sq, _ = hidden_states.shape
        sk = context.shape[1]
        q = self.to_q(hidden_states).reshape(b, sq, self.heads, self.dim_head)
        k = self.to_k(context).reshape(b, sk, self.heads, self.dim_head)
        v = self.to_v(context).reshape(b, sk, self.heads, self.dim_head)
        out = attention(q, k, v, backend=self.attention_backend)
        return self.to_out[0](out.reshape(b, sq, self.heads * self.dim_head))


class GEGLU(nn.Module):
    """Gated GELU feed-forward input projection. The gate uses the tanh
    approximation of GELU, as flax's ``nn.gelu`` does by default."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        hidden, gate = self.proj(hidden_states).chunk(2, dim=-1)
        return hidden * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    """Transformer FF: GEGLU expansion (mult=4) then projection back."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList(
            [GEGLU(dim, dim * mult), nn.Dropout(0.0), nn.Linear(dim * mult, dim)]
        )

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](hidden_states))


class BasicTransformerBlock(nn.Module):
    """Self-attn -> cross-attn -> FF, each pre-LayerNormed with residuals."""

    def __init__(
        self,
        dim: int,
        heads: int,
        dim_head: int,
        cross_attention_dim: Optional[int] = None,
        only_cross_attention: bool = False,
        attention_backend: str = "auto",
    ):
        super().__init__()
        self.only_cross_attention = only_cross_attention
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(
            dim, heads, dim_head,
            context_dim=cross_attention_dim if only_cross_attention else None,
            attention_backend=attention_backend,
        )
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(
            dim, heads, dim_head, context_dim=cross_attention_dim,
            attention_backend=attention_backend,
        )
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, hidden_states: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        hidden_states = hidden_states + self.attn1(
            self.norm1(hidden_states), context if self.only_cross_attention else None
        )
        hidden_states = hidden_states + self.attn2(self.norm2(hidden_states), context)
        return hidden_states + self.ff(self.norm3(hidden_states))


class Transformer2DModel(nn.Module):
    """Spatial transformer: GroupNorm -> project in -> N transformer blocks
    over the flattened ``H*W`` tokens -> project out -> residual.

    ``use_linear_projection`` selects Linear (SD2.x/SDXL) or 1x1 conv (SD1.5)
    projections.
    """

    def __init__(
        self,
        in_channels: int,
        heads: int,
        dim_head: int,
        depth: int = 1,
        cross_attention_dim: Optional[int] = None,
        use_linear_projection: bool = False,
        only_cross_attention: bool = False,
        attention_backend: str = "auto",
    ):
        super().__init__()
        inner_dim = heads * dim_head
        self.use_linear_projection = use_linear_projection
        self.norm = nn.GroupNorm(32, in_channels, eps=1e-6)
        if use_linear_projection:
            self.proj_in = nn.Linear(in_channels, inner_dim)
            self.proj_out = nn.Linear(inner_dim, in_channels)
        else:
            self.proj_in = nn.Conv2d(in_channels, inner_dim, 1)
            self.proj_out = nn.Conv2d(inner_dim, in_channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [
                BasicTransformerBlock(
                    inner_dim, heads, dim_head, cross_attention_dim,
                    only_cross_attention, attention_backend,
                )
                for _ in range(depth)
            ]
        )

    def forward(self, hidden_states: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, _, h, w = hidden_states.shape
        residual = hidden_states
        hidden_states = self.norm(hidden_states)
        if self.use_linear_projection:
            hidden_states = self.proj_in(hidden_states.permute(0, 2, 3, 1).reshape(b, h * w, -1))
        else:
            hidden_states = self.proj_in(hidden_states).permute(0, 2, 3, 1).reshape(b, h * w, -1)

        for block in self.transformer_blocks:
            hidden_states = block(hidden_states, context)

        if self.use_linear_projection:
            hidden_states = self.proj_out(hidden_states)
            hidden_states = hidden_states.reshape(b, h, w, -1).permute(0, 3, 1, 2)
        else:
            hidden_states = hidden_states.reshape(b, h, w, -1).permute(0, 3, 1, 2)
            hidden_states = self.proj_out(hidden_states.contiguous())
        return hidden_states + residual
