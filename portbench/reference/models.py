"""The plain reference of the models that a Stable Diffusion train step
runs: the conditional UNet (SD1.5, and SDXL's ``text_time``
micro-conditioning), the CLIP text tower and the VAE encoder.

Written from the published architectures (diffusers' ``UNet2DConditionModel``
and ``AutoencoderKL``, transformers' ``CLIPTextModel``) in plain PyTorch.
It imports nothing of the program under test. The parameter names are the
diffusers and transformers checkpoint keys, so that one dict of weights
loads into both sides. Numerics follow the JAX trainer that the program
ports: GroupNorm eps 1e-5 in every ResNet block, 1e-6 in the spatial
transformer's and the VAE attention's norms, tanh GELU in the GEGLU,
quick-GELU in CLIP, f32 logits and softmax in every attention.

Attention runs over query chunks, each recomputed in the backward
(``torch.utils.checkpoint``), so that no ``(B, H, Sq, Sk)`` score tensor is
kept: the values are those of one full softmax.
"""

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .numerics import Numerics

# f32 scores a query chunk may hold (elements)
SCORE_ELEMENTS = 1 << 28


class Linear(nn.Linear):
    num: Numerics = Numerics()

    def forward(self, x):
        return self.num.linear(x, self.weight, self.bias)


class Conv2d(nn.Conv2d):
    num: Numerics = Numerics()

    def forward(self, x):
        return self.num.conv(x, self.weight, self.bias, self.stride, self.padding)


def set_numerics(module: nn.Module, num: Numerics) -> None:
    """Every product of ``module`` through ``num``."""
    for m in module.modules():
        if isinstance(m, (Linear, Conv2d, Attention, VaeAttention, CLIPAttention)):
            m.num = num


def _softmax_attention(num: Numerics, q, k, v, scale: float):
    """``softmax(q k^T scale) v`` of ``(B, H, S, D)`` tensors, f32 logits."""
    logits = num.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    weights = torch.softmax(logits, dim=-1)
    return num.matmul(weights.to(v.dtype).float(), v.float()).to(q.dtype)


def attention(num: Numerics, q, k, v):
    """Full attention of ``(B, S, H, D)`` tensors, ``(B, Sq, H, D)`` out."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    q, k, v = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    rows = max(1, min(sq, SCORE_ELEMENTS // max(1, b * h * sk)))
    outs = []
    for i in range(0, sq, rows):
        part = q[:, :, i : i + rows]
        if torch.is_grad_enabled():
            outs.append(checkpoint(_softmax_attention, num, part, k, v, d**-0.5, use_reentrant=False))
        else:
            outs.append(_softmax_attention(num, part, k, v, d**-0.5))
    return torch.cat(outs, dim=2).permute(0, 2, 1, 3)


def sinusoidal(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """cos | sin of ``timesteps * exp(-ln(1e4) i / (dim / 2))``, f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    emb = timesteps.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim, dim):
        super().__init__()
        self.linear_1 = Linear(in_dim, dim)
        self.linear_2 = Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock2D(nn.Module):
    def __init__(self, cin, cout, temb=None):
        super().__init__()
        self.norm1 = nn.GroupNorm(32, cin, eps=1e-5)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        if temb is not None:
            self.time_emb_proj = Linear(temb, cout)
        self.norm2 = nn.GroupNorm(32, cout, eps=1e-5)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_shortcut = Conv2d(cin, cout, 1)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return h + x


class Attention(nn.Module):
    num: Numerics = Numerics()

    def __init__(self, dim, heads, dim_head, context_dim=None):
        super().__init__()
        inner = heads * dim_head
        context_dim = dim if context_dim is None else context_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(context_dim, inner, bias=False)
        self.to_v = Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, dim)])

    def forward(self, x, context=None):
        context = x if context is None else context
        b, sq, _ = x.shape
        sk = context.shape[1]
        q = self.to_q(x).reshape(b, sq, self.heads, self.dim_head)
        k = self.to_k(context).reshape(b, sk, self.heads, self.dim_head)
        v = self.to_v(context).reshape(b, sk, self.heads, self.dim_head)
        return self.to_out[0](attention(self.num, q, k, v).reshape(b, sq, -1))


class GEGLU(nn.Module):
    def __init__(self, dim, out):
        super().__init__()
        self.proj = Linear(dim, out * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * 4), nn.Identity(), Linear(dim * 4, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, heads, dim_head, context_dim):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, dim_head)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, dim_head, context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    def __init__(self, channels, heads, dim_head, depth, context_dim, linear_projection):
        super().__init__()
        inner = heads * dim_head
        self.linear_projection = linear_projection
        self.norm = nn.GroupNorm(32, channels, eps=1e-6)
        if linear_projection:
            self.proj_in, self.proj_out = Linear(channels, inner), Linear(inner, channels)
        else:
            self.proj_in, self.proj_out = Conv2d(channels, inner, 1), Conv2d(inner, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, dim_head, context_dim) for _ in range(depth)]
        )

    def forward(self, x, context):
        b, _, h, w = x.shape
        y = self.norm(x)
        if self.linear_projection:
            y = self.proj_in(y.permute(0, 2, 3, 1).reshape(b, h * w, -1))
        else:
            y = self.proj_in(y).permute(0, 2, 3, 1).reshape(b, h * w, -1)
        for block in self.transformer_blocks:
            y = block(y, context)
        if self.linear_projection:
            y = self.proj_out(y).reshape(b, h, w, -1).permute(0, 3, 1, 2)
        else:
            y = self.proj_out(y.reshape(b, h, w, -1).permute(0, 3, 1, 2).contiguous())
        return y + x


class Resample(nn.Module):
    """``conv`` after a nearest 2x upsample (``up``), or a stride-2 ``conv``
    (the VAE's pads right and bottom by one, the UNet's both sides)."""

    def __init__(self, channels, up=False, asymmetric=False):
        super().__init__()
        self.up, self.asymmetric = up, asymmetric
        stride, padding = (1, 1) if up else (2, 0 if asymmetric else 1)
        self.conv = Conv2d(channels, channels, 3, stride=stride, padding=padding)

    def forward(self, x):
        if self.up:
            x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        elif self.asymmetric:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


def _per_block(value, n):
    return tuple(value) if isinstance(value, (list, tuple)) else (value,) * n


class UNet(nn.Module):
    """``forward(latents, timesteps, context, added)``: NCHW in and out."""

    def __init__(self, cfg: Dict):
        super().__init__()
        chans = cfg["block_out_channels"]
        n = len(chans)
        heads = _per_block(cfg.get("num_attention_heads") or cfg["attention_head_dim"], n)
        depth = _per_block(cfg.get("transformer_layers_per_block", 1), n)
        layers, ctx = cfg["layers_per_block"], cfg["cross_attention_dim"]
        linear = cfg.get("use_linear_projection", False)
        ch0, temb = chans[0], chans[0] * 4
        self.time_dim = ch0
        self.add_time_dim = cfg.get("addition_time_embed_dim")
        self.conv_in = Conv2d(cfg["in_channels"], ch0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch0, temb)
        if cfg.get("addition_embed_type") == "text_time":
            self.add_embedding = TimestepEmbedding(cfg["projection_class_embeddings_input_dim"], temb)
        skips = [ch0]
        self.down_blocks = nn.ModuleList()
        ch = ch0
        for i, kind in enumerate(cfg["down_block_types"]):
            block = nn.Module()
            block.resnets = nn.ModuleList(
                [ResnetBlock2D(ch if j == 0 else chans[i], chans[i], temb) for j in range(layers)]
            )
            if kind == "CrossAttnDownBlock2D":
                block.attentions = nn.ModuleList(
                    [Transformer2DModel(chans[i], heads[i], chans[i] // heads[i], depth[i], ctx, linear)
                     for _ in range(layers)]
                )
            if i < n - 1:
                block.downsamplers = nn.ModuleList([Resample(chans[i])])
            self.down_blocks.append(block)
            skips += [chans[i]] * (layers + int(i < n - 1))
            ch = chans[i]
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList([ResnetBlock2D(ch, ch, temb) for _ in range(2)])
        self.mid_block.attentions = nn.ModuleList(
            [Transformer2DModel(ch, heads[-1], ch // heads[-1], depth[-1], ctx, linear)]
        )
        self.up_blocks = nn.ModuleList()
        for i, kind in enumerate(cfg["up_block_types"]):
            out = chans[n - 1 - i]
            h, d = heads[n - 1 - i], depth[n - 1 - i]
            block = nn.Module()
            block.resnets = nn.ModuleList(
                [ResnetBlock2D((ch if j == 0 else out) + skips.pop(), out, temb) for j in range(layers + 1)]
            )
            if kind == "CrossAttnUpBlock2D":
                block.attentions = nn.ModuleList(
                    [Transformer2DModel(out, h, out // h, d, ctx, linear) for _ in range(layers + 1)]
                )
            if i < n - 1:
                block.upsamplers = nn.ModuleList([Resample(out, up=True)])
            self.up_blocks.append(block)
            ch = out
        self.conv_norm_out = nn.GroupNorm(32, ch0, eps=1e-5)
        self.conv_out = Conv2d(ch0, cfg["out_channels"], 3, padding=1)

    def forward(self, x, timesteps, context, added: Optional[Dict[str, torch.Tensor]] = None):
        dtype = self.conv_in.weight.dtype
        temb = self.time_embedding(sinusoidal(timesteps, self.time_dim).to(dtype))
        if hasattr(self, "add_embedding"):
            text = added["text_embeds"]
            ids = sinusoidal(added["time_ids"].reshape(-1), self.add_time_dim).reshape(text.shape[0], -1)
            temb = temb + self.add_embedding(torch.cat([text.to(dtype), ids.to(dtype)], dim=-1))
        x = self.conv_in(x)
        skips: List[torch.Tensor] = [x]
        for block in self.down_blocks:
            for j, resnet in enumerate(block.resnets):
                x = resnet(x, temb)
                if hasattr(block, "attentions"):
                    x = block.attentions[j](x, context)
                skips.append(x)
            if hasattr(block, "downsamplers"):
                x = block.downsamplers[0](x)
                skips.append(x)
        x = self.mid_block.resnets[0](x, temb)
        x = self.mid_block.attentions[0](x, context)
        x = self.mid_block.resnets[1](x, temb)
        for block in self.up_blocks:
            for j, resnet in enumerate(block.resnets):
                x = resnet(torch.cat([x, skips.pop()], dim=1), temb)
                if hasattr(block, "attentions"):
                    x = block.attentions[j](x, context)
            if hasattr(block, "upsamplers"):
                x = block.upsamplers[0](x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class CLIPAttention(nn.Module):
    num: Numerics = Numerics()

    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = Linear(dim, dim), Linear(dim, dim)
        self.v_proj, self.out_proj = Linear(dim, dim), Linear(dim, dim)

    def forward(self, x, mask):
        b, s, dim = x.shape
        d = dim // self.heads
        shape = (b, s, self.heads, d)
        q = (self.q_proj(x) * d**-0.5).reshape(shape).transpose(1, 2)
        k = self.k_proj(x).reshape(shape).transpose(1, 2)
        v = self.v_proj(x).reshape(shape).transpose(1, 2)
        logits = self.num.matmul(q.float(), k.float().transpose(-1, -2)) + mask
        weights = torch.softmax(logits, dim=-1).to(x.dtype)
        out = self.num.matmul(weights, v).transpose(1, 2).reshape(b, s, dim)
        return self.out_proj(out)


class CLIPText(nn.Module):
    """CLIP's text tower: the last hidden state after the final norm."""

    def __init__(self, cfg: Dict):
        super().__init__()
        dim, act = cfg["hidden_size"], cfg["hidden_act"]
        if act != "quick_gelu":
            raise ValueError(f"the reference's CLIP takes quick_gelu, not {act!r}")
        tm = self.text_model = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = nn.Embedding(cfg["vocab_size"], dim)
        tm.embeddings.position_embedding = nn.Embedding(cfg["max_position_embeddings"], dim)
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList()
        for _ in range(cfg["num_hidden_layers"]):
            layer = nn.Module()
            layer.layer_norm1 = nn.LayerNorm(dim, eps=1e-5)
            layer.self_attn = CLIPAttention(dim, cfg["num_attention_heads"])
            layer.layer_norm2 = nn.LayerNorm(dim, eps=1e-5)
            layer.mlp = nn.Module()
            layer.mlp.fc1 = Linear(dim, cfg["intermediate_size"])
            layer.mlp.fc2 = Linear(cfg["intermediate_size"], dim)
            tm.encoder.layers.append(layer)
        tm.final_layer_norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, ids):
        tm = self.text_model
        s = ids.shape[1]
        x = tm.embeddings.token_embedding(ids) + tm.embeddings.position_embedding(
            torch.arange(s, device=ids.device))[None]
        mask = torch.full((s, s), torch.finfo(torch.float32).min, device=ids.device).triu(1)
        for layer in tm.encoder.layers:
            x = x + layer.self_attn(layer.layer_norm1(x), mask)
            h = layer.mlp.fc1(layer.layer_norm2(x))
            x = x + layer.mlp.fc2(h * torch.sigmoid(1.702 * h))
        return tm.final_layer_norm(x)


class VaeAttention(nn.Module):
    num: Numerics = Numerics()

    def __init__(self, channels):
        super().__init__()
        self.group_norm = nn.GroupNorm(32, channels, eps=1e-6)
        self.query, self.key = Linear(channels, channels), Linear(channels, channels)
        self.value, self.proj_attn = Linear(channels, channels), Linear(channels, channels)

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = (m(y)[:, :, None, :] for m in (self.query, self.key, self.value))
        out = self.proj_attn(attention(self.num, q, k, v)[:, :, 0, :])
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class VAEEncoder(nn.Module):
    """``AutoencoderKL``'s encoder and ``quant_conv``: the posterior's
    moments (mean | logvar on the channel axis)."""

    def __init__(self, cfg: Dict):
        super().__init__()
        chans: Sequence[int] = cfg["block_out_channels"]
        layers = cfg["layers_per_block"]
        enc = self.encoder = nn.Module()
        enc.conv_in = Conv2d(cfg["in_channels"], chans[0], 3, padding=1)
        enc.down_blocks = nn.ModuleList()
        ch = chans[0]
        for i, out in enumerate(chans):
            block = nn.Module()
            block.resnets = nn.ModuleList([ResnetBlock2D(ch if j == 0 else out, out) for j in range(layers)])
            if i < len(chans) - 1:
                block.downsamplers = nn.ModuleList([Resample(out, asymmetric=True)])
            enc.down_blocks.append(block)
            ch = out
        enc.mid_block = nn.Module()
        enc.mid_block.resnets = nn.ModuleList([ResnetBlock2D(ch, ch) for _ in range(2)])
        enc.mid_block.attentions = nn.ModuleList([VaeAttention(ch)])
        enc.conv_norm_out = nn.GroupNorm(32, ch, eps=1e-6)
        enc.conv_out = Conv2d(ch, 2 * cfg["latent_channels"], 3, padding=1)
        self.quant_conv = Conv2d(2 * cfg["latent_channels"], 2 * cfg["latent_channels"], 1)

    def forward(self, x):
        enc = self.encoder
        x = enc.conv_in(x)
        for block in enc.down_blocks:
            for resnet in block.resnets:
                x = resnet(x)
            if hasattr(block, "downsamplers"):
                x = block.downsamplers[0](x)
        x = enc.mid_block.resnets[0](x)
        x = enc.mid_block.attentions[0](x)
        x = enc.mid_block.resnets[1](x)
        return self.quant_conv(enc.conv_out(F.silu(enc.conv_norm_out(x))))
