"""CLIP text encoder — the conditioning model.

Port of ``stable_diffusion_training_tpu/models/clip.py``: pre-LN transformer,
causal mask, quick_gelu (SD1.5) or gelu, final layer norm. Module names
follow transformers' ``CLIPTextModel`` (``text_model.embeddings...``,
``text_model.encoder.layers.N...``), so ``state_dict()`` keys are its
checkpoint keys. Its attention is its own f32-softmax matmul with the causal
mask, not the dispatcher: 77 tokens never reach the flash kernel.
Under tensor parallelism (``parallel.sharding.tensor_parallel_``, then
each module's ``split_``) an attention holds its rank's heads and an MLP its share of ``fc1``'s outputs:
each reads one ``tp_copy`` of its input, and ``out_proj``'s or ``fc2``'s
partial products are summed over the axis before the bias.
``CLIPTextModelWithProjection`` is SDXL's second text encoder: the same
tower, pooled at EOS and projected by ``text_projection`` (no bias), with
transformers' ``CLIPTextModelWithProjection`` names.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.sharding import tp_copy, tp_row_linear
from ..utils.configuration import ConfigurableMixin
from ..utils.device import resolve_device


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":  # transformers "gelu" is the exact erf form
        return F.gelu
    if name in ("gelu_new", "gelu_pytorch_tanh"):
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


class CLIPAttention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.q_proj = nn.Linear(hidden_size, hidden_size)
        self.k_proj = nn.Linear(hidden_size, hidden_size)
        self.v_proj = nn.Linear(hidden_size, hidden_size)
        self.out_proj = nn.Linear(hidden_size, hidden_size)
        self.tp = None  # the model_parallel axis (num_heads then this rank's), or None

    def can_split(self, ranks: int) -> bool:
        """Whether ``ranks`` tensor-parallel ranks can each run a share of
        the heads."""
        return self.num_heads % ranks == 0

    def split_(self, axis) -> None:
        """Run on this rank's heads of the projections split over ``axis``."""
        self.tp, self.num_heads = axis, self.num_heads // axis.size

    def forward(self, hidden_states: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            hidden_states = tp_copy(hidden_states, self.tp)
        b, s, _ = hidden_states.shape
        shape = (b, s, self.num_heads, self.head_dim)
        # transformers pre-scales q before the matmul; f32 logits and softmax
        q = (self.q_proj(hidden_states) * self.head_dim**-0.5).reshape(shape).transpose(1, 2)
        k = self.k_proj(hidden_states).reshape(shape).transpose(1, 2)
        v = self.v_proj(hidden_states).reshape(shape).transpose(1, 2)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) + causal_mask
        weights = torch.softmax(logits, dim=-1).to(hidden_states.dtype)
        out = torch.matmul(weights, v).transpose(1, 2).reshape(b, s, self.num_heads * self.head_dim)
        if self.tp is not None:
            return tp_row_linear(out, self.out_proj, self.tp)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, hidden_size: int, intermediate_size: int, hidden_act: str):
        super().__init__()
        self.act = _act(hidden_act)
        self.fc1 = nn.Linear(hidden_size, intermediate_size)
        self.fc2 = nn.Linear(intermediate_size, hidden_size)
        self.tp = None  # the model_parallel axis fc1 and fc2 are split over, or None

    def split_(self, axis) -> None:
        """Run on this rank's share of the hidden channels (``fc1``'s
        outputs, ``fc2``'s inputs) split over ``axis``."""
        self.tp = axis

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return self.fc2(self.act(self.fc1(hidden_states)))
        return tp_row_linear(self.act(self.fc1(tp_copy(hidden_states, self.tp))), self.fc2, self.tp)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, hidden_size, num_heads, intermediate_size, hidden_act, layer_norm_eps):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(hidden_size, eps=layer_norm_eps)
        self.self_attn = CLIPAttention(hidden_size, num_heads)
        self.layer_norm2 = nn.LayerNorm(hidden_size, eps=layer_norm_eps)
        self.mlp = CLIPMLP(hidden_size, intermediate_size, hidden_act)

    def forward(self, hidden_states: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        hidden_states = hidden_states + self.self_attn(self.layer_norm1(hidden_states), causal_mask)
        return hidden_states + self.mlp(self.layer_norm2(hidden_states))


class CLIPEmbeddings(nn.Module):
    def __init__(self, vocab_size: int, hidden_size: int, max_position_embeddings: int):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, hidden_size)
        self.position_embedding = nn.Embedding(max_position_embeddings, hidden_size)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        positions = torch.arange(input_ids.shape[1], device=input_ids.device)
        return self.token_embedding(input_ids) + self.position_embedding(positions)[None]


class CLIPEncoder(nn.Module):
    def __init__(self, num_hidden_layers: int, **layer_kw):
        super().__init__()
        self.layers = nn.ModuleList(
            [CLIPEncoderLayer(**layer_kw) for _ in range(num_hidden_layers)]
        )


class CLIPTextTransformer(nn.Module):
    def __init__(
        self, vocab_size, hidden_size, intermediate_size, num_hidden_layers,
        num_attention_heads, max_position_embeddings, hidden_act, layer_norm_eps,
    ):
        super().__init__()
        self.embeddings = CLIPEmbeddings(vocab_size, hidden_size, max_position_embeddings)
        self.encoder = CLIPEncoder(
            num_hidden_layers, hidden_size=hidden_size, num_heads=num_attention_heads,
            intermediate_size=intermediate_size, hidden_act=hidden_act,
            layer_norm_eps=layer_norm_eps,
        )
        self.final_layer_norm = nn.LayerNorm(hidden_size, eps=layer_norm_eps)

    def forward(self, input_ids: torch.Tensor, output_hidden_states: bool = False):
        s = input_ids.shape[1]
        hidden_states = self.embeddings(input_ids)
        causal_mask = torch.full(
            (s, s), torch.finfo(torch.float32).min, device=input_ids.device
        ).triu(1)
        all_hidden = [hidden_states]
        for layer in self.encoder.layers:
            hidden_states = layer(hidden_states, causal_mask)
            all_hidden.append(hidden_states)
        last = self.final_layer_norm(hidden_states)
        return last, (tuple(all_hidden) if output_hidden_states else None)


class _TextOutput:
    """Tuple-and-attribute output mirroring transformers' model output
    (callers index ``[0]`` for the last hidden state)."""

    def __init__(self, last_hidden_state, pooler_output=None, hidden_states=None):
        self.last_hidden_state = last_hidden_state
        self.pooler_output = pooler_output
        self.hidden_states = hidden_states

    def __getitem__(self, idx):
        return (self.last_hidden_state, self.pooler_output, self.hidden_states)[idx]


def _pool_eos(last_hidden_state: torch.Tensor, input_ids: torch.Tensor, eos_token_id: int):
    """CLIP pooling: the hidden state at the EOS token.

    transformers keeps a legacy path for ``eos_token_id == 2`` (the value in
    SDXL's text_encoder_2 config): pool at ``input_ids.argmax(-1)``, the
    highest token id, which is the EOT token of CLIP vocabularies, instead of
    the first literal EOS match.
    """
    if eos_token_id == 2:
        eos_pos = input_ids.argmax(dim=-1)
    else:
        # argmax returns the first maximal index, as jnp.argmax does
        eos_pos = (input_ids == eos_token_id).int().argmax(dim=-1)
    rows = torch.arange(last_hidden_state.shape[0], device=last_hidden_state.device)
    return last_hidden_state[rows, eos_pos]


class CLIPTextModel(ConfigurableMixin, nn.Module):
    """``model(input_ids)[0]`` is the last hidden state; ``.pooler_output``
    the EOS-pooled one. Built on ``device`` (cuda unless told otherwise) in
    ``dtype``."""

    ignore_for_config = ("dtype", "device")

    def __init__(
        self,
        vocab_size: int = 49408,
        hidden_size: int = 768,
        intermediate_size: int = 3072,
        num_hidden_layers: int = 12,
        num_attention_heads: int = 12,
        max_position_embeddings: int = 77,
        hidden_act: str = "quick_gelu",
        layer_norm_eps: float = 1e-5,
        eos_token_id: int = 49407,
        device=None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self._register_config(dict(locals()))
        self.eos_token_id = eos_token_id
        with torch.device(resolve_device(device)):
            self.text_model = CLIPTextTransformer(
                vocab_size, hidden_size, intermediate_size, num_hidden_layers,
                num_attention_heads, max_position_embeddings, hidden_act, layer_norm_eps,
            )
        self.to(dtype)

    def forward(self, input_ids: torch.Tensor, output_hidden_states: bool = False) -> _TextOutput:
        last, all_hidden = self.text_model(input_ids, output_hidden_states)
        pooled = _pool_eos(last, input_ids, self.eos_token_id)
        return _TextOutput(last, pooled, all_hidden)


class _ProjectedTextOutput:
    """Output of the projection variant, as the JAX package's: ``[0]`` is
    ``text_embeds`` (the pooled, projected vector SDXL conditions on), then
    the last hidden state and, if asked for, every layer's."""

    def __init__(self, text_embeds, last_hidden_state, hidden_states=None):
        self.text_embeds = text_embeds
        self.last_hidden_state = last_hidden_state
        self.hidden_states = hidden_states

    def __getitem__(self, idx):
        return (self.text_embeds, self.last_hidden_state, self.hidden_states)[idx]


class CLIPTextModelWithProjection(CLIPTextModel):
    """SDXL's ``text_encoder_2``: the tower, the EOS-pooled hidden state
    through ``text_projection`` (``projection_dim`` outputs, no bias).
    ``model(ids, output_hidden_states=True).hidden_states[-2]`` is the
    penultimate layer the SDXL pipelines condition on."""

    def __init__(
        self,
        vocab_size: int = 49408,
        hidden_size: int = 768,
        intermediate_size: int = 3072,
        num_hidden_layers: int = 12,
        num_attention_heads: int = 12,
        max_position_embeddings: int = 77,
        hidden_act: str = "quick_gelu",
        layer_norm_eps: float = 1e-5,
        eos_token_id: int = 49407,
        projection_dim: int = 512,
        device=None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__(
            vocab_size, hidden_size, intermediate_size, num_hidden_layers, num_attention_heads,
            max_position_embeddings, hidden_act, layer_norm_eps, eos_token_id, device, dtype,
        )
        self._register_config(dict(locals()))
        with torch.device(resolve_device(device)):
            self.text_projection = nn.Linear(hidden_size, projection_dim, bias=False)
        self.to(dtype)

    def forward(
        self, input_ids: torch.Tensor, output_hidden_states: bool = False
    ) -> _ProjectedTextOutput:
        last, all_hidden = self.text_model(input_ids, output_hidden_states)
        pooled = _pool_eos(last, input_ids, self.eos_token_id)
        return _ProjectedTextOutput(self.text_projection(pooled), last, all_hidden)
