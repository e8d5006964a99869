"""8-bit block-quantized Lion optimizer.

Port of ``stable_diffusion_training_tpu/optim/lion8bit.py``
(``scale_by_lion_8bit``, ``lion_8bit``) and of ``optax.lion``, over the
trees of ``optim.transforms``:

- leaves that ``excluded_layer_mask`` selects keep their momentum as int8
  codes and f32 inverse-absmax scales per block of ``block_size``, with the
  signed 5th-power compander, the zero-crossing offset 3.7398995e-09 (zero
  momentum is code 3) and the zero-absmax guard (scale 1); the other leaves
  keep a dense f32 momentum;
- a quantized leaf whose size ``block_size`` does not divide is a loud
  ``TypeError``, as in the JAX package;
- ``compander`` is ``"exact"`` or ``"fast"`` (``ops.lion_kernel``).

Storage is one layout, the reference ``(n_blocks, block_size)`` order *of
the JAX leaf's flat element order*: JAX holds Dense kernels ``(in, out)``
and Conv kernels ``(kh, kw, I, O)`` where torch holds ``(out, in)`` and
``(O, I, kh, kw)``, so 16 consecutive JAX elements are a strided set in
torch memory, and quantizing in torch order would be another optimizer.
``leaf_orders`` gives each leaf's permutation from torch to JAX layout
(``models.hf_io.jax_param_paths``): the grad is permuted into JAX order
(one copy per leaf per step), and the update comes back through the
inverse permutation as a view.

The default (``use_pallas`` None or True) sends quantized leaves through the
fused kernel (``ops.lion_kernel``), which takes the Pallas kernels'
numerics: the grad is upcast to f32 before ``(1 - b1) g`` and the update
sign comes back in the grad's dtype. Leaves with at most ``bucket_max_nb``
blocks update together in one launch (``lion8bit_update_multi_``), the rest
one launch each. ``use_pallas=False`` is the JAX package's jnp path, an
explicit, non-default choice of the plain math: the grad keeps its dtype in
``(1 - b1) g`` and the update is f32.
"""

from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Union

import torch

from ..ops import lion_kernel
from . import transforms
from .transforms import GradientTransformation, weak


@dataclass
class QuantizedMomentum:
    """One leaf's momentum: codes ``(n_blocks, block_size)`` int8 and scales
    ``(n_blocks,)`` f32 over the JAX leaf's flat element order."""

    codes: torch.Tensor
    scales: torch.Tensor


class ScaleByLion8bitState(NamedTuple):
    count: int
    mu_quant: Dict[str, Union[torch.Tensor, QuantizedMomentum]]
    mu_quant_flag: Dict[str, bool]


def _inverse(perm: Sequence[int]) -> List[int]:
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return inv


def _lion_core(g: torch.Tensor, mu: torch.Tensor, b1: float, b2: float):
    """Update direction and new momentum of one leaf, with JAX's weak-typed
    scalars: ``(1 - b1) g`` stays in the grad's dtype."""
    return (
        torch.sign(weak(1.0 - b1, g) * g + weak(b1, mu) * mu),
        weak(1 - b2, g) * g + weak(b2, mu) * mu,
    )


def scale_by_lion_8bit(
    b1: float = 0.9,
    b2: float = 0.99,
    block_size: int = 16,
    excluded_layer_mask: Optional[Union[bool, Dict[str, bool]]] = None,
    use_pallas: Optional[bool] = None,
    bucket_max_nb: int = 0,
    compander: str = "exact",
    momentum_layout: str = "auto",
    leaf_orders: Optional[Dict[str, Optional[Sequence[int]]]] = None,
) -> GradientTransformation:
    """Lion update direction with int8 block-quantized momentum.

    ``excluded_layer_mask``: ``{name: bool}`` (or one bool for every leaf);
    True leaves get quantized momentum. ``leaf_orders``: ``{name: perm}``
    taking each torch leaf to the JAX layout (``permute(perm)``); a missing
    or None entry is the identity. ``momentum_layout="reference"`` is the
    JAX package's strict-faithful anchor: the jnp path with the exact
    compander (the port's storage is that order anyway)."""
    fast = lion_kernel.fast_compander(compander)
    if momentum_layout not in ("auto", "reference"):
        raise ValueError(f"unknown momentum_layout {momentum_layout!r}; use 'auto' or 'reference'")
    if momentum_layout == "reference":
        if use_pallas or fast:
            raise ValueError(
                "momentum_layout='reference' is the strict-faithful anchor: "
                "jnp path with the exact compander only"
            )
        use_pallas = False
    kernel_path = use_pallas is None or use_pallas
    orders = leaf_orders or {}
    zero_code = int(lion_kernel.quantize(torch.zeros((), dtype=torch.float32)))

    def to_jax(name: str, t: torch.Tensor) -> torch.Tensor:
        perm = orders.get(name)
        return (t.permute(*perm) if perm else t).contiguous()

    def from_jax(name: str, t: torch.Tensor) -> torch.Tensor:
        perm = orders.get(name)
        return t.permute(*_inverse(perm)) if perm else t

    def init_fn(params):
        mask = excluded_layer_mask
        if mask is None or isinstance(mask, bool):
            mask = {name: bool(mask) for name in params}
        mu = {}
        for name, p in params.items():
            if not mask[name]:
                mu[name] = torch.zeros_like(p, dtype=torch.float32)
                continue
            if p.numel() % block_size:
                # same loud failure as the reference's reshape(-1, block_size)
                raise TypeError(
                    f"parameter at {name} has {p.numel()} elements, not divisible by "
                    f"block_size={block_size}; add it to the quantization exclusion list"
                )
            n_blocks = p.numel() // block_size
            mu[name] = QuantizedMomentum(
                torch.full((n_blocks, block_size), zero_code, dtype=torch.int8, device=p.device),
                torch.ones(n_blocks, dtype=torch.float32, device=p.device),
            )
        return ScaleByLion8bitState(count=0, mu_quant=mu, mu_quant_flag=dict(mask))

    def plain_leaf(name, g, m):
        """The JAX package's jnp path for one quantized leaf."""
        gj = to_jax(name, g)
        mu = lion_kernel.dequantize(m.codes, m.scales, fast).reshape(gj.shape)
        upd, mu_new = _lion_core(gj, mu, b1, b2)
        codes, scales = lion_kernel.block_quantize(mu_new, block_size)
        return from_jax(name, upd), QuantizedMomentum(codes, scales)

    def update_fn(updates, state, params=None):
        new_updates, new_mu = {}, {}
        bucket = []
        for name, g in updates.items():
            m = state.mu_quant[name]
            if not isinstance(m, QuantizedMomentum):
                new_updates[name], new_mu[name] = _lion_core(g, m, b1, b2)
            elif not kernel_path:
                new_updates[name], new_mu[name] = plain_leaf(name, g, m)
            elif bucket_max_nb and m.codes.shape[0] <= bucket_max_nb:
                bucket.append(name)
            else:
                upd = lion_kernel.lion8bit_update_(
                    to_jax(name, g), m.codes, m.scales, b1, b2, compander
                )
                new_updates[name], new_mu[name] = from_jax(name, upd), m
        if bucket:
            moms = [state.mu_quant[name] for name in bucket]
            upds = lion_kernel.lion8bit_update_multi_(
                [to_jax(name, updates[name]) for name in bucket],
                [m.codes for m in moms],
                [m.scales for m in moms],
                b1, b2, compander,
            )
            for name, m, upd in zip(bucket, moms, upds):
                new_updates[name], new_mu[name] = from_jax(name, upd), m
        ordered = {name: new_updates[name] for name in updates}
        return ordered, ScaleByLion8bitState(
            count=state.count + 1,
            mu_quant={name: new_mu[name] for name in updates},
            mu_quant_flag=state.mu_quant_flag,
        )

    return GradientTransformation(init_fn, update_fn)


def lion_8bit(
    learning_rate: Union[float, Callable[[int], float]],
    b1: float = 0.9,
    b2: float = 0.99,
    block_size: int = 64,
    weight_decay: float = 1e-3,
    mask: Optional[Dict[str, bool]] = None,
    excluded_layer_mask: Optional[Union[bool, Dict[str, bool]]] = None,
    use_pallas: Optional[bool] = None,
    bucket_max_nb: int = 0,
    compander: str = "exact",
    momentum_layout: str = "auto",
    leaf_orders: Optional[Dict[str, Optional[Sequence[int]]]] = None,
) -> GradientTransformation:
    """Lion with int8 momentum: quantized Lion -> decoupled weight decay
    (``mask`` selects the leaves) -> negated learning rate. The default
    ``block_size`` is 64 here and 16 in ``scale_by_lion_8bit``, as in the
    JAX package."""
    return transforms.chain(
        scale_by_lion_8bit(
            b1=b1, b2=b2, block_size=block_size, excluded_layer_mask=excluded_layer_mask,
            use_pallas=use_pallas, bucket_max_nb=bucket_max_nb, compander=compander,
            momentum_layout=momentum_layout, leaf_orders=leaf_orders,
        ),
        transforms.add_decayed_weights(weight_decay, mask),
        transforms.scale_by_learning_rate(learning_rate),
    )


def scale_by_lion(b1: float = 0.9, b2: float = 0.99) -> GradientTransformation:
    """``optax.scale_by_lion`` with its default momentum dtype: the
    params'."""

    def init_fn(params):
        return (0, {name: torch.zeros_like(p) for name, p in params.items()})

    def update_fn(updates, state, params=None):
        count, mu = state
        new_updates, new_mu = {}, {}
        for name, g in updates.items():
            new_updates[name], new_mu[name] = _lion_core(g, mu[name], b1, b2)
        return new_updates, (count + 1, new_mu)

    return GradientTransformation(init_fn, update_fn)


def lion(
    learning_rate: Union[float, Callable[[int], float]],
    b1: float = 0.9,
    b2: float = 0.99,
    weight_decay: float = 1e-3,
    mask: Optional[Dict[str, bool]] = None,
) -> GradientTransformation:
    """``optax.lion``: Lion with a dense momentum in the params' dtype."""
    return transforms.chain(
        scale_by_lion(b1, b2),
        transforms.add_decayed_weights(weight_decay, mask),
        transforms.scale_by_learning_rate(learning_rate),
    )
