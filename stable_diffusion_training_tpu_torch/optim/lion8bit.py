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
(``models.hf_io.jax_param_paths``).

The default (``use_pallas`` None or True) sends quantized leaves through the
fused kernel (``ops.lion_kernel``), which takes the Pallas kernels'
numerics: the grad is upcast to f32 before ``(1 - b1) g`` and the update
sign comes back in the grad's dtype. Every leaf whose JAX block is
``block_size`` output channels at one torch column (a Dense or Conv kernel
whose axis 0 ``block_size`` divides) or whose layouts agree goes into one
``LeafTable`` per grad dtype, built at the first update and kept while the
state holds the same codes and scales: one launch of
``lion8bit_update_leaves_`` a step, the grads read and the update signs
written in torch layout, no permute copy. Any other quantized leaf is
permuted into JAX order (a copy) and takes ``lion8bit_update_`` (counted
there), its update coming back through the inverse permutation as a view.
``bucket_max_nb`` is accepted and changes nothing: the result is bitwise
the same for any value. ``use_pallas=False`` is the JAX package's jnp path,
an explicit, non-default choice of the plain math: the grad keeps its dtype
in ``(1 - b1) g`` and the update is f32.

Under FSDP or TP (``plan``, a ``parallel.sharding.ShardPlan``) ``init_fn``
and ``update_fn`` run on each rank's local leaves. A leaf that the plan's
co-sharding rule splits keeps the reference momentum of its local range,
which is exactly its blocks of the whole leaf's, and takes the same routes
as a whole leaf: each rank's update is then bitwise the one-process update
of its blocks. A split quantized leaf the rule refuses keeps its whole
momentum on every rank: its grad is gathered, it takes the single-leaf
route, and the rank keeps its range of the update. A leaf the plan does not
split (under TP) is whole on every rank, and so is its momentum. Under TP
with FSDP a leaf split over both axes keeps the blocks of its local leaf
(``parallel.sharding.NestedMomentumShard``: for a row-split kernel a
strided set of block ranges of the whole leaf's), which the leaf table
takes as it takes any local leaf. The JAX
package keeps every momentum whole under TP (``set_lion_tp_mesh``): the same
numbers, placed otherwise.
"""

from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Union

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


# copies of quantized leaves' grads made before the kernel path's launches
# (a permute into JAX order, or a strided or misaligned grad made contiguous
# at an aligned address), counted as the kernels count their launches
GRAD_COPIES = {"count": 0}


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
    plan=None,
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
    # split quantized leaves whose momentum stays whole on every rank: {name: RowShard}
    whole = {} if plan is None else {
        name: rows for name, rows in plan.rows.items() if plan.momentum(name, block_size) is None
    }
    zero_code = int(lion_kernel.quantize(torch.zeros((), dtype=torch.float32)))

    def to_jax(name: str, t: torch.Tensor) -> torch.Tensor:
        perm = orders.get(name)
        return (t.permute(*perm) if perm else t).contiguous()

    def from_jax(name: str, t: torch.Tensor) -> torch.Tensor:
        perm = orders.get(name)
        return t.permute(*lion_kernel.inverse_permutation(perm)) if perm else t

    def init_fn(params):
        mask = excluded_layer_mask
        if mask is None or isinstance(mask, bool):
            mask = {name: bool(mask) for name in params}
        mu = {}
        for name, p in params.items():
            if not mask[name]:
                mu[name] = torch.zeros_like(p, dtype=torch.float32)
                continue
            numel = p.numel() if plan is None or name not in plan.rows else plan.rows[name].shape.numel()
            if numel % block_size:
                # same loud failure as the reference's reshape(-1, block_size)
                raise TypeError(
                    f"parameter at {name} has {numel} elements, not divisible by "
                    f"block_size={block_size}; add it to the quantization exclusion list"
                )
            n_blocks = (numel if name in whole else p.numel()) // block_size
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

    # the kernel path's leaf tables, built at the first update and kept
    # while the state holds the same codes and scales tensors:
    # {(leaf names, grad dtype): LeafTable}
    tables: Dict[tuple, lion_kernel.LeafTable] = {}
    takes: Dict[tuple, bool] = {}  # (name, shape): whether a leaf table takes the leaf

    def table_takes(name, shape):
        key = (name, shape)
        if key not in takes:
            takes[key] = lion_kernel.table_takes(shape, orders.get(name), block_size)
        return takes[key]

    def leaf_table(members, updates, state):
        codes = [state.mu_quant[n].codes for n in members]
        scales = [state.mu_quant[n].scales for n in members]
        key = (tuple(members), updates[members[0]].dtype)
        table = tables.get(key)
        if table is None or not table.matches(codes, scales):
            table = tables[key] = lion_kernel.LeafTable(
                codes, scales, [updates[n].shape for n in members], [orders.get(n) for n in members]
            )
        return table

    def single_leaf(name, g, m):
        """A leaf the table does not take: permuted into JAX order, then one
        launch of its own."""
        gj = to_jax(name, g)
        GRAD_COPIES["count"] += gj is not g
        upd = lion_kernel.lion8bit_update_(gj, m.codes, m.scales, b1, b2, compander)
        return from_jax(name, upd), m

    def update_fn(updates, state, params=None):
        new_updates, new_mu = {}, {}
        tabled = []
        for name, g in updates.items():
            m = state.mu_quant[name]
            if not isinstance(m, QuantizedMomentum):
                new_updates[name], new_mu[name] = _lion_core(g, m, b1, b2)
            elif name in whole:  # every rank updates the whole leaf, keeps its range
                rows = whole[name]
                upd, new_mu[name] = (single_leaf if kernel_path else plain_leaf)(name, rows.gather(g), m)
                new_updates[name] = rows.take(upd)
            elif not kernel_path:
                new_updates[name], new_mu[name] = plain_leaf(name, g, m)
            elif table_takes(name, g.shape):
                tabled.append(name)
            else:  # bs does not divide its axis 0
                new_updates[name], new_mu[name] = single_leaf(name, g, m)
        by_dtype = {}  # one table, and one launch, per grad dtype
        for name in tabled:
            by_dtype.setdefault(updates[name].dtype, []).append(name)
        for members in by_dtype.values():
            # the kernel reads torch layout from 16-byte aligned starts: only a
            # strided grad, or a view at another offset, is copied
            grads = [updates[name] for name in members]
            copied = [not g.is_contiguous() or g.data_ptr() % 16 for g in grads]
            if any(copied):
                GRAD_COPIES["count"] += sum(map(bool, copied))
                grads = [g.clone(memory_format=torch.contiguous_format) if c else g for g, c in zip(grads, copied)]
            upds = lion_kernel.lion8bit_update_leaves_(
                grads, leaf_table(members, updates, state), b1, b2, compander
            )
            for name, upd in zip(members, upds):
                new_updates[name], new_mu[name] = upd, state.mu_quant[name]
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
    plan=None,
) -> GradientTransformation:
    """Lion with int8 momentum: quantized Lion -> decoupled weight decay
    (``mask`` selects the leaves) -> negated learning rate. The default
    ``block_size`` is 64 here and 16 in ``scale_by_lion_8bit``, as in the
    JAX package."""
    return transforms.chain(
        scale_by_lion_8bit(
            b1=b1, b2=b2, block_size=block_size, excluded_layer_mask=excluded_layer_mask,
            use_pallas=use_pallas, bucket_max_nb=bucket_max_nb, compander=compander,
            momentum_layout=momentum_layout, leaf_orders=leaf_orders, plan=plan,
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
