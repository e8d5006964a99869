"""A frozen copy of the port's count of each recorded op's work
(``stable_diffusion_training_tpu_torch/utils/roofline.py``: the H100 peaks,
``op_cost`` for aten matmuls, convolutions and convolution backwards read
from the shapes that ``torch.profiler`` records with ``record_shapes=True``,
and ``parse_ops``), kept with the benchmark. The launch names that the
program's wrappers give their own kernels are not read: the benchmark
counts attention's work itself (``portbench/trace/view.py``).

Bytes count each operand once plus the output once; flops are the products
only (2 per multiply-add). An op's operands that lie in L2 can be read
faster than HBM's rate, and a broadcast operand is counted whole.
"""

import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

# H100 SXM peaks (NVIDIA data sheet, dense): 989 TFLOP/s bf16 (and fp16)
# tensor core, 67 TFLOP/s f32 on the CUDA cores (TF32 would change the
# numerics), 3.35 TB/s HBM3. exp runs on the SFUs: 16 results per clock per
# SM (CUDA programming guide, compute capability 9.0) x 132 SMs x 1.98 GHz
# boost.
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_EXPS = 16 * 132 * 1.98e9
PEAK_BYTES = 3.35e12

# torch.profiler's names of the input types -> (dtype name, bytes)
TRACE_TYPES = {
    "float": ("float32", 4), "c10::BFloat16": ("bfloat16", 2), "c10::Half": ("float16", 2),
    "signed char": ("int8", 1), "unsigned char": ("uint8", 1), "long int": ("int64", 8),
    "int": ("int32", 4), "bool": ("bool", 1), "double": ("float64", 8),
}


def tensor_bytes(dims: Sequence[int], dtype: str) -> int:
    """Bytes of a tensor of ``dims`` and trace type ``dtype`` (0 for what is
    not a tensor: an empty type, ``Scalar``, ``ScalarList``)."""
    if dtype not in TRACE_TYPES:
        return 0
    return math.prod(dims) * TRACE_TYPES[dtype][1]


class Work(NamedTuple):
    """One op's work: tensor-core flops, exps, bytes, and the dtype whose
    peak bounds the flops."""

    flops: float
    exps: float
    bytes: int
    dtype: str

    def bound(self) -> Tuple[float, str]:
        """(ms, "operations" or "bytes"): the larger of the operations'
        time at this dtype's peak and the bytes' at HBM's rate."""
        peak = PEAK_FLOPS.get(self.dtype)
        ops = max(self.flops / peak if peak else 0.0, self.exps / PEAK_EXPS)
        times = {"operations": ops, "bytes": self.bytes / PEAK_BYTES}
        by = max(times, key=times.get)
        return times[by] * 1e3, by


def _dims(event: dict) -> List[list]:
    return event.get("args", {}).get("Input Dims", [])


def _types(event: dict) -> List[str]:
    return event.get("args", {}).get("Input type", [])


def _concrete(event: dict, i: int) -> list:
    """The ``i``-th scalar argument of a recorded op (``'[2, 2]'`` -> [2, 2],
    ``'1'`` -> 1, ``'False'`` -> False)."""
    text = event["args"]["Concrete Inputs"][i]
    if text.startswith("["):
        return [_scalar(t) for t in text.strip("[]").split(",") if t.strip()]
    return _scalar(text)


def _scalar(text: str):
    text = text.strip()
    if text in ("True", "False"):
        return text == "True"
    return int(text)


def _dtype_name(trace_type: str) -> str:
    return TRACE_TYPES.get(trace_type, ("", 0))[0]


def _operand_bytes(event: dict, which: Sequence[int]) -> int:
    dims, types = _dims(event), _types(event)
    return sum(tensor_bytes(dims[i], types[i]) for i in which if i < len(dims))


def _conv_args(event: dict) -> Tuple[list, list, list, int]:
    """(stride, padding, dilation, groups) of a recorded convolution, by
    the op's own argument order."""
    name = event["name"]
    if name in ("aten::convolution", "aten::_convolution"):
        # input, weight, bias, stride, padding, dilation, transposed, output_padding, groups
        if _concrete(event, 6):
            raise ValueError(f"{name}: transposed convolutions are not counted")
        return _concrete(event, 3), _concrete(event, 4), _concrete(event, 5), _concrete(event, 8)
    if name in ("aten::cudnn_convolution", "aten::mkldnn_convolution"):
        # input, weight, [bias,] padding, stride, dilation, groups
        first = 2 if name == "aten::cudnn_convolution" else 3
        padding, stride, dilation = (_concrete(event, first + j) for j in range(3))
        return stride, padding, dilation, _concrete(event, first + 3)
    if name == "aten::convolution_backward":
        # grad_output, input, weight, bias_sizes, stride, padding, dilation, transposed, output_padding,
        # groups, output_mask
        if _concrete(event, 7):
            raise ValueError(f"{name}: transposed convolutions are not counted")
        return _concrete(event, 4), _concrete(event, 5), _concrete(event, 6), _concrete(event, 9)
    raise KeyError(name)


def conv_output_dims(in_dims, w_dims, stride, padding, dilation) -> List[int]:
    """(N, C_out, *spatial) of a convolution of ``in_dims`` (N, C_in,
    *spatial) by ``w_dims`` (C_out, C_in / groups, *kernel)."""
    spatial = [
        (size + 2 * pad - dil * (k - 1) - 1) // st + 1
        for size, k, st, pad, dil in zip(in_dims[2:], w_dims[2:], stride, padding, dilation)
    ]
    return [in_dims[0], w_dims[0], *spatial]


_MATMULS = {  # op -> (index of the left operand, index of the right one, index of an added input or None)
    "aten::mm": (0, 1, None), "aten::bmm": (0, 1, None),
    "aten::addmm": (1, 2, 0), "aten::baddbmm": (1, 2, 0),
}
_CONVS = ("aten::convolution", "aten::_convolution", "aten::cudnn_convolution", "aten::mkldnn_convolution")


def op_cost(event: dict) -> Optional[Work]:
    """The ``Work`` of a recorded op; None for what
    this module does not count, and for an aten op traced without its
    shapes (``record_shapes`` off)."""
    name = event.get("name", "")
    args = event.get("args", {})
    if name in (*_MATMULS, *_CONVS, "aten::convolution_backward") and not (
            "Input Dims" in args and "Input type" in args and "Concrete Inputs" in args):
        return None
    if name in _MATMULS:
        left, right, added = _MATMULS[name]
        dims, types = _dims(event), _types(event)
        a, b = dims[left], dims[right]
        out = [*a[:-1], b[-1]]  # (.., M, K) @ (.., K, N)
        flops = 2.0 * math.prod(out) * a[-1]
        nbytes = _operand_bytes(event, [i for i in (left, right, added) if i is not None])
        nbytes += tensor_bytes(out, types[left])
        return Work(flops, 0.0, nbytes, _dtype_name(types[left]))
    if name in _CONVS:
        dims, types = _dims(event), _types(event)
        stride, padding, dilation, groups = _conv_args(event)
        out = conv_output_dims(dims[0], dims[1], stride, padding, dilation)
        # weight is (C_out, C_in / groups, *kernel): each output element is a
        # dot product over C_in / groups x the kernel's window
        flops = 2.0 * math.prod(out) * math.prod(dims[1][1:])
        has_bias = name in ("aten::convolution", "aten::_convolution", "aten::mkldnn_convolution")
        nbytes = _operand_bytes(event, [0, 1, 2] if has_bias else [0, 1]) + tensor_bytes(out, types[0])
        return Work(flops, 0.0, nbytes, _dtype_name(types[0]))
    if name == "aten::convolution_backward":
        dims, types = _dims(event), _types(event)
        grad_out, inp, weight = dims[0], dims[1], dims[2]
        mask = _concrete(event, 10)
        per_product = 2.0 * math.prod(grad_out) * math.prod(weight[1:])
        flops = per_product * (bool(mask[0]) + bool(mask[1]))
        # read: grad_output; input for the weight grad; weight for the input
        # grad. Written: each grad the mask asks for
        nbytes = tensor_bytes(grad_out, types[0])
        if mask[0]:
            nbytes += tensor_bytes(weight, types[2]) + tensor_bytes(inp, types[1])
        if mask[1]:
            nbytes += tensor_bytes(inp, types[1]) + tensor_bytes(weight, types[2])
        if len(mask) > 2 and mask[2]:
            nbytes += tensor_bytes(grad_out[1:2], types[0])
        return Work(flops, 0.0, nbytes, _dtype_name(types[0]))
    return None


class OpIndex(NamedTuple):
    """The ops of one trace that launched device work, by ``External id``."""

    ops: Dict[int, dict]  # External id -> the op (cpu_op or launch annotation)
    kernels: Dict[int, List[dict]]  # External id -> the device events it launched
    work: Dict[int, Work]  # External id -> its work, where counted

    def bound_ms(self, op_id: int) -> Optional[float]:
        work = self.work.get(op_id)
        return work.bound()[0] if work else None

    def device_ms(self, op_id: int) -> float:
        return sum(e["dur"] for e in self.kernels.get(op_id, ())) / 1e3



def parse_ops(trace, linked: Optional[list] = None) -> OpIndex:
    """Index a Chrome trace (a path, gzipped or not, or the loaded dict):
    each op that launched device events (``utils.kernel_trace.kernel_ops``,
    or ``linked``, its result if the caller has it), with those events and,
    where this module counts it, its work."""
    from .chrome import kernel_ops

    ops: Dict[int, dict] = {}
    kernels: Dict[int, List[dict]] = {}
    for event, op in kernel_ops(trace) if linked is None else linked:
        if op is None:
            continue
        op_id = op.get("args", {}).get("External id", id(op))
        ops[op_id] = op
        kernels.setdefault(op_id, []).append(event)
    work = {}
    for op_id, op in ops.items():
        cost = op_cost(op)
        if cost is not None:
            work[op_id] = cost
    return OpIndex(ops, kernels, work)
