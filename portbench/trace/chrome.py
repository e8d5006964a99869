"""A frozen copy of the port's Chrome-trace reader
(``stable_diffusion_training_tpu_torch/utils/kernel_trace.py``: loading,
device events, kernel families and categories, each device event's
launching op, device busy time, traced window, idle share), kept with the
benchmark so that a change to the program cannot change how it is measured.

Device events are those of category ``kernel``, ``gpu_memcpy`` and
``gpu_memset``. A trace that asked for CUDA activity (it holds CUDA
runtime or CUDA driver API calls, or names a device) but holds no device event
raises: the profiler's CUPTI tracing may give no device time on some
machines, and that must not read as a card that did nothing.
"""

import functools
import gzip
import json
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
OP_CATS = ("cpu_op", "user_annotation")

# the port's kernels, by their names in csrc/ (families: no template
# arguments, no parameter list, no anonymous namespace)
FLASH_FAMILIES = ("bwd_dq_kernel", "bwd_dkv_kernel")  # besides flash_fwd_* and flash_bwd_*
_CONV_MARKS = ("conv", "fprop", "dgrad", "wgrad", "winograd", "implicit_gemm", "cudnn")
_GEMM_MARKS = ("gemm", "gemv", "nvjet", "cutlass", "cublas", "xmma", "splitk")
_COPY_MARKS = ("copy", "transpose", "nchwtonhwc", "nhwctonchw", "tensortransform", "memcpy", "memset")
_NORM_MARKS = ("norm", "rowwisemoments", "computefusedparams", "gammabetabackward", "computeinternalgradients",
               "computegradoutputcoeffs", "backwardfusedparams")
_REDUCE_MARKS = ("reduce", "softmax", "scan")


def load_trace(trace) -> dict:
    """A Chrome trace: ``trace`` itself if it is a dict, else the file at
    that path (``.gz`` read through gzip)."""
    if isinstance(trace, dict):
        return trace
    opener = gzip.open if str(trace).endswith(".gz") else open
    with opener(trace, "rt") as f:
        return json.load(f)


def _asked_for_cuda(trace: dict) -> bool:
    return bool(trace.get("deviceProperties")) or any(
        e.get("cat") in LAUNCH_CATS for e in trace.get("traceEvents", ())
    )


def device_events(trace) -> List[dict]:
    """The device events (kernels, memcpys, memsets) of a trace; raises if
    the trace asked for CUDA activity and holds none."""
    trace = load_trace(trace)
    events = [e for e in trace.get("traceEvents", ()) if e.get("cat") in DEVICE_CATS and "dur" in e]
    if not events and _asked_for_cuda(trace):
        raise ValueError(
            "the trace recorded CUDA activity but holds no kernel, memcpy or memset event: the profiler "
            "gave no device time (CUPTI), which is not a card that did nothing"
        )
    return events


@functools.lru_cache(maxsize=4096)  # a trace names each kernel many times
def family_of(name: str) -> str:
    """A kernel's family: its name without ``void``, template arguments,
    parameter list and anonymous namespace
    (``void (anonymous namespace)::flash_fwd_tma_kernel<64, false>(...)``
    -> ``flash_fwd_tma_kernel``)."""
    text = name.strip()
    if text.startswith("void "):
        text = text[5:]
    out, depth = [], 0
    for ch in text:
        if ch == "<":
            depth += 1
        elif ch == ">" and depth:
            depth -= 1
        elif not depth:
            out.append(ch)
    text = "".join(out).rstrip()
    if text.endswith(")"):  # the last top-level (...)
        depth, i = 0, len(text)
        for i in range(len(text) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(text[i], 0)
            if depth == 0:
                break
        text = text[:i]
    return text.replace("(anonymous namespace)::", "").strip() or name


@functools.lru_cache(maxsize=4096)
def categorize(name: str) -> str:
    """The category of a device event by its name: ``gemm``,
    ``convolution``, ``flash kernel``, ``lion kernel``, ``copy/relayout``,
    ``elementwise``, ``norm``, ``reduce``, ``collective`` or ``other``. The
    port's own kernels by their exact families (``flash_fwd_*``,
    ``flash_bwd_*``, ``bwd_dq_kernel``, ``bwd_dkv_kernel``: ``flash
    kernel``; ``lion_*``: ``lion kernel``), NCCL's as ``collective``, then
    copies, memsets and relayouts, the libraries' convolutions (cuDNN) and
    matmuls (cuBLAS, CUTLASS), norms, reductions and elementwise kernels."""
    family = family_of(name)
    short = family.rsplit("::", 1)[-1]
    if short.startswith(("flash_fwd_", "flash_bwd_")) or short in FLASH_FAMILIES:
        return "flash kernel"
    if short.startswith("lion_"):
        return "lion kernel"
    low, fam = name.lower(), family.lower()
    if "nccl" in low:
        return "collective"
    if any(m in low for m in _COPY_MARKS):
        return "copy/relayout"
    if any(m in fam for m in _CONV_MARKS):
        return "convolution"
    if any(m in fam for m in _GEMM_MARKS):
        return "gemm"
    if any(m in fam for m in _NORM_MARKS):
        return "norm"
    if any(m in fam for m in _REDUCE_MARKS):
        return "reduce"
    if "elementwise" in fam:
        return "elementwise"
    return "other"


def kernel_ops(trace) -> List[Tuple[dict, Optional[dict]]]:
    """Each device event with the op that launched it: the innermost
    ``cpu_op`` or ``user_annotation`` 
    enclosing its CUDA runtime or CUDA driver API call, found by ``correlation``;
    where no such call was traced, the op of its ``External id`` (which
    names an aten op, never an annotation); None where neither is."""
    trace = load_trace(trace)
    events = trace.get("traceEvents", ())
    devs = device_events(trace)
    launches = {
        e["args"]["correlation"]: e for e in events
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})
    }
    ops_by_thread: Dict[tuple, List[dict]] = {}
    by_ext: Dict[int, dict] = {}
    for e in events:
        if e.get("cat") in OP_CATS and "dur" in e:
            ops_by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
            ext = e.get("args", {}).get("External id")
            if ext is not None and e.get("cat") == "cpu_op":
                by_ext.setdefault(ext, e)
    calls: Dict[tuple, List[tuple]] = {}
    for corr, call in launches.items():
        calls.setdefault((call.get("pid"), call.get("tid")), []).append((call["ts"], corr))
    launcher: Dict[int, Optional[dict]] = {}
    for thread, stamps in calls.items():
        # one sweep a thread: ops nest, so the open ones form a stack
        ops = sorted(ops_by_thread.get(thread, ()), key=lambda e: (e["ts"], -e["dur"]))
        stack: List[dict] = []
        i = 0
        for ts, corr in sorted(stamps):
            while i < len(ops) and ops[i]["ts"] <= ts:
                while stack and stack[-1]["ts"] + stack[-1]["dur"] < ops[i]["ts"]:
                    stack.pop()
                stack.append(ops[i])
                i += 1
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < ts:
                stack.pop()
            launcher[corr] = stack[-1] if stack else None
    out = []
    for e in devs:
        args = e.get("args", {})
        corr = args.get("correlation")
        if corr in launcher:
            out.append((e, launcher[corr]))
        else:
            out.append((e, by_ext.get(args.get("External id"))))
    return out


def _union_us(intervals) -> float:
    busy, end = 0.0, None
    for start, stop in sorted(intervals):
        if end is None or start > end:
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy


def device_busy(trace) -> float:
    """µs in which the card ran at least one device event: the union of
    their intervals across streams."""
    return _union_us((e["ts"], e["ts"] + e["dur"]) for e in device_events(trace))


def traced_window(trace) -> float:
    """µs from the trace's first event to the end of its last (host and
    device events; the profiler's own span left out)."""
    trace = load_trace(trace)
    spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in trace.get("traceEvents", ())
             if e.get("ph") == "X" and e.get("cat") != "Trace" and "ts" in e]
    if not spans:
        raise ValueError("the trace holds no timed event")
    return max(stop for _, stop in spans) - min(start for start, _ in spans)
