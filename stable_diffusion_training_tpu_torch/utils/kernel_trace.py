"""A reader for the Chrome traces that ``torch.profiler`` writes.

Port of ``stable_diffusion_training_tpu/utils/xplane.py``. The JAX package
reads the XSpace protobufs of ``jax.profiler.trace``; the port reads what
``utils.profiling.profiler_trace`` and ``torch.profiler``'s
``export_chrome_trace`` write (a JSON file, gzipped or not): per-kernel
device times, the category each kernel falls in, the op that launched it,
how busy the card was, and a per-category report of a profiled step.

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


def op_durations(trace) -> Dict[str, Tuple[float, int]]:
    """``{name: (total_us, count)}`` over the trace's device events."""
    totals: Dict[str, Tuple[float, int]] = {}
    for e in device_events(trace):
        t, n = totals.get(e["name"], (0.0, 0))
        totals[e["name"]] = (t + e["dur"], n + 1)
    return totals


def top_ops(trace_path, k: int = 10) -> List[Tuple[str, float, int]]:
    """Top-k device ops by total time: ``[(name, total_ms, count), ...]``."""
    ranked = sorted(op_durations(trace_path).items(), key=lambda kv: -kv[1][0])
    return [(name, t / 1e3, n) for name, (t, n) in ranked[:k]]


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
    ``cpu_op`` or ``user_annotation`` (``utils.profiling.annotate_launch``)
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


def idle_share(trace) -> float:
    """1 - ``device_busy`` / ``traced_window``."""
    trace = load_trace(trace)
    return 1.0 - device_busy(trace) / traced_window(trace)


def _collective_streams(devs: List[dict]) -> set:
    """The streams that run collectives and no other kernel (NCCL's own)."""
    coll, other = set(), set()
    for e in devs:
        cat = categorize(e["name"])
        if cat == "collective":
            coll.add((e.get("pid"), e.get("tid")))
        elif e.get("cat") == "kernel":
            other.add((e.get("pid"), e.get("tid")))
    return coll - other


def category_table(trace, steps: int) -> dict:
    """The numbers of ``category_report``: for the serialized device
    events (every stream but the collectives' own) and apart for the
    streams that run collectives alone (they overlap the rest), each
    category's ms a step, share and launches a step; and the busy ms,
    window ms and idle share of the whole trace."""
    trace = load_trace(trace)
    devs = device_events(trace)
    if not devs:
        raise ValueError("the trace holds no device event")
    coll = _collective_streams(devs)
    blocks = {}
    for block, members in (
        ("serialized", [e for e in devs if (e.get("pid"), e.get("tid")) not in coll]),
        ("collective_streams", [e for e in devs if (e.get("pid"), e.get("tid")) in coll]),
    ):
        cats: Dict[str, list] = {}
        for e in members:
            c = cats.setdefault(categorize(e["name"]), [0.0, 0])
            c[0] += e["dur"]
            c[1] += 1
        total = sum(us for us, _ in cats.values()) / 1e3 / steps
        blocks[block] = dict(
            total_ms=total,
            categories={
                c: dict(ms=us / 1e3 / steps, share=us / 1e3 / steps / max(total, 1e-9), launches=n // steps)
                for c, (us, n) in sorted(cats.items(), key=lambda kv: -kv[1][0])
            },
        )
    busy, window = device_busy(trace) / 1e3, traced_window(trace) / 1e3
    return dict(blocks, busy_ms=busy / steps, window_ms=window / steps, idle_share=1.0 - busy / window)


def category_roofline(index, steps: int) -> Dict[str, dict]:
    """Per category, the roofline of the ops of ``index``
    (``roofline.parse_ops``) whose work is counted, each op in the category
    of most of its device time: the ops, their bound and device ms a step,
    and the share."""
    roof: Dict[str, dict] = {}
    for op_id in index.work:
        by_cat: Dict[str, float] = {}
        for e in index.kernels[op_id]:
            by_cat[categorize(e["name"])] = by_cat.get(categorize(e["name"]), 0.0) + e["dur"]
        r = roof.setdefault(max(by_cat, key=by_cat.get), dict(ops=0, bound_ms=0.0, device_ms=0.0))
        r["ops"] += 1
        r["bound_ms"] += index.bound_ms(op_id) / steps
        r["device_ms"] += index.device_ms(op_id) / steps
    for r in roof.values():
        r["share"] = r["bound_ms"] / r["device_ms"] if r["device_ms"] > 0 else None
    return roof


def category_report(trace_path, steps: int, wall_ms: float = None, top_families: int = 3, index=None) -> str:
    """Render the per-category table of a traced run (``category_table``):
    ms a step, share and launches a step by category, the top families of
    the largest categories, the collective streams apart, the roofline of
    the counted ops (``category_roofline`` of ``index``, or of
    ``roofline.parse_ops`` of the trace), and the idle share. ``steps`` =
    how many identical steps the trace covered."""
    from .roofline import parse_ops

    trace = load_trace(trace_path)
    table = category_table(trace, steps)
    roof = category_roofline(parse_ops(trace) if index is None else index, steps)
    devs = device_events(trace)
    coll = _collective_streams(devs)
    lines_out = []
    for block, label in (("serialized", "serialized (device events)"),
                         ("collective_streams", "collective streams (overlaps)")):
        cats = table[block]["categories"]
        if not cats:
            lines_out.append(f"[{label}] no events")
            continue
        grand = table[block]["total_ms"]
        wall = f" (wall {wall_ms:.1f} ms/step)" if wall_ms else ""
        lines_out.append(f"\n[{label}] total {grand:.1f} ms/step{wall}:")
        for c, row in cats.items():
            ms = row["ms"]
            lines_out.append(f"  {ms:8.1f} ms/step  {100 * ms / max(grand, 1e-9):5.1f}%  x{row['launches']:<6d} {c}")
        in_block = [e for e in devs if ((e.get("pid"), e.get("tid")) in coll) == (block == "collective_streams")]
        for big in list(cats)[:top_families]:
            fams: Dict[str, list] = {}
            for e in in_block:
                if categorize(e["name"]) != big:
                    continue
                f = fams.setdefault(family_of(e["name"]), [0.0, 0, e["name"], 0.0])
                f[0] += e["dur"]
                f[1] += 1
                if e["dur"] > f[3]:
                    f[2], f[3] = e["name"], e["dur"]
            lines_out.append(f"  top families in '{big}':")
            for fam, (us, n, sample, _) in sorted(fams.items(), key=lambda kv: -kv[1][0])[:6]:
                short = sample if len(sample) <= 120 else sample[:117] + "..."
                lines_out.append(f"    {us / 1e3 / steps:8.2f} ms/step x{n // steps:<6d} {fam}  e.g. {short}")
    if roof:
        lines_out.append("\n[roofline] ops whose work is counted (utils.roofline), by category:")
        for c, r in sorted(roof.items(), key=lambda kv: -kv[1]["device_ms"]):
            share = "n/a" if r["share"] is None else f"{r['share']:.3f}"
            lines_out.append(
                f"  {r['device_ms']:8.2f} ms/step  bound {r['bound_ms']:8.2f} ms/step  share {share}  "
                f"x{r['ops'] // steps:<6d} {c}"
            )
    lines_out.append(
        f"\ndevice busy {table['busy_ms']:.1f} ms/step of a {table['window_ms']:.1f} ms/step window: "
        f"idle share {table['idle_share']:.3f}"
    )
    return "\n".join(lines_out)

