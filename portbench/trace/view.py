"""One traced run's Chrome trace, read once, with what the per-layer
readers (``portbench/metrics``) ask of it: the device events and their
launches, the benchmark's spans (``portbench/spans.py``), the kernels that
attention and the optimizer chain launched, the device's busy time and the
traced window, and the breakdown that the result line carries.

Attention's kernels are those launched inside a ``portbench.attention``
span (a forward call, or its recompute in the backward), or inside the
backward of an op launched in a forward span: the autograd engine's
``evaluate_function`` op that carries the forward op's sequence number.
Its work is counted here from each forward call's shapes.
"""

import bisect
from typing import Dict, List, Optional, Tuple

from . import chrome, work

SPAN = "portbench."
ATTENTION = "portbench.attention "
RECOMPUTE = "portbench.attention.recompute "
OPTIMIZER = "portbench.optimizer"
BACKWARD = "autograd::engine::evaluate_function"


def _union(intervals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for start, stop in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], stop)
        else:
            out.append([start, stop])
    return [(a, b) for a, b in out]


class _Cover:
    """Union of intervals on each thread; ``covers(thread, t)``."""

    def __init__(self, spans):
        by: Dict[tuple, list] = {}
        for thread, start, stop in spans:
            by.setdefault(thread, []).append((start, stop))
        self.starts, self.stops = {}, {}
        for thread, intervals in by.items():
            merged = _union(intervals)
            self.starts[thread] = [a for a, _ in merged]
            self.stops[thread] = [b for _, b in merged]

    def covers(self, thread, t) -> bool:
        starts = self.starts.get(thread)
        if not starts:
            return False
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= self.stops[thread][i]


def parse_attention(name: str) -> Dict[str, object]:
    """The fields of a span's name: ``portbench.attention b=2 sq=4096
    sk=77 h=8 d=40 dtype=bfloat16 grad=1``."""
    fields = dict(part.split("=", 1) for part in name.split()[1:])
    out: Dict[str, object] = {k: int(v) for k, v in fields.items() if k != "dtype"}
    out["dtype"] = fields["dtype"]
    return out


def attention_work(call: Dict[str, object]) -> Tuple[work.Work, Optional[work.Work]]:
    """(forward, backward or None) work of one attention call: the forward's
    two products and its exps, q k v read and the output written; the
    backward's four products (dV, dP, dQ, dK: the scores are not counted
    again), q k v, the output and its grad read, dq dk dv written."""
    bh, sq, sk, d = call["b"] * call["h"], call["sq"], call["sk"], call["d"]
    dtype = call["dtype"]
    item = {"bfloat16": 2, "float16": 2, "float32": 4}[dtype]
    fwd = work.Work(4.0 * bh * sq * sk * d, float(bh * sq * sk), item * bh * d * (2 * sq + 2 * sk) + 4 * bh * sq,
                    dtype)
    if not call.get("grad"):
        return fwd, None
    bwd = work.Work(8.0 * bh * sq * sk * d, 0.0, item * bh * d * (6 * sq + 4 * sk) + 4 * bh * sq, dtype)
    return fwd, bwd


class TraceView:
    def __init__(self, trace, steps: int):
        self.trace = chrome.load_trace(trace)
        self.steps = steps
        events = self.trace.get("traceEvents", ())
        self.devices = chrome.device_events(self.trace)
        self.linked = chrome.kernel_ops(self.trace)
        calls = {}
        for e in events:
            if e.get("cat") in chrome.LAUNCH_CATS and "correlation" in e.get("args", {}):
                calls[e["args"]["correlation"]] = ((e.get("pid"), e.get("tid")), e["ts"])
        self.launch = {}  # id(device event) -> (thread, ts of its launching call)
        for e in self.devices:
            corr = e.get("args", {}).get("correlation")
            if corr in calls:
                self.launch[id(e)] = calls[corr]
        self.ops = [e for e in events if e.get("cat") in chrome.OP_CATS and "dur" in e]
        self.spans = [e for e in self.ops if e.get("name", "").startswith(SPAN)]
        self.window = None
        self.peak_flops = None
        self._attention = None

    def close(self) -> None:
        self.trace = self.devices = self.linked = self.ops = None

    # --- spans and the kernels launched inside them ---------------------------

    def spans_named(self, prefix: str) -> List[dict]:
        return [e for e in self.spans if e["name"].startswith(prefix)]

    def launched_within(self, spans) -> List[dict]:
        cover = _Cover(((s.get("pid"), s.get("tid")), s["ts"], s["ts"] + s["dur"]) for s in spans)
        out = []
        for e in self.devices:
            at = self.launch.get(id(e))
            if at is not None and cover.covers(*at):
                out.append(e)
        return out

    def attention(self) -> Tuple[List[dict], List[Tuple[work.Work, Optional[work.Work]]]]:
        """(the device events attention launched, each forward call's work)."""
        if self._attention is None:
            forward = self.spans_named(ATTENTION)
            inside = _Cover(((s.get("pid"), s.get("tid")), s["ts"], s["ts"] + s["dur"]) for s in forward)
            seqs = {e["args"]["Sequence number"] for e in self.ops
                    if e.get("cat") == "cpu_op" and "Sequence number" in e.get("args", {})
                    and not e["name"].startswith(BACKWARD) and inside.covers((e.get("pid"), e.get("tid")), e["ts"])}
            backward = [e for e in self.ops if e["name"].startswith(BACKWARD)
                        and e.get("args", {}).get("Sequence number") in seqs]
            events = self.launched_within(forward + self.spans_named(RECOMPUTE) + backward)
            self._attention = (events, [attention_work(parse_attention(s["name"])) for s in forward])
        return self._attention

    # --- device time -----------------------------------------------------------

    def busy_s(self) -> float:
        return chrome.device_busy(self.trace) / 1e6

    def window_s(self) -> float:
        return chrome.traced_window(self.trace) / 1e6

    def device_ms_per_step(self, events) -> float:
        return sum(e["dur"] for e in events) / 1e3 / self.steps

    def categories_ms(self, categories) -> float:
        return self.device_ms_per_step(e for e in self.devices if chrome.categorize(e["name"]) in categories)

    # --- the breakdown of the result line --------------------------------------

    def breakdown(self, k: int = 10) -> Dict[str, list]:
        """The ``k`` device families that took most time (seconds over the
        traced steps), and the ``k`` longest gaps with no device event,
        each named by the innermost host op (of any thread) open at the
        gap's middle, or by the last one that ended before it."""
        fams: Dict[str, float] = {}
        for e in self.devices:
            f = chrome.family_of(e["name"])
            fams[f] = fams.get(f, 0.0) + e["dur"] / 1e6
        top = sorted(fams.items(), key=lambda kv: -kv[1])[:k]
        busy = _union((e["ts"], e["ts"] + e["dur"]) for e in self.devices)
        gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])), reverse=True)[:k]
        host = sorted(self.ops, key=lambda e: e["ts"])
        named = []
        for length, start, stop in gaps:
            mid = (start + stop) / 2
            inner = last = None
            for e in host:
                if e["ts"] > mid:
                    break
                end = e["ts"] + e["dur"]
                if end >= mid and (inner is None or e["dur"] <= inner["dur"]):
                    inner = e
                elif end < mid and (last is None or end > last["ts"] + last["dur"]):
                    last = e
            name = inner["name"] if inner else f"after {last['name']}" if last else "(no host op)"
            named.append([name, length / 1e6])
        return {"device_ops": [[name, s] for name, s in top], "idle_gaps": named}
