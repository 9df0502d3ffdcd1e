"""Spans around the calls into each layer, and the reading of a
``torch.profiler`` trace of the measured window.

``Spans`` times each span on the host clock and, while a trace runs, also
opens a ``record_function`` of the same name, so the trace places the
device's idle gaps by what the host was doing. The window itself is the
span ``bench.window``.

``summarize`` reads one trace once: the union of the device's operation
intervals inside the window (busy seconds; overlapping kernels count once),
the kernels launched, the device time under each ``bmhrl::`` custom op with
its input shapes (the op's event and every kernel launched under it,
whatever kernel computes it), and the breakdown: the device operations that
took most time and the idle time under each host span.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

WINDOW = "bench.window"


class Spans:
    def __init__(self):
        self.times: Dict[str, List[float]] = defaultdict(list)
        self.tracing = False

    @contextmanager
    def __call__(self, name: str):
        rf = nullcontext()
        if self.tracing:
            from torch.profiler import record_function
            rf = record_function(name)
        t0 = time.perf_counter()
        with rf:
            yield
        self.times[name].append(time.perf_counter() - t0)


def profiler():
    """A profiler of the host and the device that keeps input shapes."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   record_shapes=True)


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: int
    # op name -> [(input shapes, device seconds)] per call
    ops: Dict[str, List[Tuple[list, float]]] = field(default_factory=dict)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def _annotation(e) -> bool:
    """A user annotation (a span), by whichever of the two methods this
    version of the profiler's events has."""
    if hasattr(e, "is_user_annotation"):
        return e.is_user_annotation()
    return "annotation" in getattr(e, "activity_type", lambda: "")()


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def summarize(prof, op_prefix: str = "bmhrl::",
              span_names: Optional[set] = None) -> TraceSummary:
    """Read the trace of one window (module docstring) from the profiler's
    raw events, in one pass. Times in seconds."""
    import torch
    cpu_type = torch.autograd.DeviceType.CPU
    span_names = set(span_names or ()) | {WINDOW}
    w0 = w1 = None
    device, spans = [], []
    cpu_at: Dict[int, Tuple[int, int]] = {}  # correlation -> (thread, ns)
    op_calls = defaultdict(list)  # thread -> [(start, end, name, shapes)]
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() != cpu_type:
            # the device's copies of the host spans are no device work
            if name in span_names or _annotation(e):
                continue
            device.append((e.start_ns(), e.end_ns(), name,
                           e.linked_correlation_id(),
                           not name.startswith(("Memcpy", "Memset"))))
            continue
        if name in span_names:
            spans.append((e.start_ns(), e.end_ns(), name))
            if name == WINDOW:
                w0, w1 = e.start_ns(), e.end_ns()
            continue
        tid = e.start_thread_id()
        cpu_at[e.correlation_id()] = (tid, e.start_ns())
        if name.startswith(op_prefix):
            op_calls[tid].append((e.start_ns(), e.end_ns(), name,
                                  e.shapes()))
    if w0 is None:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    for calls in op_calls.values():
        calls.sort()
    starts = {tid: [c[0] for c in calls] for tid, calls in op_calls.items()}
    per_call = defaultdict(float)  # (thread, index) -> device ns
    intervals, by_name, kernels = [], defaultdict(float), 0
    for s, t, name, corr, is_kernel in device:
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        intervals.append((s, t))
        by_name[name] += (t - s) / 1e9
        kernels += is_kernel
        at = cpu_at.get(corr)
        if at is not None and at[0] in starts:
            i = bisect.bisect_right(starts[at[0]], at[1]) - 1
            if i >= 0 and op_calls[at[0]][i][1] >= at[1]:
                per_call[(at[0], i)] += t - s
    ops = defaultdict(list)
    for tid, calls in op_calls.items():
        for i, (s, _, name, shapes) in enumerate(calls):
            if w0 <= s < w1:
                ops[name].append((shapes, per_call[(tid, i)] / 1e9))
    busy = _union(intervals)
    busy_s = sum(t - s for s, t in busy) / 1e9
    # idle gaps, each charged to the innermost (shortest) span open at its
    # middle: the spans' edges cut the window into pieces of one label
    bounds = sorted({x for s, t, _ in spans for x in (s, t)})
    labels = []
    for a, b in zip(bounds, bounds[1:]):
        mid = (a + b) / 2
        inner = [(t - s, n) for s, t, n in spans if s <= mid < t]
        labels.append(min(inner)[1] if inner else "other")
    idle = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        i = bisect.bisect_right(bounds, (a + b) / 2) - 1
        idle[labels[i] if 0 <= i < len(labels) else "other"] += (b - a) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return TraceSummary(window_s=(w1 - w0) / 1e9, busy_s=busy_s,
                        kernels=kernels, ops=dict(ops),
                        device_ops=[[n[:120], v] for n, v in top],
                        idle_gaps=[[n, v] for n, v in gaps])


def roofline_share(summary: TraceSummary, op: str, cost_s) -> Optional[float]:
    """Percent of the roofline reached by every call of the custom op
    ``op`` in the window: the sum of ``cost_s(shapes)`` over the calls
    against the device time under them. None when the op did not run."""
    calls = summary.ops.get(op)
    if not calls:
        return None
    device = sum(t for _, t in calls)
    if device <= 0:
        return None
    return 100.0 * sum(cost_s(shapes) for shapes, _ in calls) / device
