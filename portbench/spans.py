"""The port's own spans (``utils/observability.py::SPANS``) on the device
trace's timeline. ``SpanWindow`` is ``trace.Window`` with the port's span
recorder on over the block. Its ``summary`` is ``trace.reduce_events``'s
reduction, the same in every key but ``idle_gaps``: there an idle gap at
whose midpoint no CUDA call is open takes the name of the innermost program
span open there, and keeps "none" only where no span is. It adds
``place``'s keys: the spans and what they measure.

The readers at the end compute the span metrics from such a summary; each
returns None where the summary holds no spans to read (a traced window
without the recorder, or a port that records none)."""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from .trace import DEVICE_KINDS, HOST_KINDS, Window, event_kind, reduce_events

Interval = Tuple[int, int]


def port_spans():
    """The port's span recorder: the one object of the port this module
    reaches."""
    from multimodal_feature_learning_tpu_torch.utils.observability import SPANS

    return SPANS


class SpanWindow(Window):
    """``trace.Window`` that records the port's spans over the block (with
    ``recorder`` False it records none: the plain traced window) and places
    them on the trace (``place``)."""

    def __init__(self, enabled: bool, recorder: bool = True):
        super().__init__(enabled)
        self.recording = port_spans().recording() if enabled and recorder else None
        self.spans = []

    def __enter__(self):
        if self.recording is not None:
            self.recording.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        t1 = time.time_ns()
        if self.recording is not None:
            self.recording.__exit__(None, None, None)
            self.spans = port_spans().take()
        if self.enabled:
            import torch

            torch.cuda.synchronize()
            self.prof.__exit__(*exc)
            if exc[0] is None:
                events = self.prof.profiler.kineto_results.events()
                self.summary = reduce_events(events, self.t0, t1)
                self.summary.update(place(events, self.t0, t1, self.spans))
            del self.prof


def host_thread(e) -> int:
    """The thread that made a CUDA API call, as the low 32
    bits of its pthread id: the profiler gives that as the call's resource
    id (a signed 32-bit int)."""
    return e.device_resource_id() & 0xFFFFFFFF


def split(events) -> Tuple[List[tuple], List[tuple]]:
    """(device operations [(start, end, name, kind)], host CUDA calls
    [(start, end, name, thread)]), each sorted, in ns."""
    device, host = [], []
    for e in events:
        kind = event_kind(e)
        if kind in DEVICE_KINDS:
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), kind))
        elif kind in HOST_KINDS:
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), host_thread(e)))
    device.sort()
    host.sort()
    return device, host


def idle_gaps(device, host, t0: int, t1: int) -> List[tuple]:
    """The window's idle gaps [(start, end, the CUDA call open at the
    midpoint or None)], as ``trace.reduce_events`` finds them."""
    cursor, gaps = t0, []
    for start, end, _, _ in device:
        s, t = max(start, t0), min(end, t1)
        if t <= s:
            continue
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, t)
    if t1 > cursor:
        gaps.append((cursor, t1))
    starts = [h[0] for h in host]
    out = []
    for g0, g1 in gaps:
        mid, call = (g0 + g1) // 2, None
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 64, -1), -1):
            if host[j][1] >= mid:
                call = host[j][2]
                break
        out.append((g0, g1, call))
    return out


def innermost(points: List[int], spans) -> List[Optional[str]]:
    """For each of the sorted ``points``, the name of the innermost span
    open there (the latest to start), or None."""
    spans = sorted(spans, key=lambda s: s.start_ns)
    out, active, k = [], [], 0
    for p in points:
        while k < len(spans) and spans[k].start_ns <= p:
            active.append(spans[k])
            k += 1
        active = [s for s in active if s.end_ns > p]
        out.append(max(active, key=lambda s: s.start_ns).name if active else None)
    return out


def merged(intervals) -> List[Interval]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def intersect(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def length_s(intervals: List[Interval]) -> float:
    return sum(b - a for a, b in intervals) / 1e9


def place(events, t0: int, t1: int, spans) -> dict:
    """The spans against the trace of the window [t0, t1] (ns on
    ``time.time_ns``'s clock, the clock of both):

    - ``idle_gaps``: ``reduce_events``'s, each gap with no CUDA call at its
      midpoint named by the innermost span open there on a thread;
    - ``idle_unattributed_share``: the share of the idle time still "none";
    - ``program_spans``: {name: {count, mean_ms, total_ms}} of the spans
      that started in the window (host time);
    - ``runtime_calls_in_spans``: the share of the CUDA calls of the
      threads that hold spans that begin inside a span of their own thread;
      ``runtime_calls``: how many such calls, and
      ``runtime_calls_other_threads``: how many calls other threads made
      (the autograd engine's, for one);
    - ``idle_in_decode_s``: seconds in which the card is idle, a
      ``model.decode`` span is open and no CUDA call is;
    - ``spans``: the spans themselves, for the readers below."""
    device, host = split(events)
    gaps = idle_gaps(device, host, t0, t1)
    threaded = [s for s in spans if s.thread is not None]
    unnamed = [(g0 + g1) // 2 for g0, g1, call in gaps if call is None]
    names = iter(innermost(unnamed, threaded))
    idle_by: Dict[str, float] = defaultdict(float)
    for g0, g1, call in gaps:
        idle_by[call or next(names) or "none"] += (g1 - g0) / 1e9
    idle = sum(idle_by.values())
    stats: Dict[str, list] = defaultdict(list)
    for s in spans:
        if t0 <= s.start_ns <= t1:
            stats[s.name].append((s.end_ns - s.start_ns) / 1e6)
    tops: Dict[int, List[Interval]] = defaultdict(list)
    for s in threaded:
        if s.parent is None:
            tops[s.thread & 0xFFFFFFFF].append((s.start_ns, s.end_ns))
    tops = {tid: merged(v) for tid, v in tops.items()}
    covered = counted = other = 0
    for start, _, _, tid in host:
        if not t0 <= start <= t1:
            continue
        if tid not in tops:
            other += 1
            continue
        counted += 1
        iv = tops[tid]
        i = bisect.bisect_right(iv, (start, float("inf"))) - 1
        covered += i >= 0 and iv[i][1] >= start
    decode = merged((s.start_ns, s.end_ns) for s in threaded if s.name == "model.decode")
    idle_decode = intersect(merged((g0, g1) for g0, g1, _ in gaps), decode)
    calls = merged((h[0], h[1]) for h in host)
    return {
        "idle_gaps": [[n, s] for n, s in sorted(idle_by.items(), key=lambda kv: -kv[1])[:10]],
        "idle_unattributed_share": idle_by.get("none", 0.0) / idle if idle > 0 else None,
        "program_spans": {n: {"count": len(v), "mean_ms": sum(v) / len(v), "total_ms": sum(v)}
                          for n, v in sorted(stats.items())},
        "runtime_calls_in_spans": covered / counted if counted else None,
        "runtime_calls": counted, "runtime_calls_other_threads": other,
        "idle_in_decode_s": length_s(idle_decode) - length_s(intersect(idle_decode, calls)),
        "spans": list(spans),
    }


# -- the span metrics, from a ``place``d summary ------------------------------


def _total_ms(trace, *names) -> float:
    return sum((s.end_ns - s.start_ns) / 1e6 for s in trace["spans"] if s.name in names)


def _count(trace, name: str) -> int:
    return sum(1 for s in trace["spans"] if s.name == name)


def queue_wait_p95_ms(trace):
    """95th percentile of the requests' ``serve.queued`` spans: submit to
    the start of the dispatch that carried each, in ms."""
    waits = [(s.end_ns - s.start_ns) / 1e6 for s in trace.get("spans", ())
             if s.name == "serve.queued"]
    return float(np.percentile(waits, 95)) if waits else None


def decode_ms(trace):
    """``model.decode`` per ``serve.dispatch``, in ms: the decode loop's
    host time, its per-step syncs included."""
    n = _count(trace, "serve.dispatch") if trace.get("spans") else 0
    return _total_ms(trace, "model.decode") / n if n else None


def idle_in_decode(trace):
    """The share of the window in which the card is idle inside the decode
    loop with no CUDA call open, in %."""
    if not trace.get("spans") or not _count(trace, "model.decode"):
        return None
    return 100.0 * trace["idle_in_decode_s"] / trace["window_s"]


def _per_step_ms(trace, *names):
    n = _count(trace, "train.step") if trace.get("spans") else 0
    return _total_ms(trace, *names) / n if n else None


def fetch_wait_ms(trace):
    """``train.fetch`` per ``train.step``, in ms: the host waiting for the
    card's previous step."""
    return _per_step_ms(trace, "train.fetch")


def forward_host_ms(trace):
    """``train.forward`` + ``train.criterion`` per ``train.step``, in ms."""
    return _per_step_ms(trace, "train.forward", "train.criterion")


def backward_host_ms(trace):
    """``train.backward`` per ``train.step``, in ms."""
    return _per_step_ms(trace, "train.backward")


TRAIN_CELLS = ("sparse_dvc.train_b64", "mm_dvc.train_b64")
# name: (unit, the cells that report it, reader)
METRICS = {
    "serve.queue_wait_ms.poisson": ("ms", ("sparse_dvc.serve_poisson",), queue_wait_p95_ms),
    "serve.decode_ms.backlog": ("ms", ("sparse_dvc.serve_backlog",), decode_ms),
    "serve.idle_in_decode.backlog": ("%", ("sparse_dvc.serve_backlog",), idle_in_decode),
    "train.fetch_wait_ms": ("ms", TRAIN_CELLS, fetch_wait_ms),
    "train.forward_host_ms": ("ms", TRAIN_CELLS, forward_host_ms),
    "train.backward_host_ms": ("ms", TRAIN_CELLS, backward_host_ms),
}


def read_metrics(workload: str, trace) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of the span metrics of ``workload`` that
    find something to read in ``trace``."""
    out = {}
    for name, (unit, cells, read) in METRICS.items():
        value = read(trace) if workload in cells and trace is not None else None
        if value is not None:
            out[name] = {"value": value, "unit": unit}
    return out
