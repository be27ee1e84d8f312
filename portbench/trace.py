"""The device trace of a ``--trace 1`` run: torch.profiler over the
measured window, reduced to the device's busy time, the operations that
took the most device time, the longest idle gaps by what the host was
doing, and each kernel's launches (name, start, duration) for the metric
readers."""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cuda_runtime", "cuda_driver")


class Window:
    """Profiles the device over the block (``enabled`` False: does
    nothing). After the block, ``summary`` holds the reduction."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.summary = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        if self.enabled:
            import torch

            torch.cuda.synchronize()
            self.prof.__exit__(*exc)
            if exc[0] is None:
                self.summary = reduce_events(self.prof.profiler.kineto_results.events(),
                                             self.t0, t1)
            del self.prof


def event_kind(e) -> str:
    """A profiler event's kind: a device operation ("kernel", "gpu_memcpy",
    "gpu_memset"), a host call into the CUDA runtime or driver
    ("cuda_runtime"), or another host event. Where the event does not say
    (``activity_type`` is missing from some torch builds), from its device
    and its name."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    if str(e.device_type()).endswith("CUDA"):
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        return "gpu_memset" if name.startswith("Memset") else "kernel"
    return "cuda_runtime" if name.startswith(("cuda", "cu")) else "cpu_op"


def _clip(start: int, end: int, t0: int, t1: int) -> Tuple[int, int]:
    return max(start, t0), min(end, t1)


def reduce_events(events, t0: int, t1: int) -> dict:
    """``busy_s``: the union of the device's operations within [t0, t1];
    ``window_s``; ``device_ops``: the 10 names of most device seconds;
    ``idle_gaps``: idle seconds summed by the host call (CUDA runtime or
    driver) under each gap's midpoint ("none" where the host was in none),
    the 10 largest; ``kernels``: [(name, start_s, seconds)] of every kernel
    that started within the window, in start order, start from t0."""
    device, host = [], []
    for e in events:
        kind = event_kind(e)
        if kind in DEVICE_KINDS:
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), kind))
        elif kind in HOST_KINDS:
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    device.sort()
    host.sort()
    by_name: Dict[str, float] = defaultdict(float)
    busy, cursor, gaps = 0, t0, []
    kernels: List[tuple] = []
    for start, end, name, kind in device:
        s, t = _clip(start, end, t0, t1)
        if t <= s:
            continue
        by_name[name] += (t - s) / 1e9
        if kind == "kernel" and start >= t0:
            kernels.append((name, (start - t0) / 1e9, (end - start) / 1e9))
        if s > cursor:
            gaps.append((cursor, s))
        if t > cursor:
            busy += t - max(s, cursor)
            cursor = t
    if t1 > cursor:
        gaps.append((cursor, t1))
    idle_by: Dict[str, float] = defaultdict(float)
    starts = [h[0] for h in host]
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        name = "none"
        # the host call that spans the midpoint: host calls are short, so
        # it is among the last few that began before it
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 64, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        idle_by[name] += (g1 - g0) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(idle_by.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy / 1e9, "window_s": (t1 - t0) / 1e9,
            "device_ops": [[n, s] for n, s in top], "idle_gaps": [[n, s] for n, s in idle],
            "kernels": kernels}


def kernel_seconds(kernels, pattern: str) -> float:
    """Device seconds of the window's kernels whose name holds ``pattern``."""
    return sum(d for name, _, d in kernels if pattern in name)
