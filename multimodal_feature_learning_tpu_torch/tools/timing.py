"""Clocks shared by the tools."""

from __future__ import annotations

import time

import torch


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host_ms(fn, dev: torch.device, n: int = 1, reps: int = 1) -> float:
    """Best over ``reps`` of the mean host-clock milliseconds of ``n`` calls
    of ``fn``, each run of ``n`` ending in a synchronize."""
    best = float("inf")
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        sync(dev)
        best = min(best, (time.perf_counter() - t0) / n)
    return 1e3 * best


def device_ms(fn, dev: torch.device, n: int = 1) -> float:
    """Mean milliseconds of ``n`` calls of ``fn``: CUDA events on the card,
    the host clock around a synchronize elsewhere."""
    if dev.type != "cuda":
        return host_ms(fn, dev, n)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sync(dev)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    sync(dev)
    return start.elapsed_time(end) / n


def device_label(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def graph_call_ms(fn, dev: torch.device, n: int = 50, reps: int = 3, iters: int = 10) -> float:
    """Device milliseconds per call of ``fn``, replayed from a CUDA graph
    that holds ``n`` calls: the best over ``reps`` of the mean over
    ``iters`` replays, CUDA events around them. What the host does to
    launch a call (Python, the binding) is not in it: the replay runs the
    captured kernels back to back. ``fn`` is warmed up on a side stream
    first (kernels are built and loaded there)."""
    if dev.type != "cuda":
        raise ValueError(f"graph timing needs a CUDA device, got {dev}")
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    best = float("inf")
    for _ in range(reps):
        best = min(best, device_ms(graph.replay, dev, iters) / n)
    del graph
    return best


def profiled_kernel_ms(fn, dev: torch.device, match: str, n: int = 20, flush=None):
    """Device milliseconds per call of ``fn`` from torch.profiler over ``n``
    calls: (the kernels whose name contains ``match``, every other device
    operation). ``flush``, when given, runs before each call (for example a
    write over more than the L2 cache, so that each call finds its inputs
    in device memory); its own device time lands in the second number."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            if flush is not None:
                flush()
            fn()
        sync(dev)
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    matched = sum(e.self_device_time_total for e in events if match in e.key)
    other = sum(e.self_device_time_total for e in events if match not in e.key)
    return matched / 1e3 / n, other / 1e3 / n
