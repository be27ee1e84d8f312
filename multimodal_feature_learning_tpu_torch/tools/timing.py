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
