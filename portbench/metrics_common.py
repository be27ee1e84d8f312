"""Arithmetic that more than one metric reader shares."""

from __future__ import annotations

from functools import lru_cache

from .yardstick import (PEAK_F32_FLOPS, decode_step_model_flops, fused_decode_bound_ms,
                        fused_decode_meta_inputs, memory_kv_model_flops)

K1, K3 = "msda_fwd", "fused_decode_kernel"


def device_idle(run):
    """The share of the traced window in which no operation ran on the
    card, in %."""
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def dispatch_ms(run):
    if run.kind != "serve" or not run.stats["dispatches"]:
        return None
    return 1e3 * run.stats["step_s"] / run.stats["dispatches"]


@lru_cache(maxsize=None)
def _k3_bound_ms(dims: tuple, valid_len: int) -> float:
    return fused_decode_bound_ms(fused_decode_meta_inputs(dims), dims, valid_len)[0]


def k3_dims(run) -> tuple:
    s = run.shapes
    return (run.batch_size, s["G"], s["D"], s["H"], s["depth"], s["Lc"], s["S"], s["F"])


def decode_roofline(run):
    """K3's bound over the traced launches, each at its decode step, over
    their device time, in %. A dispatch's launches follow its proposal
    half's K1 launches, so the step index restarts after each K1; launches
    before the trace's first K1 (a dispatch cut by the window's start) are
    left out."""
    if run.kind != "serve" or run.trace is None:
        return None
    dims = k3_dims(run)
    step, bound_s, device_s = None, 0.0, 0.0
    for name, _, seconds in run.trace["kernels"]:
        if K1 in name:
            step = 0
        elif K3 in name and step is not None:
            step += 1
            bound_s += _k3_bound_ms(dims, step) / 1e3
            device_s += seconds
    return 100.0 * bound_s / device_s if device_s > 0 else None


def serve_mfu(run):
    """Model FLOPs of the videos answered within the window over the
    window's seconds at the f32 peak, in %: per video the proposal half
    (counted on the reference's pass), the memory's K/V for every caption
    layer, and its G event rows through each decode step its dispatch ran."""
    if run.kind != "serve" or run.trace is None or not run.flops_proposal:
        return None
    s = run.shapes
    per_dispatch = {}
    for r in run.records:
        if "events" in r and r["done"] <= run.t_end:
            per_dispatch[r["dispatch"]] = per_dispatch.get(r["dispatch"], 0) + 1
    marks = sorted(run.dispatch_launches)
    total = 0.0
    for d, videos in per_dispatch.items():
        prev = max(m for m in marks if m < d)
        steps = run.dispatch_launches[d] - run.dispatch_launches[prev]
        per_video = run.flops_proposal + memory_kv_model_flops(s["D"], s["depth"], s["S"]) \
            + sum(decode_step_model_flops(s["G"], s["D"], s["depth"], s["F"], s["S"], s["V"], t)
                  for t in range(1, steps + 1))
        total += videos * per_video
    return 100.0 * total / (run.seconds * PEAK_F32_FLOPS)
