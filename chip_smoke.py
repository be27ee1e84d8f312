#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line with its wall seconds:

1. device: the card's name and power limit (nvidia-smi);
2. build: compile every CUDA kernel of the port with nvcc (sm_90a), one
   nvcc per source, all started together, and print what -Xptxas -v says
   of the MSDA and fused decode kernels (registers, shared memory, spills);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the serving and training paths give it, with its time, the
   plain version's time and the least time the card could take (its
   bound): the MSDA forward (K1) and the MSDA backward (K2) at the
   encoder's and the decoder's calls and on a long pyramid that takes
   their chunked route, each with the schedule its plan chose and its
   device time (from a CUDA graph, and in torch.profiler warm and with L2
   flushed) beside the eager time, the autograd
   Function that joins them against autograd through the plain core, and
   the fused decode step (K3/K4) in both grids, dense and int8 memory K/V,
   with and without the bias column, at decode steps 0, 9 and 18, against
   the bound of its route (3xTF32 tensor cores against the bytes), and the
   device time of each of its stages (a build that times its barriers, the
   phases of one cross-attention unit and of four GEMM tiles); and the
   probe's kernel (K5, x + 1) in f32 and bf16, bitwise at the probe's shape,
   at 1,000,003 elements, on a misaligned view and at 2^26 elements, eager
   and replayed from a CUDA graph beside torch.add (in turns), and at 2^26
   elements against the HBM bound;
4. model: the flagship sparse DVC model at full width (d_model 512, 6+6
   transformer layers, 6 caption layers, vocab 6563) on the card, carrying
   the trained weights of snapshots/conv_e79.npz, loaded strictly;
5. serve: 48 requests through the port's DVCServer (batch 16), with the
   launch counts of every kernel read over exactly those requests;
6. check: the served results are well formed and agree with the port's CPU
   path on a few of them;
7. serve_fused: the same requests with the fused decode step
   (decode_impl "fused"), once per kernel grid ("video", "batch"): the
   kernel must launch once for every decode step of every dispatch;
8. check_fused: on one batch of 16, the fused decode against the plain-op
   decode on the card (k and segments equal, at least 90% of caption rows
   identical), int8 memory K/V against dense, and the fused decode on the
   card against the port's CPU path on a few videos;
9. breakdown: for each decode_impl, where one dispatch's time goes (proposal
   half, greedy decode, device busy share and the largest kernels, from
   torch.profiler);
10. train: 1 + 5 training steps of the full-width model from conv_e79
   through train_one_epoch (batch 16, dropout 0.1, synthetic batches from
   seed 0), with the launch counts of every kernel read over exactly those
   steps, the step time, the matcher's host time, peak memory, and the
   device busy share and largest kernels of one profiled step;
11. train_check: one step of batch 2 with dropout off, from the same weights,
   on the card and on the port's CPU path: equal matchings, losses and
   gradient norm within their tolerances; and, for each encoder MSDA call of
   that step, K2 against the plain backward on the CPU step's own inputs;
12. eval (run after breakdown, on the served model): make_eval_step on one
   synthetic batch of 16 in every val_mode (one_by_one with the plain-op
   and the fused decode, teacher_forcing, beam 4, serve, one_by_one with
   faster_eval) and beam 1: finite losses, K1 once per MSDA call, the fused
   kernel once per decode step, beam 1 equal to greedy;
13. eval_loop (after eval, on the served model): the evaluation loop from
   files to scores on a world written under build/eval_world (a vocab of
   the snapshot's 6563 entries, 64 val videos of 120-900 feature tokens as
   .npy files, 1-10 events each): vocab, dataset, prefetching loader,
   evaluate() and the ActivityNet Captions scorers, batch 16, in three arms
   (one_by_one with the plain-op decode, one_by_one with the fused decode,
   teacher_forcing through inference.main), each with its videos/s, the
   split of each batch's time (loader wait, eval step, host transfer and
   strings), its scoring seconds and its launches: K1 12 times a batch, the
   fused kernel once per decode step, every val key in the submission with
   one row per ground-truth event, finite scores, and the two one_by_one
   arms' timestamps equal and at least 90% of their sentences;
14. eval_loop_check: the world's first 2 videos through evaluate() on the
   card and on the port's CPU path: at least 90% of sentences equal,
   timestamps within 1e-3 x duration, stats within 1e-3 relative;
15. eval_check: forward_eval on a batch of 2 with dropout off, on the card
   and on the port's CPU path: matchings, teacher-forced log-probabilities,
   losses and caption rows (greedy and beam);
16. probe: the per-op overhead probe (tools/probe_op_overhead.py), eager and
   from CUDA graphs, with K5's launches;
17. tools: profile_msda, profile_decode, bench_fused_decode and
   onchip_decode_parity, once each at reduced iteration counts.

Then one JSON line of kernel measurements and, as the last line, a JSON
object naming the device. Any failure exits non-zero without that line, as
does a host without CUDA or a directory without the port's package.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SNAPSHOT = os.path.join(ROOT, "snapshots", "conv_e79.npz")

# f32 peak outside the tensor cores, dense TF32 tensor-core peak and memory
# rate of an H100 SXM at 700 W (NVIDIA's data sheet); the bounds below are
# stated against these
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12

N_REQUESTS = 48
BATCH = 16
N_CHECK = 4  # served videos also run through the port's CPU path


def log(phase: str, seconds: float, **fields) -> None:
    print(json.dumps({"phase": phase, "seconds": round(seconds, 3), **fields}),
          flush=True)


def time_cuda(fn, iters: int = 50, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` launches, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def msda_inputs(B, Q, H, Dh, shapes, P, dtype, seed):
    """value (B,S,H,Dh), loc and aw (B,Q,H,L,P) on the card. Locations
    span [-0.2, 1.2], so some leave [0, 1], and every first point sits on an
    exact integer coordinate (loc * T - 0.5 = k)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    S, L = sum(shapes), len(shapes)
    value = torch.randn((B, S, H, Dh), generator=g, device="cuda").to(dtype)
    loc = torch.rand((B, Q, H, L, P), generator=g, device="cuda") * 1.4 - 0.2
    for l, T in enumerate(shapes):
        k = torch.randint(0, T, (B, Q, H), generator=g, device="cuda")
        loc[:, :, :, l, 0] = (k.float() + 0.5) / T
    aw = torch.randn((B, Q, H, L * P), generator=g, device="cuda").softmax(-1)
    return value, loc.contiguous(), aw.reshape(B, Q, H, L, P).contiguous()


def msda_value_rows(shapes, loc):
    """Distinct value rows (b, s, h) the function needs on these locations:
    for each tap the row at floor(x) and, where x is not a whole number, the
    row after it (x = clip(loc * T - 0.5, 0, T - 1), as the plain core has
    it)."""
    import torch

    B, Q, H, L, P = loc.shape
    needed = torch.zeros((B, sum(shapes), H), dtype=torch.bool, device=loc.device)
    b = torch.arange(B, device=loc.device).view(B, 1, 1, 1).expand(B, Q, H, P)
    h = torch.arange(H, device=loc.device).view(1, 1, H, 1).expand(B, Q, H, P)
    start = 0
    for l, T in enumerate(shapes):
        x = (loc[:, :, :, l, :] * T - 0.5).clamp(0, T - 1)
        i0 = x.floor()
        inside = x > i0
        i0 = i0.long()
        needed[b, start + i0, h] = True
        i1 = (i0 + 1).clamp(max=T - 1)
        needed[b[inside], start + i1[inside], h[inside]] = True
        start += T
    return int(needed.sum())


def msda_bound_ms(value, shapes, loc, aw, out):
    """Least time for the function on these inputs: the value rows that
    these locations touch read once, loc and aw read once, the output
    written once; 5 f32 operations per tap and channel (two products and a
    sum for the lerp, one product and one sum to accumulate) plus 8 per tap
    for its coordinate and weights."""
    Dh = value.shape[3]
    value_bytes = msda_value_rows(shapes, loc) * Dh * value.element_size()
    nbytes = value_bytes + sum(t.numel() * t.element_size() for t in (loc, aw, out))
    taps = loc.numel()
    flops = taps * (5 * Dh + 8)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"),
            value_bytes)


def msda_bwd_bound_ms(value, shapes, loc, aw, g):
    """Least time for the backward on these inputs: the value rows that
    these locations touch and g, loc and aw read once; dvalue (all of it),
    dloc and daw written once; 8 f32 operations per tap and channel (two
    products and two sums for g0 and g1, two products and two sums into
    dvalue) plus 15 per tap (coordinate, weights, dloc, daw)."""
    Dh = value.shape[3]
    value_bytes = msda_value_rows(shapes, loc) * Dh * value.element_size()
    nbytes = value_bytes + sum(t.numel() * t.element_size() for t in (g, loc, aw)) \
        + value.numel() * 4 + 2 * loc.numel() * 4
    flops = loc.numel() * (8 * Dh + 15)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"),
            nbytes)


def msda_device_times(fn, name: str) -> dict:
    """The times of one MSDA wrapper call (``tools/msda_device_time.py``):
    ``ms``, its device time replayed from a CUDA graph of 50 calls (the
    host out of the way); ``kernel_ms`` and ``cold_kernel_ms``, the
    kernel's own time in torch.profiler with the inputs warm in L2 and with
    64 MB written before each call; ``eager_ms``, CUDA events around 50
    eager calls (host-paced where a launch takes longer to issue than the
    kernel to run)."""
    import torch

    from multimodal_feature_learning_tpu_torch.tools.msda_device_time import call_times

    times = call_times(fn, name, torch.device("cuda"))
    times["ms"] = times.pop("graph_ms")
    return times


def msda_calls(model_dims):
    """(name, B, Q, level lengths) of the MSDA calls the kernel lines hold:
    the encoder's and the decoder's at the main path's shapes, and the
    sparse encoder of a longer video's pyramid at B=2, whose rows take the
    kernels' chunked route."""
    B, H, Dh, shapes, P, q_enc, q_dec, q_long, long_shapes = model_dims
    return (("encoder", B, q_enc, shapes), ("decoder", B, q_dec, shapes),
            ("long_pyramid", 2, q_long, long_shapes))


def check_msda_bwd(model_dims):
    """Phase 3: the MSDA backward kernel (K2) against the plain backward at
    the training path's shapes and on the long pyramid, f32: each of
    dvalue, dloc and daw within 1e-5 x its max |ref| (a row's entries are
    summed in an order that changes from run to run). Then the autograd
    Function (K1 forward, K2 backward) against autograd through the plain
    core at a small size whose coordinates keep 0.01 from every whole
    token, where the two differentiate alike: rel 1e-5."""
    import torch

    from multimodal_feature_learning_tpu_torch.ops import msda
    from multimodal_feature_learning_tpu_torch.ops.ms_deform_attn import (
        ms_deform_attn_core, ms_deform_attn_core_backward,
    )

    _, H, Dh, _, P = model_dims[:5]
    cases = []
    for where, B, Q, shapes in msda_calls(model_dims):
        value, loc, aw = msda_inputs(B, Q, H, Dh, shapes, P, torch.float32, seed=Q + 1)
        g = torch.randn((B, Q, H * Dh), generator=torch.Generator(device="cuda").manual_seed(Q),
                        device="cuda")
        got = msda.MSDA_BWD(value, shapes, loc, aw, g)
        ref = ms_deform_attn_core_backward(value, shapes, loc, aw, g)
        torch.cuda.synchronize()
        errs = {}
        for name, a, b in zip(("dvalue", "dloc", "daw"), got, ref):
            err = (a - b).abs().max().item()
            scale = b.abs().max().item()
            if a.shape != b.shape or not err <= 1e-5 * scale:
                raise AssertionError(
                    f"MSDA backward kernel disagrees with the plain backward ({where}, "
                    f"{name}): max abs err {err} > 1e-5 x {scale}")
            errs[name] = {"max_abs_err": err, "max_abs_ref": scale}
        plan = msda.msda_bwd_plan(shapes, B, H, Dh, Q, P)
        times = msda_device_times(lambda: msda.MSDA_BWD(value, shapes, loc, aw, g), "msda_bwd")
        plain_ms = time_cuda(lambda: ms_deform_attn_core_backward(value, shapes, loc, aw, g),
                             iters=10)
        bound_ms, bound_by, nbytes = msda_bwd_bound_ms(value, shapes, loc, aw, g)
        cases.append({
            "call": where, "B": B, "Q": Q, "shapes": list(shapes), "dtype": "float32",
            "schedule": plan.schedule, "plan": vars(plan), "errors": errs,
            "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
            **times, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes,
            "library_ms": None,  # no single PyTorch call computes the MSDA backward
        })
        del value, loc, aw, g, got, ref

    # the Function against autograd through the plain core
    gen = torch.Generator(device="cuda").manual_seed(7)
    small = (5, 3, 2)
    value = torch.randn((2, sum(small), 2, 16), generator=gen, device="cuda")
    x = torch.rand((2, 6, 2, len(small), 3), generator=gen, device="cuda") * 1.4 - 0.2
    T = torch.tensor(small, dtype=torch.float32, device="cuda")[:, None]
    xt = x * T - 0.5
    xt = xt.floor() + (xt - xt.floor()).clamp(0.01, 0.99)
    loc = ((xt + 0.5) / T).contiguous()
    aw = torch.rand(loc.shape, generator=gen, device="cuda")
    g = torch.randn((2, 6, 32), generator=gen, device="cuda")
    leaves = [t.clone().requires_grad_() for t in (value, loc, aw)]
    got = torch.autograd.grad(msda.ms_deform_attn(leaves[0], small, *leaves[1:]), leaves, g)
    leaves = [t.clone().requires_grad_() for t in (value, loc, aw)]
    ref = torch.autograd.grad(ms_deform_attn_core(leaves[0], small, *leaves[1:]), leaves, g)
    function_err = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got, ref))
    if not function_err <= 1e-5:
        raise AssertionError(f"MSDeformAttnFunction's gradients are off by {function_err} "
                             f"of autograd through the plain core")
    return cases, function_err


def check_msda(model_dims):
    """Phase 3: the MSDA kernel against the plain core at the serving path's
    shapes (the encoder's Q = K sparse tokens and the decoder's Q = 20
    queries) and on the long pyramid, f32 and bf16 value."""
    import torch

    from multimodal_feature_learning_tpu_torch.ops import msda
    from multimodal_feature_learning_tpu_torch.ops.ms_deform_attn import ms_deform_attn_core

    _, H, Dh, _, P = model_dims[:5]
    tol = {torch.float32: 1e-5, torch.bfloat16: 2e-2}  # relative to max |out|
    cases = []
    for where, B, Q, shapes in msda_calls(model_dims):
        for dtype in (torch.float32, torch.bfloat16):
            value, loc, aw = msda_inputs(B, Q, H, Dh, shapes, P, dtype, seed=Q)
            got = msda.MSDA_FWD(value, shapes, loc, aw)
            ref = ms_deform_attn_core(value, shapes, loc, aw)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            if got.shape != ref.shape or not err <= tol[dtype] * scale:
                raise AssertionError(
                    f"MSDA kernel disagrees with the plain core ({where}, {dtype}): "
                    f"max abs err {err} > {tol[dtype]} x {scale}")
            plan = msda.msda_fwd_plan(shapes, B, H, Dh, Q, P, value.element_size())
            times = msda_device_times(lambda: msda.MSDA_FWD(value, shapes, loc, aw), "msda_fwd")
            plain_ms = time_cuda(lambda: ms_deform_attn_core(value, shapes, loc, aw), iters=10)
            bound_ms, bound_by, value_bytes = msda_bound_ms(value, shapes, loc, aw, got)
            cases.append({
                "call": where, "B": B, "Q": Q, "shapes": list(shapes),
                "dtype": str(dtype).replace("torch.", ""), "schedule": plan.schedule,
                "plan": vars(plan), "max_abs_err": err, "max_abs_out": scale,
                "tolerance": tol[dtype] * scale, **times, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "value_bytes_needed": value_bytes,
                "value_bytes": value.numel() * value.element_size(),
                "library_ms": None,  # no single PyTorch call computes MSDA
            })
            del value, loc, aw, got, ref
    return cases


FUSED_STEPS = (0, 9, 18)  # decode steps at which the fused kernel is checked
FUSED_TOL = 1e-4          # relative to max |ref| of x_out and of the committed rows


def fused_decode_inputs(dims, bias_col: bool, kv_mode: str, seed: int):
    """Inputs of one fused decode step at ``dims`` on the card, from a seed:
    weights of the scale a trained layer has, memory K/V projected from a
    random memory, caches full of random rows (the kernel may read only the
    positions < valid_len). Event rows take windows of the S tokens, as the
    crop mask makes them; with the bias column, a random context mask blocks
    positions and the crop windows are the zeroed mask. Event 0 of video 0
    has every position blocked."""
    import torch

    from multimodal_feature_learning_tpu_torch.ops import fused_decode as fd

    B, G, D, H, depth, Tc, S, F = dims
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    w = {}
    for name in fd.W_ORDER:
        kind, _, which = name.partition("_")
        width = F if name == "mlp_b1" or name == "mlp_w1" else D
        if which.startswith("w"):
            fan_in = F if name == "mlp_w2" else D
            w[name] = randn(depth, fan_in, width, scale=fan_in ** -0.5)
        elif kind.startswith("ln") and which == "s":
            w[name] = 1.0 + randn(depth, 1, width, scale=0.1)
        else:
            w[name] = randn(depth, 1, width, scale=0.1)
    Sp = fd.padded_len(S)
    mem_k, mem_v = fd.stack_memory_kv(w, randn(B, S, D), Sp)
    k_scales = v_scales = None
    if kv_mode == "int8":
        mem_k, k_scales = fd.quantize_kv_int8(mem_k)
        mem_v, v_scales = fd.quantize_kv_int8(mem_v)
    N = B * G
    tok = torch.arange(S, device="cuda")
    start = torch.randint(0, S - 8, (N, 1), generator=gen, device="cuda")
    length = torch.randint(8, S // 2, (N, 1), generator=gen, device="cuda")
    crop = ~((tok >= start) & (tok < start + length))
    if bias_col:
        pad = torch.rand((N, S), generator=gen, device="cuda") < 0.5
        pad[0] = True
        zeroed = crop
    else:
        pad, zeroed = crop, None
        pad[0] = True
    mask_i8, log_m = fd.decode_masks(pad, zeroed, B, G, Sp)
    return {"x": randn(B, 2 * G, D), "k_caches": randn(depth, B, Tc * G, D),
            "v_caches": randn(depth, B, Tc * G, D), "mem_k": mem_k, "mem_v": mem_v,
            "k_scales": k_scales, "v_scales": v_scales, "mask_i8": mask_i8,
            "log_m": log_m, "weights": w}


def fused_decode_bound_ms(inp, dims, valid_len: int):
    """Least time for one step on these inputs, on the kernel's route: every
    weight, the memory K/V (and scales), mask, log_m and x read once, the
    cache rows of positions < step read once, x_out and the committed rows
    written once, at 3.35 TB/s; against the operations of the products (two
    per multiply-add: per layer the q, k, v (commit rows), o, q', o'
    projections, the MLP, and both attentions over the keys each row reads,
    valid_len own-event keys and Sp memory columns) done three times over,
    as 3xTF32 does, at the TF32 tensor-core peak. Returns (bound ms, what
    bounds it, bytes, flops, and for the record the bound of the same
    operations once in f32 on the CUDA cores)."""
    B, G, D, H, depth, Tc, S, F = dims
    R, Sp = 2 * G, inp["mem_k"].shape[2]
    M = B * R

    def size(t):
        return t.numel() * t.element_size() if t is not None else 0

    nbytes = sum(size(t) for t in inp["weights"].values())
    nbytes += sum(size(inp[k]) for k in ("mem_k", "mem_v", "k_scales", "v_scales",
                                          "mask_i8", "log_m"))
    nbytes += 2 * size(inp["x"])
    row = D * 4
    nbytes += 2 * depth * B * (valid_len - 1) * G * row  # cache rows read
    nbytes += 2 * depth * B * G * row                    # committed rows written
    macs = M * D * D * 4 + 2 * B * G * D * D + 2 * M * D * F \
        + 2 * M * valid_len * D + 2 * M * Sp * D
    flops = 2 * depth * macs
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, 3 * flops / PEAK_TF32_FLOPS
    f32_simt_ms = 1e3 * max(t_bytes, flops / PEAK_F32_FLOPS)
    return (1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"),
            nbytes, flops, f32_simt_ms)


def check_fused_decode(dims, steps_at=FUSED_STEPS):
    """Phase 3: the fused decode kernel (K3/K4) against its plain version on
    the card, at the serving path's shapes: grids "video" and "batch" x memory
    K/V dense and int8 x bias column on and off, at steps 0, 9 and 18. The
    kernel and the plain version start from the same caches; x_out and the
    committed cache rows must agree within FUSED_TOL x max |ref|, and every
    other cache row must be left exactly as it was."""
    import torch

    from multimodal_feature_learning_tpu_torch.ops import fused_decode as fd

    B, G, D, H, depth, Tc, S, F = dims
    lines = []
    seed = 0
    for grid in ("video", "batch"):
        for kv_mode in ("dense", "int8"):
            for bias_col in (False, True):
                seed += 1
                inp = fused_decode_inputs(dims, bias_col, kv_mode, seed)
                steps = []
                for step in steps_at:
                    kw = dict(G=G, num_heads=H, has_bias_col=bias_col)
                    args = lambda kc, vc: (inp["x"], kc, vc, step, step + 1, inp["mem_k"],  # noqa: E731
                                           inp["mem_v"], inp["k_scales"], inp["v_scales"],
                                           inp["mask_i8"], inp["log_m"], inp["weights"])
                    kc0, vc0 = inp["k_caches"], inp["v_caches"]
                    ref, rkc, rvc = fd.fused_decode_step_plain(*args(kc0.clone(), vc0.clone()), **kw)
                    got, gkc, gvc = fd.FUSED_DECODE[grid](*args(kc0.clone(), vc0.clone()), **kw)
                    torch.cuda.synchronize()
                    rows = slice(step * G, (step + 1) * G)
                    errs = {}
                    for name, a, b in (("x_out", got, ref),
                                       ("k_commit", gkc[:, :, rows], rkc[:, :, rows]),
                                       ("v_commit", gvc[:, :, rows], rvc[:, :, rows])):
                        err = (a - b).abs().max().item()
                        scale = b.abs().max().item()
                        if not (torch.isfinite(a).all() and err <= FUSED_TOL * scale):
                            raise AssertionError(
                                f"fused decode kernel disagrees with the plain version "
                                f"({grid}, {kv_mode}, bias {bias_col}, step {step}, {name}): "
                                f"max abs err {err} > {FUSED_TOL} x {scale}")
                        errs[name] = {"max_abs_err": err, "max_abs_ref": scale}
                    for name, a, b in (("k_caches", gkc, kc0), ("v_caches", gvc, vc0)):
                        a, b = a.clone(), b.clone()
                        a[:, :, rows] = b[:, :, rows] = 0
                        if not torch.equal(a, b):
                            raise AssertionError(f"the fused decode kernel wrote {name} rows "
                                                 f"outside the commit rows of step {step}")
                    kc, vc = kc0.clone(), vc0.clone()
                    ms = time_cuda(lambda: fd.FUSED_DECODE[grid](*args(kc, vc), **kw))
                    plain_ms = time_cuda(lambda: fd.fused_decode_step_plain(*args(kc, vc), **kw),
                                         iters=10)
                    bound_ms, bound_by, nbytes, flops, simt_ms = fused_decode_bound_ms(
                        inp, dims, step + 1)
                    steps.append({
                        "step": step, "errors": errs,
                        "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
                        "tolerance": FUSED_TOL * errs["x_out"]["max_abs_ref"],
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "bound_f32_simt_ms": simt_ms,
                        "bytes": nbytes, "flops": flops})
                mid = steps[len(steps) // 2]
                lines.append({
                    "grid": grid, "kv": kv_mode, "bias_col": bias_col,
                    "batch_tile": 1 if grid == "video" else fd.batch_tile_for(B),
                    "max_abs_err": max(c["max_abs_err"] for c in steps),
                    "ms": mid["ms"], "plain_ms": mid["plain_ms"], "bound_ms": mid["bound_ms"],
                    "bound_by": mid["bound_by"], "bound_f32_simt_ms": mid["bound_f32_simt_ms"],
                    "library_ms": None,  # no single PyTorch call computes a decode step
                    "steps": steps})
                del inp
    return lines


def fused_stage_breakdown(dims):
    """Phase 3: where one fused decode step's device time goes, from a build
    of the kernel that records the device clock at each grid barrier
    (``STAGE_TIMING_FLAGS``): per stage (``fd.STAGES``: the eight of a
    layer, with the LayerNorms folded into q_kv, cq_proj and mlp1, and the
    cross-attention as its chunk stage and the combine inside co_proj), the
    mean over the layers, the closing LayerNorm, and the phases of one
    chunk unit, for each grid, at step 9 with dense K/V and no bias
    column."""
    import torch

    from multimodal_feature_learning_tpu_torch.ops import fused_decode as fd

    B, G, D, H, depth, Tc, S, F = dims
    inp = fused_decode_inputs(dims, False, "dense", seed=1)
    out = {}
    for grid in ("video", "batch"):
        kernel = fd.FusedDecodeKernel(grid, "", flags=fd.STAGE_TIMING_FLAGS)
        for _ in range(3):
            kernel(inp["x"], inp["k_caches"], inp["v_caches"], 9, 10, inp["mem_k"],
                   inp["mem_v"], None, None, inp["mask_i8"], inp["log_m"], inp["weights"],
                   G=G, num_heads=H, has_bias_col=False)
        torch.cuda.synchronize()
        out[grid] = kernel.stage_us(depth)
    return out


# the probe's shape; a ragged size that stays in the 50 MB L2 when chained;
# a misaligned view (x[1:] of 1,000,004 elements); and a size beyond L2
PROBE_SHAPES = ((160, 64), (1_000_003,), "misaligned", (1 << 26,))
PROBE_CHAIN_TURNS = 5  # graph timings of K5 and torch.add, in turns (min of each)


def graph_us_per_launch(op, x, n: int = 50) -> float:
    """Microseconds per op replayed from a CUDA graph holding a chain of
    ``n`` ops on ``x`` (the probe's ``graph_ms``: best of 3 reps of 20
    replays)."""
    from multimodal_feature_learning_tpu_torch.tools.probe_op_overhead import graph_ms

    return 1e3 * graph_ms(op, x, n, reps=3, iters=20)[0] / n


def check_probe_add():
    """Phase 3: K5 against its plain version on the card, f32 and bf16,
    bitwise, at every ``PROBE_SHAPES`` entry. Times with CUDA events:
    - (160, 64), the probe's: eager (50 launches) and replayed from a CUDA
      graph (a chain of 50), the plain version's and torch.add(x, 1)'s both
      ways; bound: x read once and the output written once;
    - 1,000,003 elements: a chain of 50 replayed from a graph stays in the
      L2 (8 MB in f32), so it is held against torch.add alone, the two
      timed in turns, and carries no HBM bound;
    - the misaligned view: bitwise only (the kernel's scalar loop);
    - 2^26 elements (512 MB moved in f32): eager launches that each find
      the array cold, K5 and torch.add in turns, against the HBM bound."""
    import torch

    from multimodal_feature_learning_tpu_torch.ops.probe_add import PROBE_ADD, probe_add_plain

    cases = []
    for shape in PROBE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            n = 1_000_004 if shape == "misaligned" else math.prod(shape)
            g = torch.Generator(device="cuda").manual_seed(len(str(shape)))
            x = (torch.randn(n, generator=g, device="cuda")
                 * torch.rand(n, generator=g, device="cuda") * 1e3).to(dtype)
            x = x[1:] if shape == "misaligned" else x.reshape(shape)
            got, ref = PROBE_ADD(x), probe_add_plain(x)
            torch.cuda.synchronize()
            as_int = torch.int16 if dtype == torch.bfloat16 else torch.int32
            if got.shape != x.shape or got.dtype != x.dtype \
                    or not torch.equal(got.view(as_int), ref.view(as_int)):
                raise AssertionError(f"probe_add kernel is not bitwise equal to x + 1 "
                                     f"({shape}, {dtype})")
            nbytes = 2 * x.numel() * x.element_size()
            t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, x.numel() / PEAK_F32_FLOPS
            case = {"shape": shape if shape == "misaligned" else list(shape),
                    "numel": x.numel(), "dtype": str(dtype).replace("torch.", ""),
                    "max_abs_err": (got.float() - ref.float()).abs().max().item(),
                    "bitwise": True, "bytes": nbytes}
            del got, ref
            if shape == PROBE_SHAPES[0]:
                case.update({
                    "ms": time_cuda(lambda: PROBE_ADD(x)),
                    "graph_us_per_launch": graph_us_per_launch(PROBE_ADD, x),
                    "plain_ms": time_cuda(lambda: probe_add_plain(x)),
                    "library_ms": time_cuda(lambda: torch.add(x, 1)),
                    "library_graph_us_per_launch": graph_us_per_launch(
                        lambda c: torch.add(c, 1), x),
                    "bound_ms": 1e3 * max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
            elif shape == PROBE_SHAPES[1]:
                turns = [(graph_us_per_launch(PROBE_ADD, x),
                          graph_us_per_launch(lambda c: torch.add(c, 1), x))
                         for _ in range(PROBE_CHAIN_TURNS)]
                case.update({
                    "ms": time_cuda(lambda: PROBE_ADD(x)),
                    "plain_ms": time_cuda(lambda: probe_add_plain(x)),
                    "library_ms": time_cuda(lambda: torch.add(x, 1)),
                    "graph_us_per_launch": min(k for k, _ in turns),
                    "library_graph_us_per_launch": min(a for _, a in turns),
                    "graph_turns_us": turns, "l2_warm": True, "bound_ms": None})
            elif shape == PROBE_SHAPES[3]:
                ms = [(time_cuda(lambda: PROBE_ADD(x), iters=10),
                       time_cuda(lambda: torch.add(x, 1), iters=10)) for _ in range(2)]
                bound = 1e3 * max(t_bytes, t_ops)
                kernel_ms = min(k for k, _ in ms)
                case.update({
                    "ms": kernel_ms, "library_ms": min(a for _, a in ms), "turns_ms": ms,
                    "bound_ms": bound, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "share_of_bound": bound / kernel_ms})
            cases.append(case)
            del x
    return cases


def build_flagship(device):
    """Full-width flagship model on ``device`` with the trained weights of
    snapshots/conv_e79.npz, loaded strictly. conv_e79 was trained without
    the differentiable context mask (the snapshot holds no context_mask
    parameters), so it runs without it and without the contexts loss."""
    from multimodal_feature_learning_tpu_torch.config import load_config, recompute_losses
    from multimodal_feature_learning_tpu_torch.models.dvc import build_model
    from multimodal_feature_learning_tpu_torch.utils.weights import load_flax_params, load_npz

    cfg = load_config()
    cfg.use_differentiable_mask = False
    recompute_losses(cfg)  # labels, segments, captions, mask_prediction
    flat = load_npz(SNAPSHOT)
    vocab_size = int(flat["BF16||caption||params||head||bias"].shape[0])
    model = build_model(cfg, vocab_size, device=device)
    load_flax_params(model, flat)
    source = f"snapshots/conv_e79.npz (epoch {int(flat['__epoch__'])})"
    return cfg, model, source, flat


def make_requests(cfg):
    """48 requests: random features of 120-900 tokens (numpy seed 0) and
    durations of 10-180 s."""
    import numpy as np

    rng = np.random.default_rng(0)
    feat_dim = cfg.dvc.detr.feature_dim
    return [
        (rng.normal(size=(int(rng.integers(120, 901)), feat_dim)).astype(np.float32),
         float(rng.uniform(10, 180)))
        for _ in range(N_REQUESTS)
    ]


def kernel_counters():
    """Every kernel wrapper of the port with its launch count, by name."""
    from multimodal_feature_learning_tpu_torch.ops import fused_decode as fd
    from multimodal_feature_learning_tpu_torch.ops import msda
    from multimodal_feature_learning_tpu_torch.ops.probe_add import PROBE_ADD

    return {"msda_fwd": msda.MSDA_FWD, "msda_bwd": msda.MSDA_BWD,
            "fused_decode_video": fd.FUSED_DECODE["video"],
            "fused_decode_batch": fd.FUSED_DECODE["batch"], "probe_add": PROBE_ADD}


def serve(model, requests):
    """Phases 5 and 7: the requests through DVCServer. Every kernel's launch
    count is set to 0 just before the first request and read just after the
    last; the decode steps of every dispatch are read from its captions.
    Returns the results, latencies, wall seconds, launches, the server's
    stats and the decode steps per dispatch."""
    from multimodal_feature_learning_tpu_torch.serve import DVCServer
    from multimodal_feature_learning_tpu_torch.tools.profile_decode import decode_steps_run

    server = DVCServer(model, batch_size=BATCH, max_wait_ms=10.0)
    steps = []
    forward = model.forward_serve

    def recording_forward(*args, **kwargs):
        out = forward(*args, **kwargs)
        captions = out["captions"].reshape(-1, out["captions"].shape[-1])
        steps.append(decode_steps_run(captions, model.eos_idx, model.seq_len))
        return out

    model.forward_serve = recording_forward
    counters = kernel_counters()
    try:
        done_at = [0.0] * N_REQUESTS
        for k in counters.values():
            k.launches = 0
        t0 = time.monotonic()
        futures = []
        for i, (feats, dur) in enumerate(requests):
            submitted = time.monotonic()
            fut = server.submit(feats, dur)
            fut.add_done_callback(lambda _f, i=i: done_at.__setitem__(i, time.monotonic()))
            futures.append((submitted, fut))
        results = [fut.result(timeout=600) for _, fut in futures]
        # a Future wakes its waiters before it runs its callbacks
        deadline = time.monotonic() + 10
        while 0.0 in done_at and time.monotonic() < deadline:
            time.sleep(0.001)
        if 0.0 in done_at:
            raise AssertionError("completion times were not recorded")
        wall = max(done_at) - t0
        launches = {name: k.launches for name, k in counters.items()}
        stats = dict(server.stats)
    finally:
        server.close()
        del model.forward_serve
    latencies = [done_at[i] - t for i, (t, _) in enumerate(futures)]
    return results, latencies, wall, launches, stats, steps


def serve_fused(model, requests):
    """Phase 7: the same requests with ``decode_impl="fused"``, once per
    grid. The grid's kernel must have launched once for every decode step
    of every dispatch, and the other grid's not at all."""
    out = {}
    for grid in ("video", "batch"):
        model.decode_impl, model.decode_fused_grid = "fused", grid
        try:
            results, latencies, wall, launches, stats, steps = serve(model, requests)
        finally:
            model.decode_impl, model.decode_fused_grid = "xla", "video"
        name, other = f"fused_decode_{grid}", f"fused_decode_{'batch' if grid == 'video' else 'video'}"
        if launches[name] < sum(steps) or launches[other] or stats["dispatches"] != len(steps):
            raise AssertionError(
                f"{name} launched {launches[name]} times ({other} {launches[other]}) over "
                f"{stats['dispatches']} dispatches of {steps} decode steps")
        lat = sorted(latencies)
        out[grid] = {"results": results, "launches": launches, "stats": {
            "requests": N_REQUESTS, "answered": len(results), "dispatches": stats["dispatches"],
            "videos_per_s": N_REQUESTS / wall, "p50_latency_s": lat[len(lat) // 2],
            "max_latency_s": lat[-1], "step_s": stats["step_s"], "launches": launches,
            "decode_steps_per_dispatch": steps,
            "launches_per_dispatch": launches[name] / stats["dispatches"]}}
    return out


def check_results(cfg, model, requests, results, compare_cpu: bool = True):
    """Served events are well formed and, with ``compare_cpu``, match the
    port's CPU path (plain MSDA core, CPU matmuls) on the first N_CHECK videos: k equal, segments
    within 1e-3 of the duration, and at least 90% of caption rows identical
    (f32 sums in another order can flip a near-tie argmax, which changes the
    rest of that caption)."""
    import copy

    import numpy as np
    import torch

    from multimodal_feature_learning_tpu_torch.data.anet import nearest_resize

    G = cfg.dataset.activity_net.max_gt_target_segments
    Lc = cfg.dataset.activity_net.max_caption_len_all
    V = model.caption.head.out_features
    for (feats, dur), events in zip(requests, results):
        if not 1 <= len(events) <= G:
            raise AssertionError(f"{len(events)} events, expected 1..{G}")
        for ev in events:
            s, e = ev["segment"]
            if not (np.isfinite([s, e, ev["score"]]).all() and 0 <= s <= e <= dur + 1e-3):
                raise AssertionError(f"bad segment {ev['segment']} for duration {dur}")
            ids = ev["caption"]
            if len(ids) != Lc + 1 or ids[0] != model.bos_idx or not all(0 <= t < V for t in ids):
                raise AssertionError(f"bad caption ids {ids}")

    if not compare_cpu:
        return None
    T = model.video_rescale_len
    video = np.stack([nearest_resize(f[None], T, axis=1)[0] for f, _ in requests[:N_CHECK]])
    durs = np.array([d for _, d in requests[:N_CHECK]], np.float32)
    cpu_model = copy.deepcopy(model).cpu()
    ref = cpu_model.forward_serve(torch.from_numpy(video),
                                  torch.zeros(video.shape[:2], dtype=torch.bool),
                                  torch.from_numpy(durs))
    rows_equal = rows = 0
    worst_seg = 0.0
    for i in range(N_CHECK):
        events = results[i]
        k = int(ref["k"][i])
        if len(events) != k:
            raise AssertionError(f"video {i}: GPU k={len(events)}, CPU k={k}")
        for j, ev in enumerate(events):
            seg = np.abs(np.array(ev["segment"]) - ref["segments"][i, j].numpy()) / durs[i]
            worst_seg = max(worst_seg, float(seg.max()))
            rows += 1
            rows_equal += ev["caption"] == ref["captions"][i, j].tolist()
    if worst_seg > 1e-3 or rows_equal < 0.9 * rows:
        raise AssertionError(
            f"GPU and CPU paths disagree: segment err {worst_seg} of the duration, "
            f"{rows_equal}/{rows} caption rows equal")
    return {"videos": N_CHECK, "max_segment_err_of_duration": worst_seg,
            "caption_rows_equal": rows_equal, "caption_rows": rows}


def check_fused(cfg, model, requests):
    """Phase 8: the first BATCH requests as one batch through forward_serve
    with the fused decode (both grids), with the plain-op decode, and with
    int8 memory K/V, all on the card, and the fused decode on the port's CPU
    path for the first N_CHECK videos. On the card k and segments are equal
    (the proposal half is the same); the caption rows served (j < k) of the
    fused decode are at least 90% identical to the plain-op decode's and to
    the CPU path's (f32 sums in another order can flip a near-tie argmax,
    which changes the rest of that caption). A row whose every memory
    position is blocked is left out of the comparison with the plain-op
    decode: there the fused step averages V over the Sp padded columns, as
    the TPU kernel does, and the plain-op decode over the S columns, as
    JAX's XLA path does (ROADMAP Queue 3); such rows are counted."""
    import copy

    import numpy as np
    import torch

    from multimodal_feature_learning_tpu_torch.data.anet import nearest_resize

    T = model.video_rescale_len
    video = np.stack([nearest_resize(f[None], T, axis=1)[0] for f, _ in requests[:BATCH]])
    durs = np.array([d for _, d in requests[:BATCH]], np.float32)

    def run(m, impl, grid="video", kv="dense", n=BATCH):
        dev = next(m.parameters()).device
        m.decode_impl, m.decode_fused_grid, m.decode_kv = impl, grid, kv
        try:
            out = m.forward_serve(torch.from_numpy(video[:n]).to(dev),
                                  torch.zeros((n, T), dtype=torch.bool, device=dev),
                                  torch.from_numpy(durs[:n]).to(dev))
        finally:
            m.decode_impl, m.decode_fused_grid, m.decode_kv = "xla", "video", "dense"
        return {k: v.cpu() for k, v in out.items()}

    def agreement(a, b, skip=()):
        rows = [(i, j) for i in range(a["k"].shape[0]) for j in range(int(a["k"][i]))
                if (i, j) not in skip]
        same = sum(bool(torch.equal(a["captions"][i, j], b["captions"][i, j])) for i, j in rows)
        tokens = np.mean([(a["captions"][i, j] == b["captions"][i, j]).float().mean().item()
                          for i, j in rows])
        return same, len(rows), float(tokens)

    plain = run(model, "xla")
    dev = next(model.parameters()).device
    with torch.no_grad():
        prep = model._serve_prepare(torch.from_numpy(video).to(dev),
                                    torch.zeros(video.shape[:2], dtype=torch.bool,
                                                device=dev),
                                    torch.from_numpy(durs).to(dev))
    blocked = prep["caption_pad_mask"].all(dim=1).reshape(BATCH, -1).cpu()
    blocked_rows = {(i, j) for i in range(BATCH) for j in range(int(plain["k"][i]))
                    if blocked[i, j]}
    report = {"served_rows_fully_blocked": len(blocked_rows)}
    for grid in ("video", "batch"):
        fused = run(model, "fused", grid)
        if not (torch.equal(fused["k"], plain["k"])
                and torch.equal(fused["segments"], plain["segments"])):
            raise AssertionError(f"fused ({grid}) and plain-op serving differ in k or segments")
        same, rows, tokens = agreement(fused, plain, skip=blocked_rows)
        if same < 0.9 * rows:
            raise AssertionError(f"fused ({grid}) decode: {same}/{rows} caption rows equal "
                                 f"to the plain-op decode's")
        report[grid] = {"caption_rows_equal_to_plain": same, "caption_rows": rows,
                        "token_agreement_with_plain": tokens,
                        "all_served_rows_equal_to_plain": agreement(fused, plain)[0]}
        if grid == "video":
            video_fused = fused
    same_vb, _, _ = agreement(video_fused, fused)
    int8 = run(model, "fused", "video", "int8")
    same8, rows8, tokens8 = agreement(int8, video_fused)

    cpu_model = copy.deepcopy(model).cpu()
    cpu = run(cpu_model, "fused", n=N_CHECK)
    del cpu_model
    card = {k: v[:N_CHECK] for k, v in video_fused.items()}
    if not torch.equal(cpu["k"], card["k"]):
        raise AssertionError(f"fused decode: card k {card['k']} != CPU k {cpu['k']}")
    seg_err = float(((cpu["segments"] - card["segments"]).abs()
                     / torch.from_numpy(durs[:N_CHECK])[:, None, None]).max())
    same_cpu, rows_cpu, tokens_cpu = agreement(card, cpu)
    if seg_err > 1e-3 or same_cpu < 0.9 * rows_cpu:
        raise AssertionError(f"fused decode, card vs CPU: segment err {seg_err} of the "
                             f"duration, {same_cpu}/{rows_cpu} caption rows equal")
    return {"videos": BATCH, **report, "video_vs_batch_rows_equal": same_vb,
            "int8_vs_dense": {"caption_rows_equal": same8, "caption_rows": rows8,
                              "token_agreement": tokens8},
            "cpu_videos": N_CHECK, "cpu_max_segment_err_of_duration": seg_err,
            "cpu_caption_rows_equal": same_cpu, "cpu_caption_rows": rows_cpu,
            "cpu_token_agreement": tokens_cpu}


def device_kernels(prof):
    """(name, device microseconds, count) of every kernel a profile saw on
    the card; the ranges of record_function (user annotations, such as the
    optimizer step's) are spans, not kernels, and are left out."""
    from torch.autograd import DeviceType

    return [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def profile_call(fn):
    """One call of ``fn`` under torch.profiler, ending in a synchronize:
    (wall ms, device kernel ms, kernel launches, kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = device_kernels(prof)
    return (wall_ms, sum(us for _, us, _ in kernels) / 1e3, sum(c for _, _, c in kernels),
            kernels)


def breakdown(model, requests):
    """Phase 9: where one dispatch's time goes, on the first BATCH requests,
    for each decode_impl in turn. Host-clock milliseconds of the proposal
    half (``_serve_prepare``) and of the greedy decode, each ending in a
    synchronize (median of 5 runs); the decode alone under torch.profiler
    (device ms, launches, busy share); then one forward_serve under
    torch.profiler: the device time of its kernels, their share of the wall
    time, and the largest kernels by device time."""
    import numpy as np
    import torch

    from multimodal_feature_learning_tpu_torch.data.anet import nearest_resize
    from multimodal_feature_learning_tpu_torch.models.caption_decoder import greedy_decode
    from multimodal_feature_learning_tpu_torch.tools.profile_decode import decode_steps_run

    T = model.video_rescale_len
    dev = next(model.parameters()).device
    video = torch.from_numpy(np.stack(
        [nearest_resize(f[None], T, axis=1)[0] for f, _ in requests[:BATCH]])).to(dev)
    durs = torch.tensor([d for _, d in requests[:BATCH]], dtype=torch.float32, device=dev)
    mask = torch.zeros(video.shape[:2], dtype=torch.bool, device=dev)
    out = {"batch": BATCH}
    for impl in ("xla", "fused"):
        model.decode_impl = impl

        def decode(prep):
            return greedy_decode(model.caption, prep["memory"], prep["caption_pad_mask"],
                                 model.seq_len, model.bos_idx, model.eos_idx,
                                 model.pad_idx, groups=model.max_gt,
                                 zeroed_mask=prep["zeroed"], decode_impl=impl)

        prep_ms, dec_ms = [], []
        try:
            with torch.no_grad():
                for _ in range(5):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    prep = model._serve_prepare(video, mask, durs)
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    caps = decode(prep)
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    prep_ms.append(1e3 * (t1 - t0))
                    dec_ms.append(1e3 * (t2 - t1))
                dec_wall, dec_dev, dec_launches, _ = profile_call(lambda: decode(prep))
                wall_ms, device_ms, launches, kernels = profile_call(
                    lambda: model.forward_serve(video, mask, durs))
        finally:
            model.decode_impl = "xla"
        top = sorted(kernels, key=lambda k: -k[1])[:6]
        out[impl] = {
            "prepare_ms_median": sorted(prep_ms)[2],
            "decode_ms_median": sorted(dec_ms)[2],
            "decode_steps": decode_steps_run(caps, model.eos_idx, model.seq_len),
            "profiled_decode_wall_ms": dec_wall,
            "profiled_decode_device_ms": dec_dev,
            "profiled_decode_launches": dec_launches,
            "decode_device_busy_share": dec_dev / dec_wall,
            "profiled_wall_ms": wall_ms,
            "device_kernel_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "kernel_launches": launches,
            "msda_device_ms": sum(us for k, us, _ in kernels if "msda_fwd" in k) / 1e3,
            "fused_decode_device_ms": sum(us for k, us, _ in kernels
                                          if "fused_decode" in k) / 1e3,
            "top_kernels": [{"name": k[:90], "ms": us / 1e3, "count": c} for k, us, c in top],
        }
    return out


EVAL_ARMS = (  # (name, val_mode, keyword arguments, decode_impl)
    ("one_by_one", "one_by_one", {}, "xla"),
    ("one_by_one_fused", "one_by_one", {}, "fused"),
    ("teacher_forcing", "teacher_forcing", {}, "xla"),
    ("beam4", "beam", {"beam_size": 4}, "xla"),
    ("serve", "serve", {}, "xla"),
    ("one_by_one_faster", "one_by_one", {"faster_eval": True}, "xla"),
)


def evaluate_arms(cfg, model, batch):
    """Phase 12: make_eval_step on one batch (on the model's device) in every
    arm of EVAL_ARMS, and beam 1. Every kernel's launch count is set to 0
    just before each arm and read just after it. Checks: every loss finite;
    K1 launched once per MSDA call of the forward; the fused arm's kernel
    once per decode step; beam 1 equal to greedy, row for row."""
    import torch

    from multimodal_feature_learning_tpu_torch.engine.evaluate import make_eval_step
    from multimodal_feature_learning_tpu_torch.models.criterion import build_criterion
    from multimodal_feature_learning_tpu_torch.tools.profile_decode import decode_steps_run

    criterion, weight_dict = build_criterion(cfg, model.pad_idx)
    counters = kernel_counters()
    per_forward = cfg.dvc.detr.enc_layers + cfg.dvc.detr.dec_layers
    arms, captions = {}, {}
    for name, val_mode, kw, impl in EVAL_ARMS + (("beam1", "beam", {"beam_size": 1}, "xla"),):
        model.decode_impl = impl
        try:
            step = make_eval_step(model, criterion, weight_dict, val_mode, **kw)
            for k in counters.values():
                k.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            caps, denorm, losses = step(batch)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
        finally:
            model.decode_impl = "xla"
        launches = {k: c.launches for k, c in counters.items()}
        values = {k: float(v) for k, v in losses.items()}
        if not all(math.isfinite(v) for v in values.values()):
            raise AssertionError(f"eval {name}: non-finite losses {values}")
        steps = decode_steps_run(caps, model.eos_idx, model.seq_len) \
            if val_mode in ("one_by_one", "serve") and not kw.get("faster_eval") else None
        if launches["msda_fwd"] != per_forward:
            raise AssertionError(f"eval {name}: msda_fwd launched {launches['msda_fwd']} "
                                 f"times, the forward has {per_forward} MSDA calls")
        if impl == "fused" and launches["fused_decode_video"] != steps:
            raise AssertionError(f"eval {name}: fused_decode_video launched "
                                 f"{launches['fused_decode_video']} times over {steps} "
                                 f"decode steps")
        captions[name] = caps.cpu()
        arms[name] = {"val_mode": val_mode, **kw, "decode_impl": impl, "ms": ms,
                      "captions_shape": list(caps.shape), "decode_steps": steps,
                      "loss": values["loss"], "loss_terms": len(values) - 1,
                      "caption_loss_terms": sum(k.startswith("loss_caption") for k in values),
                      "launches": launches,
                      "segments_max_s": float(denorm.abs().max())}
    if not torch.equal(captions["beam1"], captions["one_by_one"]):
        rows = int((captions["beam1"] != captions["one_by_one"]).any(dim=1).sum())
        raise AssertionError(f"beam 1 differs from greedy on {rows} caption rows")
    fused_rows = int((captions["one_by_one_fused"] == captions["one_by_one"]).all(dim=1).sum())
    return {"batch": int(batch["video_tensor"].shape[0]), "arms": arms,
            "beam1_equals_greedy": True,
            "fused_rows_equal_to_plain": fused_rows, "rows": int(captions["one_by_one"].shape[0])}


EVAL_CHECK_LOGP_TOL = 1e-3  # x max |ref| of the teacher-forced log-probabilities


def eval_check(cfg, flat, vocab_size):
    """Phase 15: one batch of 2 with dropout off, from conv_e79, through
    forward_eval on the card and on the port's CPU path: matched indices
    (final and auxiliary) equal; the teacher-forced log-probabilities of
    every caption layer within EVAL_CHECK_LOGP_TOL x max |ref|; the loss
    within rel 1e-4 and every term within rel 1e-3 (atol 1e-5), as
    train_check holds them; at least 90% of caption rows equal in one_by_one
    and in beam (beam 4), where f32 sums in another order can flip a
    near-tie."""
    import dataclasses

    import torch

    from multimodal_feature_learning_tpu_torch.data.anet import synthetic_batches
    from multimodal_feature_learning_tpu_torch.engine.train import batch_to_device
    from multimodal_feature_learning_tpu_torch.models.criterion import build_criterion
    from multimodal_feature_learning_tpu_torch.models.dvc import build_model
    from multimodal_feature_learning_tpu_torch.utils.weights import load_flax_params

    cfg = dataclasses.replace(cfg)
    cfg.dvc = dataclasses.replace(cfg.dvc, detr=dataclasses.replace(
        cfg.dvc.detr, transformer_dropout_prob=0.0), caption=dataclasses.replace(
        cfg.dvc.caption, positional_embedding_dropout=0.0, attention_dropout=0.0,
        projection_dropout=0.0, mlp_dropout_1=0.0, mlp_dropout_2=0.0))
    batch = next(synthetic_batches(cfg, 2, vocab_size, seed=0))
    res = {}
    for device in ("cuda", "cpu"):
        model = build_model(cfg, vocab_size, device=device)
        load_flax_params(model, flat)
        criterion, weight_dict = build_criterion(cfg, model.pad_idx)
        tb = batch_to_device(batch, device)
        out, caps, idx, idx_aux, mask = model.forward_eval(tb, "one_by_one")
        losses = criterion(out, tb, idx, idx_aux, mask)
        losses["loss"] = sum(losses[k] * weight_dict[k] for k in losses if k in weight_dict)
        logp = torch.stack([a["pred_captions"] for a in out["aux_outputs_caption"]]
                           + [out["pred_captions"]])
        beam = model.forward_eval(tb, "beam", beam_size=4)[1]
        res[device] = {"idx": idx.cpu(), "idx_aux": idx_aux.cpu(), "logp": logp.cpu(),
                       "caps": caps.cpu(), "beam": beam.cpu(),
                       "losses": {k: float(v) for k, v in losses.items()}}
        del model
    g, c = res["cuda"], res["cpu"]
    if not (torch.equal(g["idx"], c["idx"]) and torch.equal(g["idx_aux"], c["idx_aux"])):
        raise AssertionError("eval: matchings differ between the card and the CPU")
    logp_err = (g["logp"] - c["logp"]).abs().max().item()
    logp_scale = c["logp"].abs().max().item()
    if not logp_err <= EVAL_CHECK_LOGP_TOL * logp_scale:
        raise AssertionError(f"eval: teacher-forced log-probs differ by {logp_err} "
                             f"> {EVAL_CHECK_LOGP_TOL} x {logp_scale}")
    gm, cm = g["losses"], c["losses"]
    rel = {k: abs(gm[k] - cm[k]) / max(abs(cm[k]), 1e-12) for k in cm}
    bad = [k for k in cm if k != "loss" and abs(gm[k] - cm[k]) > max(1e-3 * abs(cm[k]), 1e-5)]
    if rel["loss"] > 1e-4 or bad:
        raise AssertionError(f"eval: card and CPU losses disagree: loss rel {rel['loss']}, "
                             f"terms {bad}")
    rows = {}
    for key in ("caps", "beam"):
        same = int((g[key] == c[key]).all(dim=1).sum())
        if same < 0.9 * g[key].shape[0]:
            raise AssertionError(f"eval: {same}/{g[key].shape[0]} {key} rows equal on the "
                                 f"card and the CPU")
        rows[key] = same
    return {"batch": 2, "indices_equal": True, "logp_max_abs_err": logp_err,
            "logp_max_abs_ref": logp_scale, "loss_card": gm["loss"], "loss_cpu": cm["loss"],
            "loss_rel": rel["loss"], "terms": len(cm) - 1,
            "worst_term": max((k for k in cm if k != "loss"), key=lambda k: rel[k]),
            "worst_term_rel": max(rel[k] for k in cm if k != "loss"),
            "one_by_one_rows_equal": rows["caps"], "beam_rows_equal": rows["beam"],
            "rows": int(g["caps"].shape[0])}


EVAL_WORLD = os.path.join(ROOT, "build", "eval_world")
EVAL_VIDEOS = 64
EVAL_CHECK_VIDEOS = 2


def write_eval_world(vocab_size: int, feature_dim: int) -> dict:
    """The evaluation loop's world on disk, from numpy seed 0: a vocab of
    ``vocab_size`` entries (the four specials, then synthetic words), and
    EVAL_VIDEOS val videos of 120-900 feature tokens x ``feature_dim`` as
    .npy files,
    durations of 10-180 s and 1-10 events each, with sentences of 4-12 of
    the vocab's words. Returns the config overrides that point at it."""
    import numpy as np

    from multimodal_feature_learning_tpu_torch.data.anet import SPLIT_FILES
    from multimodal_feature_learning_tpu_torch.data.vocab import Vocab

    feat_dir = os.path.join(EVAL_WORLD, "features")
    os.makedirs(feat_dir, exist_ok=True)
    words = [f"w{i:04d}" for i in range(vocab_size - 4)]
    vocab = Vocab(["<unk>", "<pad>", "<bos>", "<eos>"] + words)
    vocab.save(os.path.join(EVAL_WORLD, "vocab.pkl"))
    rng = np.random.default_rng(0)
    ann = {}
    for i in range(EVAL_VIDEOS):
        key = f"v_eval_{i:04d}"
        dur = float(rng.uniform(10, 180))
        k = int(rng.integers(1, 11))
        centers, lengths = rng.uniform(0.2, 0.8, size=k), rng.uniform(0.05, 0.3, size=k)
        ann[key] = {
            "duration": dur,
            "timestamps": [[max(0.0, (c - ln / 2) * dur), min(dur, (c + ln / 2) * dur)]
                           for c, ln in zip(centers, lengths)],
            "sentences": [" ".join(rng.choice(words, size=int(rng.integers(4, 13))))
                          for _ in range(k)]}
        np.save(os.path.join(feat_dir, key + ".npy"),
                rng.normal(size=(int(rng.integers(120, 901)), feature_dim)).astype(np.float32))
    with open(os.path.join(EVAL_WORLD, SPLIT_FILES["val"]), "w") as f:
        json.dump(ann, f)
    return {"dataset.activity_net.anet_path": EVAL_WORLD,
            "dataset.activity_net.video_features_file": feat_dir,
            "dataset.activity_net.vocab_file_path": os.path.join(EVAL_WORLD, "vocab.pkl"),
            "submission_dir": os.path.join(EVAL_WORLD, "submission")}


class TimedLoader:
    """A loader that records, per batch, the seconds its caller waited for
    the batch (``wait``) and the seconds the caller then spent on it before
    asking for the next (``busy``)."""

    def __init__(self, loader):
        self.loader, self.wait, self.busy = loader, [], []

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        given = None
        for_next = time.perf_counter()
        for batch in self.loader:
            given = time.perf_counter()
            self.wait.append(given - for_next)
            yield batch
            for_next = time.perf_counter()
            self.busy.append(for_next - given)


def timed_evaluate(record: dict):
    """engine.evaluate.evaluate with its loader, eval step and score_fn
    timed into ``record``: loader wait, eval step (up to a synchronize),
    and the rest of each batch (the host transfer, the strings, the
    submission rows), the loop's seconds and the scoring's."""
    import torch

    from multimodal_feature_learning_tpu_torch.engine.evaluate import evaluate

    def run(eval_step, loader, vocab, cfg, score_fn=None, **kw):
        timed = TimedLoader(loader)
        steps, captions = [], []

        def step(batch):
            t0 = time.perf_counter()
            out = eval_step(batch)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
            captions.append(out[0])
            return out

        def score(sub):
            t0 = time.perf_counter()
            scores = score_fn(sub)
            record["scoring_s"] = time.perf_counter() - t0
            return scores

        result = evaluate(step, timed, vocab, cfg, score_fn=score if score_fn else None, **kw)
        loop_s = sum(timed.wait) + sum(timed.busy)
        record.update({
            "batches": len(steps), "loop_s": loop_s,
            "videos_per_s": len(result[1]["results"]) / loop_s,
            "loader_wait_ms": [1e3 * s for s in timed.wait],
            "eval_step_ms": [1e3 * s for s in steps],
            "transfer_strings_ms": [1e3 * (b - s) for b, s in zip(timed.busy, steps)],
            "captions": captions})
        return result

    return run


def score_summary(scores: dict) -> dict:
    keys = ("Bleu_4", "METEOR", "ROUGE_L", "CIDEr", "Recall", "Precision", "F1_score")
    return {k: scores[k] for k in keys}


def eval_loop(cfg, model, overrides: dict):
    """Phase eval_loop: the val split of the written world (EVAL_VIDEOS
    videos, batch BATCH) from the files to the scores, in three arms:
    one_by_one with the plain-op decode and with the fused decode (grid
    "video") through evaluate() on the served model, and teacher_forcing
    through inference.main, which builds its own model from conv_e79.
    Every kernel's count is set to 0 just before each arm and read just
    after it. Checks: every val key in the submission with one row per
    (capped) ground-truth event; finite scores; K1 launched 12 times a
    batch; the fused kernel once per decode step; the two one_by_one arms'
    timestamps equal and at least 90% of their sentences."""
    import copy
    import random

    from multimodal_feature_learning_tpu_torch import inference
    from multimodal_feature_learning_tpu_torch.config import apply_overrides
    from multimodal_feature_learning_tpu_torch.data.anet import SPLIT_FILES, build_dataset
    from multimodal_feature_learning_tpu_torch.data.loader import DataLoader
    from multimodal_feature_learning_tpu_torch.engine.evaluate import make_eval_step
    from multimodal_feature_learning_tpu_torch.evaluation import run_eval
    from multimodal_feature_learning_tpu_torch.models.criterion import build_criterion
    from multimodal_feature_learning_tpu_torch.tools.profile_decode import decode_steps_run

    cfg = apply_overrides(copy.deepcopy(cfg), [f"{k}={v}" for k, v in overrides.items()])
    cfg.batch_size = BATCH
    anet = cfg.dataset.activity_net
    gt_path = os.path.join(anet.anet_path, SPLIT_FILES["val"])
    with open(gt_path) as f:
        gt = json.load(f)
    per_forward = cfg.dvc.detr.enc_layers + cfg.dvc.detr.dec_layers
    counters = kernel_counters()
    criterion, weight_dict = build_criterion(cfg, model.pad_idx)
    score_fn = lambda sub: run_eval(cfg.eval, sub, gt_path, rng=random.Random(cfg.seed))  # noqa: E731
    arms, subs = {}, {}
    for name, impl in (("one_by_one", "xla"), ("one_by_one_fused", "fused")):
        val_ds, vocab = build_dataset("val", cfg)
        loader = DataLoader(val_ds, BATCH, vocab.pad_idx, anet.video_rescale_len,
                            anet.max_gt_target_segments, anet.max_caption_len_all,
                            shuffle=False, seed=cfg.seed)
        record = {}
        model.decode_impl = impl
        try:
            step = make_eval_step(model, criterion, weight_dict, "one_by_one")
            for k in counters.values():
                k.launches = 0
            stats, subs[name], scores = timed_evaluate(record)(
                step, loader, vocab, cfg, score_fn=score_fn, device="cuda")
            launches = {k: c.launches for k, c in counters.items()}
        finally:
            model.decode_impl = "xla"
        record["decode_steps"] = [decode_steps_run(c, model.eos_idx, model.seq_len)
                                  for c in record.pop("captions")]
        arms[name] = {"decode_impl": impl, **record, "launches": launches,
                      "stats": stats, "scores": score_summary(scores)}

    record = {}
    argv = ["--weights", SNAPSHOT, "--batch-size", str(BATCH), "--device", "cuda",
            "--val-mode", "teacher_forcing", "--config-overrides", "use_differentiable_mask=false",
            *[f"{k}={v}" for k, v in overrides.items()]]
    run = inference.evaluate
    inference.evaluate = timed_evaluate(record)
    try:
        for k in counters.values():
            k.launches = 0
        stats, subs["teacher_forcing"], scores = inference.main(argv)
        launches = {k: c.launches for k, c in counters.items()}
    finally:
        inference.evaluate = run
    record.pop("captions")
    arms["teacher_forcing"] = {"entry": "inference.main", **record, "launches": launches,
                               "stats": stats, "scores": score_summary(scores)}

    for name, arm in arms.items():
        results = subs[name]["results"]
        rows = {k: len(v) for k, v in results.items()}
        want = {k: min(len(v["timestamps"]), anet.max_gt_target_segments) for k, v in gt.items()}
        if rows != want:
            raise AssertionError(f"eval_loop {name}: submission rows {rows} != ground truth {want}")
        if not all(math.isfinite(v) for v in arm["scores"].values()):
            raise AssertionError(f"eval_loop {name}: non-finite scores {arm['scores']}")
        if arm["launches"]["msda_fwd"] != per_forward * arm["batches"]:
            raise AssertionError(f"eval_loop {name}: msda_fwd launched "
                                 f"{arm['launches']['msda_fwd']} times over {arm['batches']} "
                                 f"batches of {per_forward} MSDA calls")
        expected = sum(arm["decode_steps"]) if name == "one_by_one_fused" else 0
        if arm["launches"]["fused_decode_video"] != expected or \
                arm["launches"]["fused_decode_batch"]:
            raise AssertionError(f"eval_loop {name}: fused decode launched "
                                 f"{arm['launches']} times, {expected} decode steps")
    plain, fused = subs["one_by_one"]["results"], subs["one_by_one_fused"]["results"]
    if any([e["timestamp"] for e in plain[k]] != [e["timestamp"] for e in fused[k]]
           for k in plain):
        raise AssertionError("eval_loop: timestamps differ between the plain-op and the "
                             "fused decode")
    pairs = [(a["sentence"], b["sentence"]) for k in plain for a, b in zip(plain[k], fused[k])]
    same = sum(a == b for a, b in pairs)
    if same < 0.9 * len(pairs):
        raise AssertionError(f"eval_loop: {same}/{len(pairs)} sentences equal between the "
                             "plain-op and the fused decode")
    return {"videos": EVAL_VIDEOS, "batch": BATCH, "arms": arms,
            "fused_sentences_equal_to_plain": same, "sentences": len(pairs),
            "example": plain[next(iter(plain))][0]}


def eval_loop_check(cfg, flat, model, overrides: dict):
    """Phase eval_loop_check: the first EVAL_CHECK_VIDEOS videos of the
    world through evaluate() (one_by_one, plain-op decode) on the card and
    on the port's CPU path, from conv_e79: at least 90% of sentences equal,
    timestamps within 1e-3 x the duration, stats within 1e-3 relative."""
    import copy

    from multimodal_feature_learning_tpu_torch.config import apply_overrides
    from multimodal_feature_learning_tpu_torch.data.anet import build_dataset
    from multimodal_feature_learning_tpu_torch.data.loader import DataLoader
    from multimodal_feature_learning_tpu_torch.engine.evaluate import evaluate, make_eval_step
    from multimodal_feature_learning_tpu_torch.models.criterion import build_criterion
    from multimodal_feature_learning_tpu_torch.models.dvc import build_model
    from multimodal_feature_learning_tpu_torch.utils.weights import load_flax_params

    cfg = apply_overrides(copy.deepcopy(cfg), [f"{k}={v}" for k, v in overrides.items()])
    cfg.save_submission = False
    anet = cfg.dataset.activity_net
    val_ds, vocab = build_dataset("val", cfg)
    val_ds.keys = val_ds.keys[:EVAL_CHECK_VIDEOS]
    durations = {k: float(val_ds.annotation[k]["duration"]) for k in val_ds.keys}
    res = {}
    for device in ("cuda", "cpu"):
        m = model
        if device == "cpu":
            m = build_model(cfg, len(vocab), device="cpu")
            load_flax_params(m, flat)
        criterion, weight_dict = build_criterion(cfg, m.pad_idx)
        loader = DataLoader(val_ds, EVAL_CHECK_VIDEOS, vocab.pad_idx, anet.video_rescale_len,
                            anet.max_gt_target_segments, anet.max_caption_len_all,
                            shuffle=False)
        res[device] = evaluate(make_eval_step(m, criterion, weight_dict, "one_by_one"), loader,
                               vocab, cfg, device=device)
    (gs, gsub, _), (cs, csub, _) = res["cuda"], res["cpu"]
    g, c = gsub["results"], csub["results"]
    if set(g) != set(c) or any(len(g[k]) != len(c[k]) for k in c):
        raise AssertionError("eval_loop_check: the card's and the CPU's submissions differ "
                             "in keys or rows")
    ts_err = max(abs(a - b) / durations[k] for k in c for x, y in zip(g[k], c[k])
                 for a, b in zip(x["timestamp"], y["timestamp"]))
    pairs = [(x["sentence"], y["sentence"]) for k in c for x, y in zip(g[k], c[k])]
    same = sum(a == b for a, b in pairs)
    rel = {k: abs(gs[k] - cs[k]) / max(abs(cs[k]), 1e-12) for k in cs}
    if ts_err > 1e-3 or same < 0.9 * len(pairs) or set(gs) != set(cs) or \
            max(rel.values()) > 1e-3:
        raise AssertionError(f"eval_loop_check: timestamps {ts_err} x duration, {same}/"
                             f"{len(pairs)} sentences equal, stats rel {rel}")
    return {"videos": EVAL_CHECK_VIDEOS, "sentences_equal": same, "sentences": len(pairs),
            "timestamp_max_err_over_duration": ts_err, "stats_max_rel": max(rel.values()),
            "worst_stat": max(rel, key=rel.get), "loss_card": gs["loss"], "loss_cpu": cs["loss"]}


def probe():
    """Phase 16: the per-op overhead probe in both modes. K5's launch count
    is set to 0 just before and read just after; the tool reports the
    launches its graph replays ran, which the wrapper counts once at
    capture."""
    import torch

    from multimodal_feature_learning_tpu_torch.ops.probe_add import PROBE_ADD
    from multimodal_feature_learning_tpu_torch.tools import probe_op_overhead

    PROBE_ADD.launches = 0
    result = probe_op_overhead.run("cuda")
    counted = PROBE_ADD.launches
    ran = sum(result["probe_add_launches"].values())
    if not (counted > 0 and result["probe_add_launches"]["eager"] > 0
            and result["probe_add_launches"]["graph"] > 0):
        raise AssertionError(f"probe_add launched {result['probe_add_launches']} "
                             f"(counted {counted}) over the probe")
    # where an xattn sequence's time goes: its kernels' device time, eager
    body, x = probe_op_overhead.make_rows(torch.device("cuda"))["xattn_563keys_us_per_seq"]
    body(x)
    n = 20
    wall_ms, device_ms, launches, kernels = profile_call(lambda: [body(x) for _ in range(n)])
    xattn = {"sequences": n, "device_us_per_seq": 1e3 * device_ms / n,
             "wall_us_per_seq": 1e3 * wall_ms / n, "launches_per_seq": launches / n,
             "kernels": [{"name": k[:90], "us_per_seq": us / n, "count": c}
                         for k, us, c in sorted(kernels, key=lambda k: -k[1])]}
    return {**result, "probe_add_launches_counted": counted, "probe_add_launches_ran": ran,
            "xattn_profile": xattn}


def run_tools():
    """Phase 17: the four other tools once each, at reduced iteration counts
    (their defaults are for manual runs). onchip_decode_parity's fused arms
    may not move a segment, and its "video" arm must give at least 90% of
    the plain-op decode's caption rows exactly."""
    import torch

    from multimodal_feature_learning_tpu_torch.tools import (
        bench_fused_decode, onchip_decode_parity, profile_decode, profile_msda,
    )

    out = {"profile_msda": profile_msda.run("cuda", iters=10)}
    # the kernel backend's forward + backward at Q=282, kernel by kernel
    value, loc, aw = profile_msda.inputs(16, 282, 8, 64, profile_msda.SHAPES, 4,
                                         torch.device("cuda"))
    _, fwd_bwd = profile_msda.backend_fns("kernel", value, profile_msda.SHAPES, loc, aw)
    fwd_bwd()
    wall_ms, device_ms, launches, kernels = profile_call(fwd_bwd)
    out["profile_msda"]["kernel_fwd_bwd_Q282_profile"] = {
        "wall_ms": wall_ms, "device_ms": device_ms, "launches": launches,
        "kernels": [{"name": k[:90], "us": us, "count": c}
                    for k, us, c in sorted(kernels, key=lambda k: -k[1])]}
    out["profile_decode"] = profile_decode.run("cuda", n=3, reps=1)
    out["bench_fused_decode"] = bench_fused_decode.run("cuda", iters=3)
    parity = onchip_decode_parity.run("cuda")
    out["onchip_decode_parity"] = parity
    for arm in onchip_decode_parity.ARMS:
        if parity[f"{arm}_seg_max_delta"] != 0.0:
            raise AssertionError(f"onchip_decode_parity: the {arm} arm moved a segment by "
                                 f"{parity[f'{arm}_seg_max_delta']}")
    if parity["fused_event_exact_pct"] < 90.0:
        raise AssertionError(f"onchip_decode_parity: only {parity['fused_event_exact_pct']}% "
                             f"of the fused arm's rows are exact")
    return out


TRAIN_STEPS = 5  # measured steps, after one warm-up step


def param_grad_report(model):
    """Share of parameters (by count of tensors) with a nonzero gradient,
    and the MSDeformAttn parameters without one."""
    from multimodal_feature_learning_tpu_torch.models.msda_module import MSDeformAttn

    params = list(model.named_parameters())
    nonzero = {n for n, p in params if p.grad is not None and bool(p.grad.abs().sum() > 0)}
    msda_missing = [
        f"{mn}.{pn}" for mn, m in model.named_modules() if isinstance(m, MSDeformAttn)
        for pn, _ in m.named_parameters() if f"{mn}.{pn}" not in nonzero]
    n_msda = sum(len(list(m.parameters())) for m in model.modules()
                 if isinstance(m, MSDeformAttn))
    return len(nonzero) / len(params), n_msda, msda_missing


def train(cfg, flat, vocab_size):
    """Phase 10: 1 + TRAIN_STEPS steps through train_one_epoch at full width,
    from conv_e79, with dropout. Kernel launch counts are set to 0 just
    before and read just after; then one more step under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from multimodal_feature_learning_tpu_torch.data.anet import synthetic_batches
    from multimodal_feature_learning_tpu_torch.engine.state import create_train_state
    from multimodal_feature_learning_tpu_torch.engine.train import (
        batch_to_device, make_train_step, train_one_epoch,
    )
    from multimodal_feature_learning_tpu_torch.models.criterion import build_criterion
    from multimodal_feature_learning_tpu_torch.models.dvc import build_model
    from multimodal_feature_learning_tpu_torch.ops import msda
    from multimodal_feature_learning_tpu_torch.utils.weights import load_flax_params

    model = build_model(cfg, vocab_size, device="cuda")
    load_flax_params(model, flat)
    criterion, weight_dict = build_criterion(cfg, model.pad_idx)
    state = create_train_state(cfg, model, steps_per_epoch=1000)
    step = make_train_step(criterion, weight_dict, seed=cfg.seed)
    batches = list(synthetic_batches(cfg, BATCH, vocab_size, seed=0,
                                     num_batches=TRAIN_STEPS + 2))
    records = []

    def record(values, global_step):
        torch.cuda.synchronize()
        records.append((time.perf_counter(), values))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    msda.MSDA_FWD.launches = msda.MSDA_BWD.launches = 0
    t0 = time.perf_counter()
    state, stats = train_one_epoch(step, state, batches[:TRAIN_STEPS + 1], epoch=0,
                                   print_freq=0, step_logger=record)
    launches = {"msda_fwd": msda.MSDA_FWD.launches, "msda_bwd": msda.MSDA_BWD.launches}
    peak = torch.cuda.max_memory_allocated()
    times = [t0] + [t for t, _ in records]
    step_ms = [1e3 * (b - a) for a, b in zip(times[:-1], times[1:])]
    losses = [v["loss"] for _, v in records]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    per_step = cfg.dvc.detr.enc_layers + cfg.dvc.detr.dec_layers
    steps = len(records)
    for name, n in launches.items():
        if n < per_step * steps:
            raise AssertionError(f"{name} launched {n} times over {steps} training steps; "
                                 f"the training path launches it {per_step} times a step")
    share, n_msda, msda_missing = param_grad_report(model)
    if msda_missing:
        raise AssertionError(f"MSDeformAttn parameters without gradient: {msda_missing[:6]}")

    tb = batch_to_device(batches[-1], "cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step(state, tb)
        torch.cuda.synchronize()
        prof_wall_ms = 1e3 * (time.perf_counter() - t1)
    kernels = device_kernels(prof)
    device_ms = sum(us for _, us, _ in kernels) / 1e3
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    measured = sorted(step_ms[1:])
    median_ms = measured[len(measured) // 2]
    return {
        "batch": BATCH, "steps": steps, "warmup_steps": 1,
        "loss_per_step": losses,
        "grad_norm_per_step": [v["grad_norm"] for _, v in records],
        "lr": records[-1][1]["lr"],
        "step_ms": step_ms, "median_step_ms": median_ms,
        "examples_per_s": BATCH / (median_ms / 1e3),
        "matcher_host_ms": [v["matcher_ms"] for _, v in records],
        "launches": launches,
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "params_with_nonzero_grad_share": share,
        "msdeformattn_params": n_msda, "msdeformattn_params_without_grad": len(msda_missing),
        "max_memory_allocated_bytes": peak,
        "profiled_step_wall_ms": prof_wall_ms,
        "profiled_step_device_kernel_ms": device_ms,
        "device_busy_share": device_ms / prof_wall_ms,
        "profiled_step_kernel_launches": sum(c for _, _, c in kernels),
        "msda_fwd_device_ms": sum(us for k, us, _ in kernels if "msda_fwd" in k) / 1e3,
        "msda_bwd_device_ms": sum(us for k, us, _ in kernels if "msda_bwd" in k) / 1e3,
        "top_kernels": [{"name": k[:90], "ms": us / 1e3, "count": c} for k, us, c in top],
        "epoch_stats_loss": stats["loss"],
    }


def taps_near_whole_tokens(loc, shapes, tol=1e-4):
    """Share of the taps strictly inside their level whose coordinate
    x = loc * T - 0.5 lies within ``tol`` of a whole token. There the
    gradient of the location jumps (the two taps change), so a rounding
    difference of the location moves it by a finite amount."""
    T = loc.new_tensor([float(t) for t in shapes])[:, None]
    x = loc * T - 0.5
    inside = (x > 0) & (x < T - 1)
    near = inside & ((x - x.round()).abs() < tol)
    return float(near.sum()) / max(float(inside.sum()), 1.0)


class recording_msda_calls:
    """Within the block, every MSDA call of the model (``models/msda_module``)
    records its (value, loc, aw) and, once the backward has run, the
    gradient of its output: a list of dicts, in call order."""

    def __enter__(self):
        from multimodal_feature_learning_tpu_torch.models import msda_module

        self.module, self.orig, records = msda_module, msda_module.ms_deform_attn, []

        def recording(value, shapes, loc, aw):
            out = self.orig(value, shapes, loc, aw)
            rec = {"value": value.detach(), "shapes": tuple(shapes), "loc": loc.detach(),
                   "aw": aw.detach()}
            if out.requires_grad:
                out.register_hook(lambda g: rec.__setitem__("g", g.detach().contiguous()))
            records.append(rec)
            return out

        msda_module.ms_deform_attn = recording
        return records

    def __exit__(self, *exc):
        self.module.ms_deform_attn = self.orig


def encoder_dloc_gaps(calls, enc_layers: int):
    """For each encoder MSDA call of the CPU step: K2 on the card and the
    plain backward on the CPU, both on that step's own (value, loc, aw, g);
    the largest dloc gap over all taps and over the taps whose coordinate
    x = loc * T - 0.5 lies more than 1e-4 from a whole token. Then the same
    plain backward on the card step's own inputs: how many taps have another
    floor(x) there than on the CPU, and the dloc gap of the two steps on
    those taps and on the rest."""
    from multimodal_feature_learning_tpu_torch.ops.ms_deform_attn import (
        ms_deform_attn_core_backward,
    )
    from multimodal_feature_learning_tpu_torch.ops.msda import MSDA_BWD

    layers = []
    for i in range(enc_layers):
        cpu, card = calls["cpu"][i], calls["cuda"][i]
        v, shapes, loc, aw, g = (cpu[k] for k in ("value", "shapes", "loc", "aw", "g"))
        ref = ms_deform_attn_core_backward(v, shapes, loc, aw, g)[1]
        got = MSDA_BWD(v.cuda(), shapes, loc.cuda(), aw.cuda(), g.cuda())[1].cpu()
        T = loc.new_tensor([float(t) for t in shapes])[:, None]
        x = loc * T - 0.5
        near = (x - x.round()).abs() < 1e-4
        gap = (got - ref).abs()
        card_loc = card["loc"].cpu()
        other_floor = (card_loc * T - 0.5).floor() != x.floor()
        card_ref = ms_deform_attn_core_backward(card["value"].cpu(), shapes, card_loc,
                                                card["aw"].cpu(), card["g"].cpu())[1]
        step_gap = (card_ref - ref).abs()
        layers.append({
            "Q": loc.shape[1], "taps": loc.numel(), "near_whole_token_taps": int(near.sum()),
            "max_abs_dloc": ref.abs().max().item(),
            "k2_vs_plain_all_taps": gap.max().item(),
            "k2_vs_plain_off_whole_tokens": gap.masked_fill(near, 0).max().item(),
            "taps_with_other_floor_card_vs_cpu": int(other_floor.sum()),
            "card_vs_cpu_step_gap_other_floor": step_gap.masked_fill(~other_floor, 0).max().item(),
            "card_vs_cpu_step_gap_same_floor": step_gap.masked_fill(other_floor, 0).max().item(),
        })
    return layers


def train_check(cfg, flat, vocab_size):
    """Phase 11: one step of batch 2 with dropout off, from conv_e79, on the
    card and on the port's CPU path (plain MSDA core and backward, CPU
    matmuls). Matchings equal; total loss within rel 1e-4; every loss term
    within rel 1e-3 (atol 1e-5); gradient norm within rel 1e-3. The card
    adds dvalue with atomics and sums in another order, so the sides differ
    by f32 rounding carried through a full-width forward and backward; the
    parameters whose clipped gradients differ most are reported."""
    import dataclasses

    import torch

    from multimodal_feature_learning_tpu_torch.data.anet import synthetic_batches
    from multimodal_feature_learning_tpu_torch.engine.state import create_train_state
    from multimodal_feature_learning_tpu_torch.engine.train import (
        batch_to_device, make_train_step,
    )
    from multimodal_feature_learning_tpu_torch.models.criterion import build_criterion
    from multimodal_feature_learning_tpu_torch.models.dvc import build_model
    from multimodal_feature_learning_tpu_torch.utils.weights import load_flax_params

    cfg = dataclasses.replace(cfg)
    cfg.dvc = dataclasses.replace(cfg.dvc, detr=dataclasses.replace(
        cfg.dvc.detr, transformer_dropout_prob=0.0), caption=dataclasses.replace(
        cfg.dvc.caption, positional_embedding_dropout=0.0, attention_dropout=0.0,
        projection_dropout=0.0, mlp_dropout_1=0.0, mlp_dropout_2=0.0))
    batch = next(synthetic_batches(cfg, 2, vocab_size, seed=0))
    result, clipped, calls = {}, {}, {}
    for device in ("cuda", "cpu"):
        model = build_model(cfg, vocab_size, device=device)
        load_flax_params(model, flat)
        criterion, weight_dict = build_criterion(cfg, model.pad_idx)
        tb = batch_to_device(batch, device)
        with torch.no_grad():
            out, idx, idx_aux = model._propose_and_match(tb)
        if device == "cuda":
            near = {k: taps_near_whole_tokens(out[f"sampling_locations_{k}"],
                                              out["temporal_shapes"]) for k in ("enc", "dec")}
        state = create_train_state(cfg, model, steps_per_epoch=1000)
        with recording_msda_calls() as calls[device]:
            metrics = make_train_step(criterion, weight_dict, seed=cfg.seed)(state, tb)
        result[device] = (idx.cpu(), idx_aux.cpu(), {k: float(v) for k, v in metrics.items()
                                                     if k not in ("lr", "matcher_ms")})
        # the gradients after the clip, which scales both sides to norm 0.1
        clipped[device] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    enc_dloc = encoder_dloc_gaps(calls, cfg.dvc.detr.enc_layers)
    (gi, ga, gm), (ci, ca, cm) = result["cuda"], result["cpu"]
    gaps = sorted(((float((clipped["cuda"][n] - clipped["cpu"][n]).norm()), n)
                   for n in clipped["cpu"]), reverse=True)
    if not (torch.equal(gi, ci) and torch.equal(ga, ca)):
        raise AssertionError(f"matchings differ between the card and the CPU: {gi} vs {ci}")
    rel = {k: abs(gm[k] - cm[k]) / max(abs(cm[k]), 1e-12) for k in cm}
    bad = [k for k in cm if k.startswith("loss_")
           and abs(gm[k] - cm[k]) > max(1e-3 * abs(cm[k]), 1e-5)]
    if rel["loss"] > 1e-4 or rel["grad_norm"] > 1e-3 or bad:
        raise AssertionError(f"card and CPU steps disagree: loss rel {rel['loss']}, "
                             f"grad_norm rel {rel['grad_norm']}, terms {bad}")
    terms = [k for k in cm if k.startswith("loss_")]
    return {"batch": 2, "indices_equal": True, "loss_card": gm["loss"], "loss_cpu": cm["loss"],
            "loss_rel": rel["loss"], "grad_norm_card": gm["grad_norm"],
            "grad_norm_cpu": cm["grad_norm"], "grad_norm_rel": rel["grad_norm"],
            "terms": len(terms), "worst_term": max(terms, key=lambda k: rel[k]),
            "worst_term_rel": max(rel[k] for k in terms),
            "clipped_grad_gap_norm": math.sqrt(sum(g * g for g, _ in gaps)),
            "inside_taps_within_1e-4_of_a_whole_token": near,
            "encoder_dloc": enc_dloc,
            "largest_grad_gaps": [{"param": n, "gap_norm": g} for g, n in gaps[:5]]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import multimodal_feature_learning_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script: {e}",
              file=sys.stderr)
        return 1
    from multimodal_feature_learning_tpu_torch.config import load_config
    from multimodal_feature_learning_tpu_torch.models.base_encoder import pyramid_shapes
    from multimodal_feature_learning_tpu_torch.ops import build
    from multimodal_feature_learning_tpu_torch.ops.build import CSRC_DIR
    from multimodal_feature_learning_tpu_torch.ops.fused_decode import STAGE_TIMING_FLAGS
    from multimodal_feature_learning_tpu_torch.tools.msda_device_time import LONG_PYRAMID

    t_all = time.monotonic()
    torch.cuda.set_device(0)
    t = time.monotonic()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    log("device", time.monotonic() - t, kind=kind, nvidia_smi=card,
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)

    t = time.monotonic()
    built = build.build(variants=[("fused_decode.cu", STAGE_TIMING_FLAGS)])
    log("build", time.monotonic() - t, nvcc_seconds=built,
        sources=sorted(p.name for p in CSRC_DIR.glob("*.cu")))
    # registers, shared memory and spills of the MSDA and fused decode kernels
    for source in ("msda_fwd.cu", "msda_bwd.cu", "fused_decode.cu"):
        print(f"ptxas {source}: " + " | ".join(build.ptxas_report(source)), flush=True)

    t = time.monotonic()
    cfg0 = load_config()
    det = cfg0.dvc.detr
    shapes = pyramid_shapes(det.video_rescale_len, det.num_feature_levels)
    q_enc = min(int(sum(shapes) * det.rho) + 1, sum(shapes))
    q_long = min(int(sum(LONG_PYRAMID) * det.rho) + 1, sum(LONG_PYRAMID))
    dims = (BATCH, det.num_heads, det.d_model // det.num_heads, shapes, det.enc_n_points,
            q_enc, cfg0.dvc.num_queries, q_long, LONG_PYRAMID)
    cases = check_msda(dims)
    for c in cases:
        log("kernel", 0.0, name="msda_fwd", **c)
    bwd_cases, function_err = check_msda_bwd(dims)
    for c in bwd_cases:
        log("kernel", 0.0, name="msda_bwd", **c)
    caption = cfg0.dvc.caption
    anet = cfg0.dataset.activity_net
    fused_dims = (BATCH, anet.max_gt_target_segments, caption.d_model, caption.num_heads,
                  caption.depth, anet.max_caption_len_all, sum(shapes),
                  int(caption.d_model * caption.mlp_ratio))
    fused_lines = check_fused_decode(fused_dims)
    for line in fused_lines:
        log("kernel", 0.0, name=f"fused_decode_{line['grid']}", **line)
    log("fused_stages", 0.0, **fused_stage_breakdown(fused_dims))
    probe_cases = check_probe_add()
    for c in probe_cases:
        log("kernel", 0.0, name="probe_add", **c)
    log("kernels", time.monotonic() - t, function_vs_plain_autograd_rel_err=function_err)

    t = time.monotonic()
    cfg, model, source, flat = build_flagship("cuda")
    n_params = sum(p.numel() for p in model.parameters())
    log("model", time.monotonic() - t, weights=source, params=n_params,
        d_model=cfg.dvc.d_model, temporal_shapes=list(shapes))

    t = time.monotonic()
    requests = make_requests(cfg)
    results, latencies, wall, launches, stats, _ = serve(model, requests)
    dispatches = stats["dispatches"]
    if len(results) != N_REQUESTS:
        raise AssertionError(f"{len(results)} of {N_REQUESTS} requests answered")
    per_forward = cfg.dvc.detr.enc_layers + cfg.dvc.detr.dec_layers
    if launches["msda_fwd"] < per_forward * dispatches or dispatches < 1:
        raise AssertionError(
            f"msda_fwd launched {launches['msda_fwd']} times over {dispatches} "
            f"dispatches; the serving path launches it {per_forward} times each")
    lat = sorted(latencies)
    example = results[0][0]
    log("serve", time.monotonic() - t, requests=N_REQUESTS, answered=len(results),
        dispatches=dispatches, videos_per_s=N_REQUESTS / wall,
        p50_latency_s=lat[len(lat) // 2], max_latency_s=lat[-1],
        step_s=stats["step_s"], launches=launches,
        launches_per_dispatch=launches["msda_fwd"] / dispatches,
        example={"segment": example["segment"], "caption_ids": example["caption"]})

    t = time.monotonic()
    agreement = check_results(cfg, model, requests, results)
    log("check", time.monotonic() - t, **agreement)

    t = time.monotonic()
    fused_served = serve_fused(model, requests)
    for grid, served in fused_served.items():
        check_results(cfg, model, requests, served["results"], compare_cpu=False)
    log("serve_fused", time.monotonic() - t,
        **{grid: served["stats"] for grid, served in fused_served.items()})

    t = time.monotonic()
    fused_checked = check_fused(cfg, model, requests)
    log("check_fused", time.monotonic() - t, **fused_checked)

    t = time.monotonic()
    where_time_goes = breakdown(model, requests)
    log("breakdown", time.monotonic() - t, **where_time_goes)

    t = time.monotonic()
    from multimodal_feature_learning_tpu_torch.data.anet import synthetic_batches
    from multimodal_feature_learning_tpu_torch.engine.train import batch_to_device

    eval_batch = batch_to_device(next(synthetic_batches(
        cfg, BATCH, model.caption.head.out_features, seed=0)), "cuda")
    evaluated = evaluate_arms(cfg, model, eval_batch)
    log("eval", time.monotonic() - t, **evaluated)
    vocab_size = model.caption.head.out_features

    t = time.monotonic()
    world = write_eval_world(vocab_size, cfg.dvc.detr.feature_dim)
    looped = eval_loop(cfg, model, world)
    log("eval_loop", time.monotonic() - t, **looped)

    t = time.monotonic()
    loop_checked = eval_loop_check(cfg, flat, model, world)
    log("eval_loop_check", time.monotonic() - t, **loop_checked)
    del model
    torch.cuda.empty_cache()

    t = time.monotonic()
    trained = train(cfg, flat, vocab_size)
    log("train", time.monotonic() - t, **trained)

    t = time.monotonic()
    checked = train_check(cfg, flat, vocab_size)
    log("train_check", time.monotonic() - t, **checked)

    t = time.monotonic()
    eval_checked = eval_check(cfg, flat, vocab_size)
    log("eval_check", time.monotonic() - t, **eval_checked)

    t = time.monotonic()
    probed = probe()
    log("probe", time.monotonic() - t, **probed)

    t = time.monotonic()
    tools = run_tools()
    log("tools", time.monotonic() - t, **tools)

    enc = next(c for c in cases if c["call"] == "encoder" and c["dtype"] == "float32")
    enc_bwd = next(c for c in bwd_cases if c["call"] == "encoder")
    counters = kernel_counters()
    kernels = []
    for name, case, all_cases, replaces, shape in (
            ("msda_fwd", enc, cases, "multimodal_feature_learning_tpu/ops/pallas_msda.py:37",
             f"encoder call, B={BATCH} Q={enc['Q']} f32"),
            ("msda_bwd", enc_bwd, bwd_cases,
             "multimodal_feature_learning_tpu/ops/pallas_msda.py:117",
             f"encoder call, B={BATCH} Q={enc_bwd['Q']} f32")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": os.path.relpath(str(CSRC_DIR / counters[name].source), ROOT),
            "replaces": replaces,
            "launches": trained["launches"][name],
            "launches_by_path": {"serve": launches[name],
                                 "serve_fused": fused_served["video"]["launches"][name],
                                 "train": trained["launches"][name],
                                 "eval": sum(a["launches"][name]
                                             for a in evaluated["arms"].values()),
                                 "eval_loop": {arm: a["launches"][name]
                                               for arm, a in looped["arms"].items()}},
            "max_abs_err": max(c["max_abs_err"] for c in all_cases
                               if c["dtype"] == "float32"),
            "ms": case["ms"], "eager_ms": case["eager_ms"], "kernel_ms": case["kernel_ms"],
            "cold_kernel_ms": case["cold_kernel_ms"], "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"], "bound_by": case["bound_by"], "library_ms": None,
            "schedule": case["schedule"], "shape": shape,
            "schedules": {f"{c['call']} {c['dtype']}": c["schedule"] for c in all_cases},
            "cases": all_cases,
        })
    for grid in ("video", "batch"):
        name = f"fused_decode_{grid}"
        lines = [line for line in fused_lines if line["grid"] == grid]
        main_case = next(line for line in lines if line["kv"] == "dense" and not line["bias_col"])
        n = fused_served[grid]["launches"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": os.path.relpath(str(CSRC_DIR / counters[name].source), ROOT),
            "replaces": counters[name].replaces,
            "launches": n, "launches_by_path": {
                "serve_fused": n,
                "eval": sum(a["launches"][name] for a in evaluated["arms"].values()),
                "eval_loop": {arm: a["launches"][name] for arm, a in looped["arms"].items()}},
            "max_abs_err": max(line["max_abs_err"] for line in lines),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
            "bound_f32_simt_ms": main_case["bound_f32_simt_ms"], "library_ms": None,
            "shape": f"one decode step, B={BATCH} G={fused_dims[1]} D={fused_dims[2]} "
                     f"depth {fused_dims[4]} Sp=640 f32, dense K/V, no bias column, step 9",
            "cases": [{k: v for k, v in line.items() if k != "steps"} for line in lines],
        })
    probe_case = next(c for c in probe_cases
                      if c["shape"] == list(PROBE_SHAPES[0]) and c["dtype"] == "bfloat16")
    n = probed["probe_add_launches_ran"]
    kernels.append({
        "name": "probe_add", "route": "cuda",
        "source": os.path.relpath(str(CSRC_DIR / counters["probe_add"].source), ROOT),
        "replaces": counters["probe_add"].replaces,
        "launches": n, "launches_by_path": {"probe": n},
        "max_abs_err": max(c["max_abs_err"] for c in probe_cases),
        **{k: probe_case[k] for k in ("ms", "graph_us_per_launch", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms", "library_graph_us_per_launch")},
        "shape": "x (160, 64) bf16, the probe's carry", "cases": probe_cases,
    })
    log("total", time.monotonic() - t_all)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
