#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line with its wall seconds:

1. device: the card's name and power limit (nvidia-smi);
2. build: compile every CUDA kernel of the port with nvcc (sm_90a), one
   nvcc per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the serving and training paths give it, with its time, the
   plain version's time and the least time the card could take (its
   bound): the MSDA forward (K1) and the MSDA backward (K2), and the
   autograd Function that joins them against autograd through the plain
   core;
4. model: the flagship sparse DVC model at full width (d_model 512, 6+6
   transformer layers, 6 caption layers, vocab 6563) on the card, carrying
   the trained weights of snapshots/conv_e79.npz, loaded strictly;
5. serve: 48 requests through the port's DVCServer (batch 16), with the
   launch counts of every kernel read over exactly those requests;
6. check: the served results are well formed and agree with the port's CPU
   path on a few of them;
7. breakdown: where one dispatch's time goes (proposal half, greedy decode,
   device busy share and the largest kernels, from torch.profiler);
8. train: 1 + 5 training steps of the full-width model from conv_e79
   through train_one_epoch (batch 16, dropout 0.1, synthetic batches from
   seed 0), with the launch counts of every kernel read over exactly those
   steps, the step time, the matcher's host time, peak memory, and the
   device busy share and largest kernels of one profiled step;
9. train_check: one step of batch 2 with dropout off, from the same weights,
   on the card and on the port's CPU path: equal matchings, losses and
   gradient norm within their tolerances.

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

# f32 peak outside the tensor cores and memory rate of an H100 SXM at 700 W
# (NVIDIA's data sheet); the bounds below are stated against these
PEAK_F32_FLOPS = 67e12
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


def check_msda_bwd(model_dims):
    """Phase 3: the MSDA backward kernel (K2) against the plain backward at
    the training path's shapes, f32: each of dvalue, dloc and daw within
    1e-5 x its max |ref| (atomics add the dvalue terms in another order).
    Then the autograd Function (K1 forward, K2 backward) against autograd
    through the plain core at a small size whose coordinates keep 0.01 from
    every whole token, where the two differentiate alike: rel 1e-5."""
    import torch

    from multimodal_feature_learning_tpu_torch.ops import msda
    from multimodal_feature_learning_tpu_torch.ops.ms_deform_attn import (
        ms_deform_attn_core, ms_deform_attn_core_backward,
    )

    B, H, Dh, shapes, P, q_enc, q_dec = model_dims
    cases = []
    for Q, where in ((q_enc, "encoder"), (q_dec, "decoder")):
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
        ms = time_cuda(lambda: msda.MSDA_BWD(value, shapes, loc, aw, g))
        plain_ms = time_cuda(lambda: ms_deform_attn_core_backward(value, shapes, loc, aw, g),
                             iters=10)
        bound_ms, bound_by, nbytes = msda_bwd_bound_ms(value, shapes, loc, aw, g)
        cases.append({
            "call": where, "Q": Q, "dtype": "float32", "errors": errs,
            "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes,
            "library_ms": None,  # no single PyTorch call computes the MSDA backward
        })

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
    shapes: the encoder's Q = K sparse tokens and the decoder's Q = 20
    queries, f32 and bf16 value."""
    import torch

    from multimodal_feature_learning_tpu_torch.ops import msda
    from multimodal_feature_learning_tpu_torch.ops.ms_deform_attn import ms_deform_attn_core

    B, H, Dh, shapes, P, q_enc, q_dec = model_dims
    tol = {torch.float32: 1e-5, torch.bfloat16: 2e-2}  # relative to max |out|
    cases = []
    for Q, where in ((q_enc, "encoder"), (q_dec, "decoder")):
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
            ms = time_cuda(lambda: msda.MSDA_FWD(value, shapes, loc, aw))
            plain_ms = time_cuda(lambda: ms_deform_attn_core(value, shapes, loc, aw), iters=10)
            bound_ms, bound_by, value_bytes = msda_bound_ms(value, shapes, loc, aw, got)
            cases.append({
                "call": where, "Q": Q, "dtype": str(dtype).replace("torch.", ""),
                "max_abs_err": err, "max_abs_out": scale,
                "tolerance": tol[dtype] * scale, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "value_bytes_needed": value_bytes, "value_bytes": value.numel() * value.element_size(),
                "library_ms": None,  # no single PyTorch call computes MSDA
            })
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


def serve(model, cfg):
    """Phase 5: 48 requests of varying length through DVCServer. Returns the
    requests, their results, latencies and the kernels' launch counts."""
    import numpy as np

    from multimodal_feature_learning_tpu_torch.ops import msda
    from multimodal_feature_learning_tpu_torch.serve import DVCServer

    rng = np.random.default_rng(0)
    feat_dim = cfg.dvc.detr.feature_dim
    requests = [
        (rng.normal(size=(int(rng.integers(120, 901)), feat_dim)).astype(np.float32),
         float(rng.uniform(10, 180)))
        for _ in range(N_REQUESTS)
    ]
    server = DVCServer(model, batch_size=BATCH, max_wait_ms=10.0)
    try:
        done_at = [0.0] * N_REQUESTS
        # count only the launches of these requests
        msda.MSDA_FWD.launches = msda.MSDA_BWD.launches = 0
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
        launches = {"msda_fwd": msda.MSDA_FWD.launches, "msda_bwd": msda.MSDA_BWD.launches}
        stats = dict(server.stats)
    finally:
        server.close()
    latencies = [done_at[i] - t for i, (t, _) in enumerate(futures)]
    return requests, results, latencies, wall, launches, stats


def check_results(cfg, model, requests, results):
    """Served events are well formed, and match the port's CPU path (plain
    MSDA core, CPU matmuls) on the first N_CHECK videos: k equal, segments
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


def device_kernels(prof):
    """(name, device microseconds, count) of every kernel a profile saw on
    the card; the ranges of record_function (user annotations, such as the
    optimizer step's) are spans, not kernels, and are left out."""
    from torch.autograd import DeviceType

    return [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def breakdown(model, requests):
    """Phase 7: where one dispatch's time goes, on the first BATCH requests.
    Host-clock milliseconds of the proposal half (``_serve_prepare``) and of
    the greedy decode, each ending in a synchronize (median of 5 runs); then
    one forward_serve under torch.profiler: the device time of its kernels,
    their share of the wall time, and the largest kernels by device time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from multimodal_feature_learning_tpu_torch.data.anet import nearest_resize
    from multimodal_feature_learning_tpu_torch.models.caption_decoder import greedy_decode

    T = model.video_rescale_len
    dev = next(model.parameters()).device
    video = torch.from_numpy(np.stack(
        [nearest_resize(f[None], T, axis=1)[0] for f, _ in requests[:BATCH]])).to(dev)
    durs = torch.tensor([d for _, d in requests[:BATCH]], dtype=torch.float32, device=dev)
    mask = torch.zeros(video.shape[:2], dtype=torch.bool, device=dev)
    prep_ms, dec_ms = [], []
    with torch.no_grad():
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prep = model._serve_prepare(video, mask, durs)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            caps = greedy_decode(model.caption, prep["memory"], prep["caption_pad_mask"],
                                 model.seq_len, model.bos_idx, model.eos_idx,
                                 model.pad_idx, groups=model.max_gt,
                                 zeroed_mask=prep["zeroed"])
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            prep_ms.append(1e3 * (t1 - t0))
            dec_ms.append(1e3 * (t2 - t1))
    # decode steps run: until the last caption's <eos>, at most seq_len - 1
    is_eos = (caps[:, 1:-1] == model.eos_idx)
    first_eos = torch.where(is_eos.any(1), is_eos.float().argmax(1) + 1,
                            torch.full_like(is_eos[:, 0], model.seq_len - 1, dtype=torch.long))
    steps = int(first_eos.max())

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.forward_serve(video, mask, durs)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = device_kernels(prof)
    device_ms = sum(us for _, us, _ in kernels) / 1e3
    top = sorted(kernels, key=lambda k: -k[1])[:6]
    return {
        "batch": BATCH,
        "prepare_ms_median": sorted(prep_ms)[2],
        "decode_ms_median": sorted(dec_ms)[2],
        "decode_steps": steps,
        "profiled_wall_ms": wall_ms,
        "device_kernel_ms": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "kernel_launches": sum(c for _, _, c in kernels),
        "msda_device_ms": sum(us for k, us, _ in kernels if "msda_fwd" in k) / 1e3,
        "top_kernels": [{"name": k[:90], "ms": us / 1e3, "count": c} for k, us, c in top],
    }


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
    """Phase 8: 1 + TRAIN_STEPS steps through train_one_epoch at full width,
    from conv_e79, with dropout. Kernel launch counts are set to 0 just
    before and read just after; then one more step under torch.profiler."""
    import copy

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


def train_check(cfg, flat, vocab_size):
    """Phase 9: one step of batch 2 with dropout off, from conv_e79, on the
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
    result, clipped = {}, {}
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
        metrics = make_train_step(criterion, weight_dict, seed=cfg.seed)(state, tb)
        result[device] = (idx.cpu(), idx_aux.cpu(), {k: float(v) for k, v in metrics.items()
                                                     if k not in ("lr", "matcher_ms")})
        # the gradients after the clip, which scales both sides to norm 0.1
        clipped[device] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
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
    from multimodal_feature_learning_tpu_torch.ops import build, msda
    from multimodal_feature_learning_tpu_torch.ops.build import CSRC_DIR

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
    built = build.build()
    log("build", time.monotonic() - t, nvcc_seconds=built,
        sources=sorted(p.name for p in CSRC_DIR.glob("*.cu")))

    t = time.monotonic()
    cfg0 = load_config()
    det = cfg0.dvc.detr
    shapes = pyramid_shapes(det.video_rescale_len, det.num_feature_levels)
    q_enc = min(int(sum(shapes) * det.rho) + 1, sum(shapes))
    dims = (BATCH, det.num_heads, det.d_model // det.num_heads, shapes, det.enc_n_points,
            q_enc, cfg0.dvc.num_queries)
    cases = check_msda(dims)
    for c in cases:
        log("kernel", 0.0, name="msda_fwd", **c)
    bwd_cases, function_err = check_msda_bwd(dims)
    for c in bwd_cases:
        log("kernel", 0.0, name="msda_bwd", **c)
    log("kernels", time.monotonic() - t, function_vs_plain_autograd_rel_err=function_err)

    t = time.monotonic()
    cfg, model, source, flat = build_flagship("cuda")
    n_params = sum(p.numel() for p in model.parameters())
    log("model", time.monotonic() - t, weights=source, params=n_params,
        d_model=cfg.dvc.d_model, temporal_shapes=list(shapes))

    t = time.monotonic()
    requests, results, latencies, wall, launches, stats = serve(model, cfg)
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
    where_time_goes = breakdown(model, requests)
    log("breakdown", time.monotonic() - t, **where_time_goes)
    vocab_size = model.caption.head.out_features
    del model
    torch.cuda.empty_cache()

    t = time.monotonic()
    trained = train(cfg, flat, vocab_size)
    log("train", time.monotonic() - t, **trained)

    t = time.monotonic()
    checked = train_check(cfg, flat, vocab_size)
    log("train_check", time.monotonic() - t, **checked)

    enc = next(c for c in cases if c["call"] == "encoder" and c["dtype"] == "float32")
    enc_bwd = next(c for c in bwd_cases if c["call"] == "encoder")
    kernels = []
    for name, kernel, case, all_cases, line in (
            ("msda_fwd", msda.MSDA_FWD, enc, cases, 37),
            ("msda_bwd", msda.MSDA_BWD, enc_bwd, bwd_cases, 117)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": os.path.relpath(str(CSRC_DIR / kernel.source), ROOT),
            "replaces": f"multimodal_feature_learning_tpu/ops/pallas_msda.py:{line}",
            "launches": trained["launches"][name],
            "launches_by_path": {"serve": launches[name], "train": trained["launches"][name]},
            "max_abs_err": case["max_abs_err"],
            "ms": case["ms"],
            "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"],
            "library_ms": None,
            "shape": f"encoder call, B={BATCH} Q={case['Q']} f32",
            "cases": all_cases,
        })
    log("total", time.monotonic() - t_all)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
