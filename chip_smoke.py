#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line with its wall seconds:

1. device: the card's name and power limit (nvidia-smi);
2. build: compile every CUDA kernel of the port with nvcc (sm_90a), and
   its native collate with g++, one compiler per source, all started
   together (with a variant build of the fused decode for its stage
   timing), and print what -Xptxas -v says of the MSDA and
   fused decode kernels (registers, shared memory, spills);
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
   with and without the bias column, at decode steps 0 and 9, against
   the bound of its route (3xTF32 tensor cores against the bytes), and the
   device time of each of its stages (a build that times its barriers, the
   phases of one cross-attention unit and of four GEMM tiles); and the
   probe's kernel (K5, x + 1) in f32 and bf16, bitwise at the probe's shape,
   at 1,000,003 elements, on a misaligned view and at 2^26 elements, eager
   and replayed from a CUDA graph beside torch.add (in turns), and at 2^26
   elements against the HBM bound. K2 and K3/K4 are held in bf16 too, K2
   at the same three calls and K3/K4 in every case above, each against its
   plain bf16 version, with its bf16 bound;
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
   steps (the matcher kernel K6 once a step), the step time, peak memory,
   and the device busy share, largest kernels and K6's device time of one
   profiled step;
11. train_check: one step of batch 2 with dropout off, from the same weights,
   on the card and on the port's CPU path: equal matchings (and K6's on
   the card equal to the numpy matcher's on the card's own costs), losses
   and gradient norm within their tolerances; and, for each encoder MSDA
   call of that step, K2 against the plain backward on the CPU step's own
   inputs;
12. eval (run after breakdown, on the served model): make_eval_step on one
   synthetic batch of 16 in every val_mode (one_by_one with the plain-op
   and the fused decode, teacher_forcing, beam 4, serve, one_by_one with
   faster_eval) and beam 1: finite losses, K1 once per MSDA call, the fused
   kernel once per decode step, beam 1 equal to greedy;
13. eval_loop (after eval, on the served model): the evaluation loop from
   files to scores on a world written under build/eval_world (a vocab of
   the snapshot's 6563 entries, 64 val videos of 120-900 feature tokens as
   .npy files, 1-10 events each, and 64 train videos made the same way):
   vocab, dataset, prefetching loader, evaluate() and the ActivityNet
   Captions scorers, batch 16, in three arms
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
   onchip_decode_parity, once each at reduced iteration counts;
18. serve_continuous (after check): the 48 requests through the port's
   ContinuousDVCServer (16 slots, 4 decode tokens a chunk): every request
   answered, the answers against serve's by check's standard (k equal,
   segments within 1e-3 x duration, at least 90% of caption rows), K1
   launched 12 times a prefill; videos/s, latency, prefills, chunks and the
   device busy share of one profiled chunk;
19. serve_cli (after eval_loop_check): the serving CLI (serve.main) over the
   evaluation world with conv_e79, 64 requests at 50 rps Poisson, static
   and continuous, then static with --max-queue 4 at 1000 rps, which must
   shed; each CLI's JSON row;
20. train_cli (after train): the training CLI (main.main) from conv_e79 over
   the world's 64 train videos, batch 16, 2 epochs with eval and numbered
   checkpoints every epoch, then --resume for a third, then inference.main
   --resume: three epochs logged with finite losses, the resume at epoch 2,
   K2 launched 12 times a train step and K1 12 times a train step and an
   eval batch, K6 once a train step and an eval batch, the checkpoints
   written; seconds and examples/s an epoch, peak memory; then one epoch
   from conv_e79 at steps_per_dispatch=4 beside them (finite per-step
   losses, the same launches a step);
21. serve_bf16 (after check_fused): conv_e79 built with compute_dtype
   "bfloat16" (f32 masters, a bf16 copy in every forward), the 48 requests
   through DVCServer with the plain-op decode and the fused decode (grid
   "video", grid "batch", int8 K/V): videos/s, latency, peak memory,
   launches (K1 12 times a dispatch, its bf16-value route on the encoder's
   and the decoder's calls and the schedules chosen; the fused kernel once
   per decode step), and the agreement with the f32 answers of the same
   arm (k equal share, token agreement, rows equal);
22. check_fused_bf16: check_fused's comparison on the bf16 model (the
   fused decode, both grids and int8, against the plain-op decode, all
   bf16: k and segments equal, at least 90% of caption tokens);
23. serve_continuous_bf16: serve_continuous on the bf16 model, against
   serve_bf16's plain-op answers;
24. eval_bf16 (after eval_loop_check): evaluate_arms on the bf16 model,
   each arm's loss beside the f32 model's, and one arm of the evaluation
   loop (one_by_one, plain-op) from files to scores;
25. train_bf16 (after train): the train phase with compute_dtype
   "bfloat16", with f32 masters and with the fold (master_dtype
   "bfloat16"): K2 exactly 12 times a step, median step ms, peak memory,
   each step's loss beside the f32 run's. The kernel lines of K2 and K3/K4
   (phase 3) hold their bf16 routes against their plain bf16 versions.
26. dense_serve (after tools): the dense deformable family (BASELINE
   config #2: every token a query, a class head) at full width with
   weights drawn from seed 0, the 48 requests through DVCServer ranked by
   "stability" and by "class" (1 - p(no-object)), each with the plain-op
   and the fused "video" decode: videos/s, latency, K1 12 times a dispatch,
   the fused kernel once per decode step, MSDA calls by shape (Q = S =
   563), and in each rank the fused answers against the plain-op ones;
27. dense_eval: evaluate_arms on the dense model (every val_mode, fused
   and plain-op, beam 1 equal to greedy on at least 90% of rows, and where
   they part, the top-2 logit gap there and how far the two decodes'
   logits are apart);
28. dense_check: the class-ranked served results of 2 videos and
   eval_check's batch of 2, on the card against the port's CPU path;
29. dense_train: the train phase on the dense family (K1 and K2 12 times a
   step), and train_check's card-against-CPU step, K2 on the CPU step's
   encoder MSDA inputs (Q = S = 563);
30. mm_eval, mm_train, mm_check (twice: the context masks off, as the JAX
   package trained BASELINE config #3, and on): the video + audio family
   with the BiModalEncoder at full width (audio 50 -> S = 95), weights from
   seed 0: evaluate_arms in one_by_one, teacher_forcing, beam 4 and
   faster_eval (K1 36 times a forward: 4 calls an encoder layer, 2 a
   decoder layer), the train phase (K2 36 times a step, MSDA calls by
   shape, peak memory), and eval_check and train_check against the CPU;
31. dense_cli, mm_cli: the training CLI on each family over the evaluation
   world's 64 train videos (the multimodal family reads the video features
   as audio, as the JAX package does without an audio file), one epoch with
   eval and scoring, then --mode eval --resume of its checkpoint: K1 and
   K2 once per MSDA call of every step and eval batch, the same val loss.
   The kernel lines of phase 3 hold K1 and K2 at every call shape of the
   two families (tools/msda_device_time.py::FAMILY_CALLS), f32, and the
   dense encoder's in bf16 too;
32. raw_ingest: the host side of raw ingest over a world of annotations
   written under build/raw_world (16 val and 16 train videos of 10-180 s,
   the evaluation world's vocabulary; frames and waves from the synthetic
   decoder): per video the ms of the decode, the resample to 300 frames,
   the fbank (128 mels x 64 frames) and the whole dataset item, collate_raw
   of 16, the loader's wait and copy a batch, and the bytes a batch moves
   to the card (the frames as uint8);
33. raw_eval, raw_train, raw_check: the raw multimodal family (BASELINE
   config #5: uint8 frames -> ViViT "factorised encoder" depth 12 + 4, AST
   depth 12 over 93 tokens, the multimodal stack; 8 heads, audio rescale
   length 93, weights from seed 0), its parameter count equal to the JAX
   init's: evaluate_arms at batch 16 on the world's val videos (K1 36
   times a forward), the forward's device busy share and its split into
   ViViT, AST and the DVC stack; the train phase at the largest batch of
   8, 4 or 2 whose step peaks under 70 GB (K2 36 times a step, gradients
   into both backbones); eval_check and train_check of 2 videos cut to 32
   frames on the card against the CPU (every greedy parting a near-tie,
   the backbones' features within 1e-4 of their largest);
34. regular_raw_eval/_train/_check and regular_eval/_train/_check: the same
   for the regular family over raw frames (BASELINE config #4: its own
   ViViT, depth 4 + 2) and over synthetic features (training at batch 16),
   K1 and K2 never launched, beam 1 equal to greedy on every row;
35. raw_cli: the training CLI on the raw family over the raw world, one
   epoch at the raw training batch with eval and scoring, then --mode eval
   --resume: K1 and K2 once per MSDA call of every step and eval batch.
   The kernel lines of phase 3 hold K1 and K2 at the raw family's new call
   shapes too (tools/msda_device_time.py::RAW_CALLS), f32;
36. matcher (after kernels): the batched Hungarian matcher kernel (K6,
   csrc/hungarian.cu) against the numpy version on every slot, both on the
   same costs, at the flagship's training shape (6 decoder layers x batch
   16 problems of 20 queries x 10 GT slots) with random costs, integer
   costs full of ties, problems without a valid slot and match_cost's
   1e5 / -1e5, at each other family's shape where it differs, square
   (10 x 10), the widest of route "warp" (31 x 31, ties) and at 1024
   queries (route "global"), each with its plan; K6's device time from
   eager calls (CUDA events, ``ms`` as since PR 15), from a CUDA graph
   (``graph_ms``) and from the profiler, the wrapper's host µs a call, its
   bound, the chain floor (the chain probe's step latency x the longest
   problem's steps) and the numpy version's host time (no PyTorch call
   solves an LAP: no library time). Every train and eval phase of every
   family checks K6 once per matching;
37. train_multistep (after train): the flagship at full width from
   conv_e79, batch 16, dropout 0.1, 9 synthetic batches through
   train_one_epoch at chunk_k 4 (make_train_multistep: two chunks of 4 and
   a tail of 1), twice at chunk_k 1 and once more at chunk_k 4: each
   chunk's steps under torch.cuda.set_sync_debug_mode("error") (no host
   synchronisation from after its transfer to its last step's dispatch);
   the two runs at each chunk_k equal bit for bit (every step's losses and
   matchings, the parameters after the last); each chunked step against
   the single step replayed from the same state: loss terms (rel 1e-5),
   grad norm (rel 1e-4), matchings (equal but at near-ties, listed) and
   parameters after the step (1.01 lr); ms a step of each, each chunk's
   host dispatch ms, one profiled chunk (device ms, busy share, launches a
   step, K6's device time), K6 once a step, peak memory;
38. determinism (after train_multistep): K2 twice on the same inputs at the
   encoder's, the decoder's, the long pyramid's and the dense encoder's
   calls, f32 and bf16: bit for bit, and within its tolerance of the plain
   backward, and its device ms (two CUDA graphs of 50) beside the bound;
   the DAM splat twice, bit for bit, and against the CPU's; one flagship
   train step from conv_e79 replayed twice: losses, matchings, gradients
   and parameters bit for bit; the same with K2 swapped for the plain backward, and so under
   torch.use_deterministic_algorithms(True, warn_only=True) with its
   warnings (reported); and train_multistep's free-running repeats;
39. observability: one flagship train step inside
   utils/observability.py::profile_section with a log directory: the
   Chrome trace holds its CUDA kernels (K1, K2, K6 among them);
   device_memory_stats: a non-zero peak equal to
   torch.cuda.max_memory_allocated; save_grad_flow of its gradients;
40. glove: a GloVe file (300 values a word, every 97th word left out) for
   the evaluation world's vocabulary, the flagship at full width built from
   it through build_model_and_criterion (the embedding the matrix, then the
   projection to 512 and a ReLU), weights from seed 0: eval_check, 3 train
   steps of batch 2 each against its CPU replay from the card's state, and
   check_fused (the fused decode's tokens against the plain-op decode's);
41. native_collate: the native collate (csrc/collate.cpp, built with g++ in
   the build phase) against numpy on the evaluation world's features, bit
   for bit, with host ms; the loader's wait a batch with the library and
   under MFL_DISABLE_NATIVE, its batches equal;
42. vivit_transplant (after raw_cli): a seeded ViT npz for config #5's
   ViViT (512 wide, 16 x 16 patches) transplanted in every ViViT mode on
   the card and on the CPU, bit for bit; then the raw family with it
   transplanted, eval_check of 2 raw val videos at 32 frames, card against
   CPU;
43. parallel (after vivit_transplant): parallel/ over torch.distributed,
   the flagship from conv_e79 at full width, batch 16, dropout 0.1, 3
   steps: (a) the train step in this process under an NCCL group of world
   1 through the parallel path (make_mesh, replicate_params, the step's
   data_parallel, sync_grads, reduce_metrics) against the plain step:
   losses, matchings and every parameter bit for bit, K1 / K2 / K6 12 / 12
   / 1 a step; (b) two processes of this script (--parallel-rank) on the
   one card over gloo (NCCL refuses two ranks on one device), DP 2 at 8 +
   8 rows, each step against the one-process step at 16 rows that rank 0
   replays from the same state: matchings equal, loss within rel 1e-4,
   terms 1e-3, grad norm 1e-3 (train_check's tolerances), K1 / K2 / K6
   12 / 12 / 1 a step on each rank, each rank's backend, step ms and peak
   memory, and the loss beside this process's plain run (reported); (c)
   the same two processes at TP 2 (parallel/tp.py with the decoder's
   value tokens split over the model axis, every rank on the 16 rows),
   held the same way;
44. fused_widths (in the kernels phase, after the fused decode's lines):
   K3/K4 at every shape of FUSED_WIDTHS (JAX's kernel test's widths, the
   long-video flagship, D 480, 768 and 1024, Dh 16, 80 and 128, mlp_ratio
   2, G 24 and 32, depth 24, Sp 4096, a caption of 200 tokens), one step in f32 and
   bf16, dense and int8, both grids, the bias column on, each against the
   plain version: errors, committed and untouched rows, two launches bit
   for bit, ms, plain ms, bound, the schedule the library chose (the
   flagship's or the general one) and its shared memory;
45. serve_long (after serve_continuous_bf16): conv_e79 at a rescale length
   of 1200 (pyramid (1200, 600, 300, 150): S 2250, Sp 2304), f32 and bf16,
   the 48 requests through DVCServer with the plain-op decode and the fused
   decode in both grids, dense and int8: launches, videos/s, and each fused
   arm against the plain-op arm (k, segments within 1e-3 x duration, 90% of
   caption rows in f32, of tokens in bf16);
46. serve_narrow: the tests' narrow model (d_model 64, 2 heads, caption
   depth 2, 4 events; weights from seed 0, the context mask on) the same
   way, then check_fused on it (fused against plain-op on the card, and
   against the port's CPU path);
47. ref_checkpoint (after train_cli): a reference SAGA-DVC checkpoint into
   the port and out of it through the CLIs (utils/ref_bridge.py), the
   flagship at full width from conv_e79, the context mask off: conv_e79
   written as a reference .pth and read back under weights_only (its
   leftover keys counted; with a pickled object beside it, refused unless
   trusted), inference.main --from-reference-checkpoint of
   it equal to --weights conv_e79 on the world's first 16 val videos
   (submissions, stats, scores); tools/export_to_reference of train_cli's
   last checkpoint, with its epoch, inferred from equal to train_cli's
   inference --resume; serve.main from the file, 16 requests with the
   fused decode (grid "video"): the served weights bit for bit conv_e79's,
   K1 12 times a forward, the fused kernel once per decode step; main.main
   from the file, one epoch of one step of 16 and its eval batch: finite
   losses, K1 / K2 / K6 24 / 12 / 2. Each CLI call's seconds and launches.

Then one JSON line of kernel measurements (K1-K6) and, as the last line, a JSON
object naming the device. Any failure exits non-zero without that line, as
does a host without CUDA or a directory without the port's package.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SNAPSHOT = os.path.join(ROOT, "snapshots", "conv_e79.npz")

# f32 peak outside the tensor cores, dense TF32 and bf16 tensor-core peaks
# and memory rate of an H100 SXM at 700 W (NVIDIA's data sheet); the bounds
# below are stated against these
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
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
        + value.numel() * value.element_size() + 2 * loc.numel() * 4
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
    """(name, B, Q, level lengths, dtypes) of the MSDA calls the kernel
    lines hold: the encoder's and the decoder's at the main path's shapes,
    and the sparse encoder of a longer video's pyramid at B=2, whose rows
    take the kernels' chunked route, each in f32 and bf16; then every call
    of the dense and the multimodal families that those do not hold
    (``tools/msda_device_time.py::FAMILY_CALLS``: the dense encoder's Q = S
    = 563, the audio pyramid's 95 rows, and queries of one pyramid sampling
    the other's value) and of the raw multimodal family (``RAW_CALLS``: the
    pyramid of 93 AST tokens, 176 rows, and its 89 sparse queries), in f32,
    and the dense encoder's in bf16 too."""
    from multimodal_feature_learning_tpu_torch.tools.msda_device_time import (
        FAMILY_CALLS, RAW_CALLS)

    B, H, Dh, shapes, P, q_enc, q_dec, q_long, long_shapes = model_dims
    both = ("float32", "bfloat16")
    return (("encoder", B, q_enc, shapes, both), ("decoder", B, q_dec, shapes, both),
            ("long_pyramid", 2, q_long, long_shapes, both),
            *((name, b, q, s, both if name == "dense_encoder" else ("float32",))
              for name, b, q, s in FAMILY_CALLS + RAW_CALLS))


# K2's tolerance, x max |ref| of each output: f32 sums in another order
# (a row's entries are summed in their key order, not the plain version's);
# in bf16 dvalue is rounded once from those f32 sums, which may round to
# either neighbour: one bf16 step at its largest magnitude
BWD_TOL = {"float32": {"dvalue": 1e-5, "dloc": 1e-5, "daw": 1e-5},
           "bfloat16": {"dvalue": 2.0 ** -7, "dloc": 1e-5, "daw": 1e-5}}


def check_msda_bwd(model_dims):
    """Phase 3: the MSDA backward kernel (K2) against the plain backward at
    the training path's shapes and on the long pyramid, value and output
    gradient in f32 and in bf16 (loc and aw f32, as the model gives them):
    each of dvalue, dloc and daw within BWD_TOL x its max |ref|. Then the autograd
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
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for where, B, Q, shapes, dtypes in msda_calls(model_dims):
            if dname not in dtypes:
                continue
            value, loc, aw = msda_inputs(B, Q, H, Dh, shapes, P, dtype, seed=Q + 1)
            g = torch.randn((B, Q, H * Dh),
                            generator=torch.Generator(device="cuda").manual_seed(Q),
                            device="cuda").to(dtype)
            got = msda.MSDA_BWD(value, shapes, loc, aw, g)
            ref = ms_deform_attn_core_backward(value, shapes, loc, aw, g)
            torch.cuda.synchronize()
            errs = {}
            for name, a, b in zip(("dvalue", "dloc", "daw"), got, ref):
                tol = BWD_TOL[dname][name]
                err = (a.float() - b.float()).abs().max().item()
                scale = b.float().abs().max().item()
                if a.shape != b.shape or a.dtype != b.dtype or not err <= tol * scale:
                    raise AssertionError(
                        f"MSDA backward kernel disagrees with the plain backward ({where}, "
                        f"{dname}, {name}): max abs err {err} > {tol} x {scale}, "
                        f"{a.dtype} against {b.dtype}")
                errs[name] = {"max_abs_err": err, "max_abs_ref": scale, "tolerance": tol * scale}
            plan = msda.msda_bwd_plan(shapes, B, H, Dh, Q, P, itemsize=value.element_size())
            times = msda_device_times(lambda: msda.MSDA_BWD(value, shapes, loc, aw, g),
                                      "msda_bwd")
            plain_ms = time_cuda(
                lambda: ms_deform_attn_core_backward(value, shapes, loc, aw, g), iters=10)
            bound_ms, bound_by, nbytes = msda_bwd_bound_ms(value, shapes, loc, aw, g)
            cases.append({
                "call": where, "B": B, "Q": Q, "shapes": list(shapes), "dtype": dname,
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


def bitwise_equal(a, b) -> bool:
    """Two tensors (or sequences of them) equal bit for bit: same dtypes and
    shapes, NaN only where the other has the same NaN."""
    import torch

    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(bitwise_equal(x, y) for x, y in zip(a, b))
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        return torch.equal(a.contiguous().view(bits), b.contiguous().view(bits))
    return torch.equal(a, b)


def k2_determinism(model_dims):
    """Phase determinism, the kernel part: at each call of PERF.md's K2 row
    (the encoder's, the decoder's, the long pyramid's and the dense
    encoder's), in f32 and bf16, K2 called twice on the same inputs gives
    dvalue, dloc and daw equal bit for bit, and agrees with the plain
    backward to BWD_TOL. Device ms from two CUDA graphs of 50 calls, beside
    the bound."""
    import torch

    from multimodal_feature_learning_tpu_torch.ops import msda
    from multimodal_feature_learning_tpu_torch.ops.ms_deform_attn import (
        ms_deform_attn_core_backward)
    from multimodal_feature_learning_tpu_torch.tools.msda_device_time import (
        FAMILY_CALLS, graph_call_ms)

    B, H, Dh, shapes, P, q_enc, q_dec, q_long, long_shapes = model_dims
    dense = [c for c in FAMILY_CALLS if c[0] == "dense_encoder"][0]
    calls = (("encoder", B, q_enc, shapes), ("decoder", B, q_dec, shapes),
             ("long_pyramid", 2, q_long, long_shapes), dense)
    dev = torch.device("cuda")
    lines = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for where, b, q, s in calls:
            value, loc, aw = msda_inputs(b, q, H, Dh, s, P, dtype, seed=q + 1)
            g = torch.randn((b, q, H * Dh),
                            generator=torch.Generator(device="cuda").manual_seed(q),
                            device="cuda").to(dtype)
            first, second = (msda.MSDA_BWD(value, s, loc, aw, g) for _ in range(2))
            ref = ms_deform_attn_core_backward(value, s, loc, aw, g)
            torch.cuda.synchronize()
            if not bitwise_equal(first, second):
                raise AssertionError(f"K2 gave two results on the same inputs ({where}, {dname})")
            errs = {}
            for name, a, r in zip(("dvalue", "dloc", "daw"), first, ref):
                tol = BWD_TOL[dname][name]
                err = (a.float() - r.float()).abs().max().item()
                scale = r.float().abs().max().item()
                if not err <= tol * scale:
                    raise AssertionError(f"K2 disagrees with the plain backward ({where}, "
                                         f"{dname}, {name}): {err} > {tol} x {scale}")
                errs[name] = err / scale if scale else err
            times = [graph_call_ms(lambda: msda.MSDA_BWD(value, s, loc, aw, g), dev)
                     for _ in range(2)]
            bound_ms, bound_by, _ = msda_bwd_bound_ms(value, s, loc, aw, g)
            lines.append({
                "call": where, "B": b, "Q": q, "dtype": dname, "repeat_bitwise": True,
                "rel_err_vs_plain": errs, "ms": times, "bound_ms": bound_ms,
                "bound_by": bound_by,
                "plan": vars(msda.msda_bwd_plan(s, b, H, Dh, q, P,
                                                itemsize=value.element_size()))})
            del value, loc, aw, g, first, second, ref
    return lines


def dam_determinism(seed: int = 0):
    """The DAM splat (``ops/dam.py``) twice on the decoder's sampling
    locations and attention weights at the flagship's training shapes:
    equal bit for bit, and equal to the CPU's splat of the same inputs to
    1e-6 of its largest value (the CPU sums each token's weights in index
    order, the card in its own fixed order)."""
    import torch

    from multimodal_feature_learning_tpu_torch.ops.dam import attn_map_to_flat_grid

    shapes, starts = (300, 150, 75, 38), (0, 300, 450, 525)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    loc = torch.rand((BATCH, 6, 20, 8, 4, 4), generator=gen, device="cuda") * 1.4 - 0.2
    aw = torch.rand(loc.shape, generator=gen, device="cuda")
    a, b = (attn_map_to_flat_grid(shapes, starts, loc, aw) for _ in range(2))
    cpu = attn_map_to_flat_grid(shapes, starts, loc.cpu(), aw.cpu())
    err = (a.cpu() - cpu).abs().max().item() / cpu.abs().max().item()
    if not bitwise_equal(a, b) or not err <= 1e-6:
        raise AssertionError(f"the DAM splat is not repeatable (bitwise {bitwise_equal(a, b)}) "
                             f"or parts from the CPU's by {err}")
    return {"repeat_bitwise": True, "rel_err_vs_cpu": err}


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
    for where, B, Q, shapes, dtypes in msda_calls(model_dims):
        for dtype in (torch.float32, torch.bfloat16):
            if str(dtype).replace("torch.", "") not in dtypes:
                continue
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


FUSED_STEPS = (0, 9)  # decode steps at which the fused kernel is checked
# relative to max |ref| of x_out and of the committed rows. f32: 3xTF32
# against f32 products, sums in another order. bf16: the kernel and the
# plain version round to bf16 (8 significant bits, 2^-8 relative) at the
# same points, but sum in other orders and the kernel rounds the
# cross-attention's weights per chunk of 128 columns before it divides by
# the row's sum; a value one bf16 step apart moves on through 6 layers and
# 18 LayerNorms (0.02 of max |ref| on an NVIDIA H100 80GB HBM3 at 700 W):
# held to 0.05
FUSED_TOL = {"float32": 1e-4, "bfloat16": 0.05}


def fused_decode_inputs(dims, bias_col: bool, kv_mode: str, seed: int, dtype=None):
    """Inputs of one fused decode step at ``dims`` on the card, from a seed:
    weights of the scale a trained layer has, memory K/V projected from a
    random memory, caches full of random rows (the kernel may read only the
    positions < valid_len). Event rows take windows of the S tokens, as the
    crop mask makes them; with the bias column, a random context mask blocks
    positions and the crop windows are the zeroed mask. Event 0 of video 0
    has every position blocked. With ``dtype`` bf16 the same draws are
    rounded to bf16: x, the caches and the weights, and the memory, whose
    K/V are projected in bf16 as the bf16 decode projects them."""
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
    dtype = dtype or torch.float32
    w = {k: v.to(dtype).contiguous() for k, v in w.items()}
    Sp = fd.padded_len(S)
    mem_k, mem_v = fd.stack_memory_kv(w, randn(B, S, D).to(dtype), Sp)
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
    return {"x": randn(B, 2 * G, D).to(dtype), "k_caches": randn(depth, B, Tc * G, D).to(dtype),
            "v_caches": randn(depth, B, Tc * G, D).to(dtype), "mem_k": mem_k, "mem_v": mem_v,
            "k_scales": k_scales, "v_scales": v_scales, "mask_i8": mask_i8,
            "log_m": log_m, "weights": w}


def fused_decode_bound_ms(inp, dims, valid_len: int):
    """Least time for one step on these inputs, on the kernel's route: every
    weight, the memory K/V (and scales), mask, log_m and x read once, the
    cache rows of positions < step read once, x_out and the committed rows
    written once, at 3.35 TB/s; against the operations of the products (two
    per multiply-add: per layer the q, k, v (commit rows), o, q', o'
    projections, the MLP, and both attentions over the keys each row reads,
    valid_len own-event keys and Sp memory columns): in f32 done three times
    over, as 3xTF32 does, at the TF32 tensor-core peak; in bf16 once, at the
    bf16 tensor-core peak. Returns (bound ms, what bounds it, bytes, flops,
    and for the record the bound of the same operations once in f32 on the
    CUDA cores)."""
    B, G, D, H, depth, Tc, S, F = dims
    R, Sp = 2 * G, inp["mem_k"].shape[2]
    M = B * R

    def size(t):
        return t.numel() * t.element_size() if t is not None else 0

    nbytes = sum(size(t) for t in inp["weights"].values())
    nbytes += sum(size(inp[k]) for k in ("mem_k", "mem_v", "k_scales", "v_scales",
                                          "mask_i8", "log_m"))
    nbytes += 2 * size(inp["x"])
    row = D * inp["k_caches"].element_size()
    nbytes += 2 * depth * B * (valid_len - 1) * G * row  # cache rows read
    nbytes += 2 * depth * B * G * row                    # committed rows written
    macs = M * D * D * 4 + 2 * B * G * D * D + 2 * M * D * F \
        + 2 * M * valid_len * D + 2 * M * Sp * D
    flops = 2 * depth * macs
    bf16 = inp["x"].element_size() == 2
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_BF16_FLOPS if bf16 else 3 * flops / PEAK_TF32_FLOPS
    f32_simt_ms = 1e3 * max(t_bytes, flops / PEAK_F32_FLOPS)
    return (1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"),
            nbytes, flops, f32_simt_ms)


def fused_step_case(inp, dims, step: int, grid: str, bias_col: bool, tol: float,
                    iters: int = 50, plain_iters: int = 10) -> dict:
    """One fused decode step (K3/K4) on ``inp`` against its plain version on
    the card, both from the same caches: x_out and the committed cache rows
    within ``tol`` x max |ref|, every other cache row exactly as it was, and
    a second launch from the same caches equal to the first bit for bit;
    then the kernel's and the plain version's ms and the bound."""
    import torch

    from multimodal_feature_learning_tpu_torch.ops import fused_decode as fd

    G, H = dims[1], dims[3]
    dtype = inp["x"].dtype
    dname = str(dtype).replace("torch.", "")
    kw = dict(G=G, num_heads=H, has_bias_col=bias_col)

    def args(kc, vc):
        return (inp["x"], kc, vc, step, step + 1, inp["mem_k"], inp["mem_v"],
                inp["k_scales"], inp["v_scales"], inp["mask_i8"], inp["log_m"], inp["weights"])

    kc0, vc0 = inp["k_caches"], inp["v_caches"]
    ref, rkc, rvc = fd.fused_decode_step_plain(*args(kc0.clone(), vc0.clone()), **kw)
    got, gkc, gvc = fd.FUSED_DECODE[grid](*args(kc0.clone(), vc0.clone()), **kw)
    again = fd.FUSED_DECODE[grid](*args(kc0.clone(), vc0.clone()), **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip((got, gkc, gvc), again)):
        raise AssertionError(f"two launches of the fused decode kernel differ ({dname}, {grid}, "
                             f"dims {dims}, step {step})")
    rows = slice(step * G, (step + 1) * G)
    errs = {}
    for name, a, b in (("x_out", got, ref),
                       ("k_commit", gkc[:, :, rows], rkc[:, :, rows]),
                       ("v_commit", gvc[:, :, rows], rvc[:, :, rows])):
        err = (a.float() - b.float()).abs().max().item()
        scale = b.float().abs().max().item()
        if not (a.dtype == b.dtype == dtype and torch.isfinite(a).all() and err <= tol * scale):
            raise AssertionError(
                f"fused decode kernel disagrees with the plain version ({dname}, {grid}, "
                f"dims {dims}, bias {bias_col}, step {step}, {name}): max abs err {err} > "
                f"{tol} x {scale}, {a.dtype}")
        errs[name] = {"max_abs_err": err, "max_abs_ref": scale}
    for name, a, b in (("k_caches", gkc, kc0), ("v_caches", gvc, vc0)):
        a, b = a.clone(), b.clone()
        a[:, :, rows] = b[:, :, rows] = 0
        if not torch.equal(a, b):
            raise AssertionError(f"the fused decode kernel wrote {name} rows outside the "
                                 f"commit rows of step {step} (dims {dims})")
    kc, vc = kc0.clone(), vc0.clone()
    ms = time_cuda(lambda: fd.FUSED_DECODE[grid](*args(kc, vc), **kw), iters=iters)
    plain_ms = time_cuda(lambda: fd.fused_decode_step_plain(*args(kc, vc), **kw),
                         iters=plain_iters)
    bound_ms, bound_by, nbytes, flops, simt_ms = fused_decode_bound_ms(inp, dims, step + 1)
    return {"step": step, "errors": errs,
            "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
            "tolerance": tol * errs["x_out"]["max_abs_ref"], "repeat_bitwise": True,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_f32_simt_ms": simt_ms, "bytes": nbytes, "flops": flops}


def check_fused_decode(dims, steps_at=FUSED_STEPS):
    """Phase 3: the fused decode kernel (K3/K4) against its plain version on
    the card, at the serving path's shapes: grids "video" and "batch" x memory
    K/V dense and int8 x bias column on and off, at each step of
    ``steps_at``, in f32 and in bf16 (``fused_step_case``)."""
    import torch

    from multimodal_feature_learning_tpu_torch.ops import fused_decode as fd

    B = dims[0]
    lines = []
    seed = 0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for grid, kv_mode, bias_col in ((g, kv, bias) for g in ("video", "batch")
                                        for kv in ("dense", "int8") for bias in (False, True)):
            seed += 1
            inp = fused_decode_inputs(dims, bias_col, kv_mode, seed, dtype)
            steps = [fused_step_case(inp, dims, step, grid, bias_col, FUSED_TOL[dname])
                     for step in steps_at]
            mid = steps[len(steps) // 2]
            lines.append({
                "dtype": dname, "grid": grid, "kv": kv_mode, "bias_col": bias_col,
                "batch_tile": 1 if grid == "video" else fd.batch_tile_for(B),
                "max_abs_err": max(c["max_abs_err"] for c in steps),
                "ms": mid["ms"], "plain_ms": mid["plain_ms"], "bound_ms": mid["bound_ms"],
                "bound_by": mid["bound_by"], "bound_f32_simt_ms": mid["bound_f32_simt_ms"],
                "library_ms": None,  # no single PyTorch call computes a decode step
                "steps": steps})
            del inp
    return lines


# The widths and shapes beyond the flagship's that the fused decode kernel
# is held at (name, (B, G, D, H, depth, Tc, S, F), step): JAX's own kernel
# test (tests/test_fused_decode.py: D 64, 2 heads, depth 2, G 4, Sp 128), the
# long-video flagship (pyramid (1200, 600, 300, 150): S 2250, Sp 2304),
# D 768 / 12 heads, D 1024 / 16 heads (F 4096: the f32 GEMM tiles read W in
# chunks), D 1024 / 8 heads (Dh 128), mlp_ratio 2, G 24 (48 rows: two row
# tiles), D 480 / 6 heads (Dh 80; a width no multiple of 64, so a column
# block is part masked), depth 24, and three corners: G 32 with Sp 4096 at Dh 128 (the f32
# cross-attention in one buffer, q from L2), Dh 16 (64 heads: the combine a
# chunk a group), and a caption of 200 tokens (the self-attention in
# position tiles).
FUSED_WIDTHS = (
    ("jax_test", (2, 4, 64, 2, 2, 8, 40, 256), 4),
    ("long_flagship", (BATCH, 10, 512, 8, 6, 20, 2250, 2048), 9),
    ("d768_h12", (BATCH, 10, 768, 12, 6, 20, 563, 3072), 9),
    ("d1024_h16", (BATCH, 10, 1024, 16, 6, 20, 563, 4096), 9),
    ("d1024_h8", (BATCH, 10, 1024, 8, 6, 20, 563, 4096), 9),
    ("mlp_ratio2", (BATCH, 10, 512, 8, 6, 20, 563, 1024), 9),
    ("g24", (BATCH, 24, 512, 8, 6, 20, 563, 2048), 9),
    ("d480_dh80", (4, 10, 480, 6, 2, 20, 563, 1920), 9),
    ("depth24", (BATCH, 10, 512, 8, 24, 20, 563, 2048), 9),
    ("g32_sp4096_dh128", (2, 32, 1024, 8, 2, 20, 4000, 4096), 9),
    ("dh16", (2, 32, 1024, 64, 2, 20, 4000, 4096), 9),
    ("caption200", (2, 32, 1024, 8, 1, 200, 4000, 4096), 199),
)
# each shape's cases: (dtype, K/V, grid), the bias column on
FUSED_WIDTH_CASES = (("float32", "dense", "video"), ("float32", "int8", "batch"),
                     ("bfloat16", "dense", "batch"), ("bfloat16", "int8", "video"))


def fused_widths():
    """Phase fused_widths: K3/K4 at every shape of FUSED_WIDTHS, one step in
    each case of FUSED_WIDTH_CASES, against the plain version on the card
    (``fused_step_case``: errors, committed and untouched rows, two launches
    bit for bit, ms, plain ms, bound), with the schedule the library chose
    (the flagship's or the general one) and its shared memory, which must
    equal the wrapper's plan (``smem_plan``) where the schedule is general."""
    import torch

    from multimodal_feature_learning_tpu_torch.ops import fused_decode as fd

    lines = []
    seed = 100
    for name, dims, step in FUSED_WIDTHS:
        B, G, D, H, depth, Tc, S, F = dims
        for dname, kv_mode, grid in FUSED_WIDTH_CASES:
            seed += 1
            dtype = getattr(torch, dname)
            inp = fused_decode_inputs(dims, True, kv_mode, seed, dtype)
            case = fused_step_case(inp, dims, step, grid, True, FUSED_TOL[dname],
                                   iters=20, plain_iters=3)
            Sp = inp["mem_k"].shape[2]
            smem, schedule = fd.FUSED_DECODE[grid].plan(B, G, D, H, Tc * G, Sp, F,
                                                         kv_mode == "int8", dname == "bfloat16")
            mirror = fd.smem_plan(D, D // H, G, Tc, Sp, dname == "bfloat16", kv_mode == "int8")
            if schedule == "general" and smem != mirror["bytes"]:
                raise AssertionError(f"fused_widths {name}: the library plans {smem} bytes, "
                                     f"smem_plan {mirror['bytes']}")
            lines.append({"shape": name, "dims": dict(zip("B G D H depth Tc S F".split(), dims)),
                          "Sp": Sp, "dtype": dname, "kv": kv_mode, "grid": grid,
                          "bias_col": True, "schedule": schedule, "smem_bytes": smem,
                          "plan": mirror, "library_ms": None,
                          **{k: v for k, v in case.items() if k != "errors"},
                          "errors": case["errors"]})
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
    column; and for the bf16 step, grid "video" ("video_bf16")."""
    import torch

    from multimodal_feature_learning_tpu_torch.ops import fused_decode as fd

    B, G, D, H, depth, Tc, S, F = dims
    out = {}
    for name, grid, dtype in (("video", "video", torch.float32), ("batch", "batch", torch.float32),
                              ("video_bf16", "video", torch.bfloat16)):
        inp = fused_decode_inputs(dims, False, "dense", seed=1, dtype=dtype)
        kernel = fd.FusedDecodeKernel(grid, "", flags=fd.STAGE_TIMING_FLAGS)
        for _ in range(3):
            kernel(inp["x"], inp["k_caches"], inp["v_caches"], 9, 10, inp["mem_k"],
                   inp["mem_v"], None, None, inp["mask_i8"], inp["log_m"], inp["weights"],
                   G=G, num_heads=H, has_bias_col=False)
        torch.cuda.synchronize()
        out[name] = kernel.stage_us(depth)
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


def build_flagship(device, compute_dtype: str = "float32", video_rescale_len: int = 0):
    """Full-width flagship model on ``device`` with the trained weights of
    snapshots/conv_e79.npz, loaded strictly, in ``compute_dtype`` (the
    config's: f32 masters, bf16 copies in every forward), at the config's
    rescale length or ``video_rescale_len`` (no weight depends on it).
    conv_e79 was trained without the differentiable context mask (the
    snapshot holds no context_mask parameters), so it runs without it and
    without the contexts loss."""
    from multimodal_feature_learning_tpu_torch.config import load_config, recompute_losses
    from multimodal_feature_learning_tpu_torch.models.dvc import build_model
    from multimodal_feature_learning_tpu_torch.utils.weights import load_flax_params, load_npz

    cfg = load_config()
    cfg.compute_dtype = compute_dtype
    if video_rescale_len:
        cfg.dvc.detr.video_rescale_len = video_rescale_len
        cfg.dataset.activity_net.video_rescale_len = video_rescale_len
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
    from multimodal_feature_learning_tpu_torch.ops.hungarian import HUNGARIAN
    from multimodal_feature_learning_tpu_torch.ops.probe_add import PROBE_ADD

    return {"msda_fwd": msda.MSDA_FWD, "msda_bwd": msda.MSDA_BWD,
            "fused_decode_video": fd.FUSED_DECODE["video"],
            "fused_decode_batch": fd.FUSED_DECODE["batch"], "probe_add": PROBE_ADD,
            "hungarian": HUNGARIAN}


class recording_matchings:
    """Within the block, every Hungarian matching of a model (the
    ``batched_hungarian_torch`` call of ``models.dvc.match_layers``, through
    which every family matches) is recorded: a list with one entry a
    matching, with ``keep`` its (cost, valid, indices) cloned on their
    device (no host synchronisation), else None. On the card each matching
    is one K6 launch."""

    def __init__(self, keep: bool = False):
        self.keep = keep

    def __enter__(self):
        from multimodal_feature_learning_tpu_torch.models import dvc

        self.module, self.orig, records = dvc, dvc.batched_hungarian_torch, []

        def recording(cost, valid):
            idx = self.orig(cost, valid)
            records.append((cost.detach().clone(), valid.clone(), idx.clone())
                           if self.keep else None)
            return idx

        dvc.batched_hungarian_torch = recording
        return records

    def __exit__(self, *exc):
        self.module.batched_hungarian_torch = self.orig


def msda_per_forward(cfg, encoder_only: bool = False) -> int:
    """MSDA calls (K1 launches) in one forward of ``cfg``'s family: a
    unimodal encoder layer makes one and a decoder layer one; a multimodal
    encoder layer four (self-attention in each modality and a cross-modal
    call each way) and a decoder layer two (one into each memory); the
    regular family none."""
    det = cfg.dvc.detr
    if not (cfg.dvc.use_sparse_detr or cfg.dvc.use_deformable_detr):
        return 0  # the regular family attends with plain products only
    enc, dec = (4, 2) if len(cfg.dvc.input_modalities) == 2 else (1, 1)
    return enc * det.enc_layers + (0 if encoder_only else dec * det.dec_layers)


def without_dropout(cfg):
    """A copy of ``cfg`` with every dropout rate 0."""
    import dataclasses

    cfg = dataclasses.replace(cfg)
    cfg.dvc = dataclasses.replace(cfg.dvc, detr=dataclasses.replace(
        cfg.dvc.detr, transformer_dropout_prob=0.0), caption=dataclasses.replace(
        cfg.dvc.caption, positional_embedding_dropout=0.0, attention_dropout=0.0,
        projection_dropout=0.0, bridge_dropout=0.0, mlp_dropout_1=0.0, mlp_dropout_2=0.0))
    return cfg


def build_family(cfg, vocab_size: int, device, flat=None, embedding_matrix=None):
    """The model of ``cfg``'s family (the unimodal ``models.dvc`` model, the
    multimodal one for two input modalities, raw with ``use_raw_videos``, or
    the regular one with both family flags off) on ``device``, carrying the
    flat flax params ``flat`` (loaded strictly) or, without them, weights
    drawn from ``cfg.seed``; with ``embedding_matrix`` (GloVe's) its caption
    embedding is the pretrained embedder."""
    from multimodal_feature_learning_tpu_torch.models.dvc import build_model
    from multimodal_feature_learning_tpu_torch.models.multimodal import build_multimodal_model
    from multimodal_feature_learning_tpu_torch.models.regular_dvc import build_regular_model
    from multimodal_feature_learning_tpu_torch.utils.weights import load_flax_params

    if not (cfg.dvc.use_sparse_detr or cfg.dvc.use_deformable_detr):
        build = build_regular_model
    else:
        build = build_multimodal_model if len(cfg.dvc.input_modalities) == 2 else build_model
    model = build(cfg, vocab_size, device=device, seed=cfg.seed,
                  embedding_matrix=embedding_matrix)
    if flat is not None:
        load_flax_params(model, flat)
    return model


class recording_msda_calls:
    """Within the block, every MSDA call of the model (``models/msda_module``)
    records its query and value rows (``Q``, ``S``) and, with ``tensors``,
    its (value, loc, aw) and, once the backward has run, the gradient of its
    output: a list of dicts, in call order. Each call on the card is one K1
    launch."""

    def __init__(self, tensors: bool = True):
        self.tensors = tensors

    def __enter__(self):
        from multimodal_feature_learning_tpu_torch.models import msda_module

        self.module, self.orig, records = msda_module, msda_module.ms_deform_attn, []

        def recording(value, shapes, loc, aw):
            out = self.orig(value, shapes, loc, aw)
            rec = {"Q": loc.shape[1], "S": value.shape[1]}
            if self.tensors:
                rec.update(value=value.detach(), shapes=tuple(shapes), loc=loc.detach(),
                           aw=aw.detach())
                if out.requires_grad:
                    out.register_hook(lambda g: rec.__setitem__("g", g.detach().contiguous()))
            records.append(rec)
            return out

        msda_module.ms_deform_attn = recording
        return records

    def __exit__(self, *exc):
        self.module.ms_deform_attn = self.orig


def calls_by_shape(records) -> dict:
    """``recording_msda_calls``' records counted by shape: {"Q=563 S=563":
    calls} (queries, value rows)."""
    counts = {}
    for r in records:
        key = f"Q={r['Q']} S={r['S']}"
        counts[key] = counts.get(key, 0) + 1
    return counts


def serve(model, requests, rank: str = "stability"):
    """Phases 5 and 7: the requests through DVCServer (ranking by ``rank``).
    Every kernel's launch count is set to 0 just before the first request
    and read just after the last; the decode steps of every dispatch are
    read from its captions. Returns the results, latencies, wall seconds,
    launches, the server's stats and the decode steps per dispatch."""
    from multimodal_feature_learning_tpu_torch.serve import DVCServer
    from multimodal_feature_learning_tpu_torch.tools.profile_decode import decode_steps_run

    server = DVCServer(model, batch_size=BATCH, max_wait_ms=10.0, rank=rank)
    steps = []
    forward = model.forward_serve

    def recording_forward(*args, **kwargs):
        out = forward(*args, **kwargs)
        captions = out["captions"].reshape(-1, out["captions"].shape[-1])
        steps.append(decode_steps_run(captions, model.eos_idx, model.seq_len))
        return out

    model.forward_serve = recording_forward
    try:
        results, latencies, wall, launches, stats = drive(server, requests)
    finally:
        del model.forward_serve
    return results, latencies, wall, launches, stats, steps


def drive(server, requests):
    """The requests through ``server`` as one closed burst, then the server
    closed. Every kernel's launch count is set to 0 just before the first
    submit and read just after the last answer. Returns the results,
    latencies, wall seconds (first submit to last answer), launches and the
    server's stats."""
    counters = kernel_counters()
    try:
        done_at = [0.0] * len(requests)
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
    latencies = [done_at[i] - t for i, (t, _) in enumerate(futures)]
    return results, latencies, wall, launches, stats


CONTINUOUS_CHUNK = 4  # decode tokens a dispatch of the continuous server


def compare_results(requests, results, reference, what: str,
                    min_token_agreement: float = 0.0) -> dict:
    """``results`` against ``reference`` (both lists of events per request):
    k equal, segments within 1e-3 x the duration, at least 90% of caption
    rows identical (f32 sums in another order can flip a near-tie argmax,
    which changes the rest of that caption). With ``min_token_agreement``
    (two bf16 decodes, which round at other places, as ``check_fused``
    holds them) at least that share of caption tokens equal instead of
    rows."""
    import numpy as np

    rows = rows_equal = tokens = tokens_equal = 0
    worst_seg = 0.0
    for (_, dur), got, ref in zip(requests, results, reference):
        if len(got) != len(ref):
            raise AssertionError(f"{what}: k {len(got)} against {len(ref)}")
        for a, b in zip(got, ref):
            worst_seg = max(worst_seg, float(np.max(np.abs(np.subtract(a["segment"],
                                                                       b["segment"])))) / dur)
            rows += 1
            rows_equal += a["caption"] == b["caption"]
            tokens += len(a["caption"])
            tokens_equal += sum(x == y for x, y in zip(a["caption"], b["caption"]))
    agree = tokens_equal / max(tokens, 1)
    if worst_seg > 1e-3 or ((agree < min_token_agreement) if min_token_agreement
                            else rows_equal < 0.9 * rows):
        raise AssertionError(f"{what}: segment err {worst_seg} of the duration, "
                             f"{rows_equal}/{rows} caption rows and {agree:.4f} of tokens equal")
    return {"max_segment_err_of_duration": worst_seg, "caption_rows_equal": rows_equal,
            "caption_rows": rows, "token_agreement": agree}


def serve_continuous(cfg, model, requests, static_results, device="cuda"):
    """Phase serve_continuous: the same requests through ContinuousDVCServer
    (BATCH slots, CONTINUOUS_CHUNK tokens a chunk), launches counted over
    exactly these requests. Checks: every request answered, well formed;
    the answers against the serve phase's by check_results' standard; K1
    launched 12 times a prefill and never by a chunk. Then one chunk of a
    fresh full pool under torch.profiler (device busy share)."""
    import numpy as np
    import torch

    from multimodal_feature_learning_tpu_torch.data.anet import nearest_resize
    from multimodal_feature_learning_tpu_torch.serve import ContinuousDVCServer

    server = ContinuousDVCServer(model, batch_size=BATCH, chunk=CONTINUOUS_CHUNK)
    results, latencies, wall, launches, stats = drive(server, requests)
    if len(results) != len(requests):
        raise AssertionError(f"{len(results)} of {len(requests)} requests answered")
    check_results(cfg, model, requests, results, compare_cpu=False)
    agreement = compare_results(requests, results, static_results,
                                "continuous against static serving")
    per_forward = cfg.dvc.detr.enc_layers + cfg.dvc.detr.dec_layers
    if launches["msda_fwd"] != per_forward * stats["prefills"] or stats["errors"]:
        raise AssertionError(f"msda_fwd launched {launches['msda_fwd']} times over "
                             f"{stats['prefills']} prefills ({per_forward} each); "
                             f"{stats['errors']} errors")
    if any(launches[k] for k in ("fused_decode_video", "fused_decode_batch", "msda_bwd")):
        raise AssertionError(f"continuous serving launched {launches}")

    T = model.video_rescale_len
    video = torch.from_numpy(np.stack([nearest_resize(f[None], T, axis=1)[0]
                                       for f, _ in requests[:BATCH]])).to(device)
    durs = torch.tensor([d for _, d in requests[:BATCH]], dtype=torch.float32, device=device)
    ctx, state = model.forward_serve_prefill(video, torch.zeros((BATCH, T), dtype=torch.bool,
                                                                device=device), durs)
    active = torch.ones(BATCH, dtype=torch.bool, device=device)
    wall_ms, device_ms, chunk_launches, _ = profile_call(
        lambda: model.forward_serve_decode_chunk(ctx, state, active, CONTINUOUS_CHUNK))
    lat = sorted(latencies)
    return {"requests": len(requests), "answered": len(results), "slots": BATCH,
            "chunk": CONTINUOUS_CHUNK, "videos_per_s": len(requests) / wall,
            "p50_latency_s": lat[len(lat) // 2], "max_latency_s": lat[-1],
            "prefills": stats["prefills"], "chunks": stats["chunks"],
            "dispatches": stats["dispatches"], "step_s": stats["step_s"],
            "mean_prefill_ms": 1e3 * stats["prefill_s"] / stats["prefills"],
            "mean_chunk_ms": 1e3 * stats["chunk_s"] / stats["chunks"],
            "mean_step_ms": 1e3 * stats["step_s"] / (stats["dispatches"] + stats["chunks"]),
            "launches": launches, "against_static": agreement,
            "profiled_chunk_wall_ms": wall_ms, "profiled_chunk_device_ms": device_ms,
            "profiled_chunk_launches": chunk_launches,
            "chunk_device_busy_share": device_ms / wall_ms}


SERVE_CLI_REQUESTS, SERVE_CLI_RPS, SHED_RPS, SHED_QUEUE = 64, 50, 1000, 4


def serve_cli(world: dict, device="cuda"):
    """Phase serve_cli: the serving CLI (serve.main) in-process over the
    evaluation world with conv_e79, SERVE_CLI_REQUESTS val requests at
    SERVE_CLI_RPS Poisson: static, then continuous (chunk
    CONTINUOUS_CHUNK); then static with --max-queue SHED_QUEUE at SHED_RPS,
    which it cannot sustain. Each row is printed; launches are counted over
    each whole CLI call (model build and warm-up included)."""
    from multimodal_feature_learning_tpu_torch import serve

    common = ["--weights", SNAPSHOT, "--device", device, "--batch-size", str(BATCH),
              "--n-requests", str(SERVE_CLI_REQUESTS), "--config-overrides",
              "use_differentiable_mask=false", *[f"{k}={v}" for k, v in world.items()]]
    counters = kernel_counters()
    rows, launches = {}, {}
    for name, extra in (("static", ["--rps", str(SERVE_CLI_RPS)]),
                        ("continuous", ["--rps", str(SERVE_CLI_RPS), "--continuous",
                                        "--chunk", str(CONTINUOUS_CHUNK)]),
                        ("static_max_queue", ["--rps", str(SHED_RPS),
                                              "--max-queue", str(SHED_QUEUE)])):
        for k in counters.values():
            k.launches = 0
        rows[name] = serve.main([*extra, *common])
        launches[name] = {k: c.launches for k, c in counters.items()}
    for name in ("static", "continuous"):
        row = rows[name]
        if row["requests"] != SERVE_CLI_REQUESTS or row["shed"] or row["mode"] != name:
            raise AssertionError(f"serve_cli {name}: {row}")
    shed = rows["static_max_queue"]
    if not (shed["shed"] > 0 and shed["requests"] + shed["shed"] == SERVE_CLI_REQUESTS):
        raise AssertionError(f"serve_cli: --max-queue {SHED_QUEUE} at {SHED_RPS} rps shed "
                             f"nothing: {shed}")
    return {"rows": rows, "launches": launches}


TRAIN_VIDEOS = 64  # train split of the evaluation world
TRAIN_CLI_EPOCHS, TRAIN_CLI_VAL_SUBSET = 2, 16


def train_cli(world: dict, device="cuda"):
    """Phase train_cli: the training CLI (main.main) in-process over the
    evaluation world's train split (TRAIN_VIDEOS videos, batch BATCH) from
    conv_e79, with dropout: TRAIN_CLI_EPOCHS epochs with eval_rate 1,
    checkpoint_rate 1 and the first TRAIN_CLI_VAL_SUBSET val videos; then
    --resume of its checkpoint for one more epoch; then inference.main
    --resume of the last checkpoint; then, beside them, one epoch from
    conv_e79 at steps_per_dispatch=4 (the 4 steps of the epoch as one
    dispatch) into its own directory. Launches are counted over each CLI
    call; each epoch's loader waits and steps are timed (TimedLoader around
    the CLI's train loader) and its per-step logs kept. Checks:
    train_log.txt holds epochs 0, 1, 2 with finite losses; the resumed run
    starts at epoch 2; K2 launched 12 times a train step, K1 12 times a
    train step and an eval batch, K6 once a train step and an eval batch;
    the rolling and the numbered checkpoints exist; inference scores the
    checkpoint; the steps_per_dispatch=4 epoch logs 4 finite per-step
    losses with the same launches a step."""
    import torch

    from multimodal_feature_learning_tpu_torch import inference
    from multimodal_feature_learning_tpu_torch import main as train_main
    from multimodal_feature_learning_tpu_torch.config import load_config

    out = os.path.join(EVAL_WORLD, "train_cli")
    if os.path.isdir(out):
        import shutil

        shutil.rmtree(out)
    overrides = ["use_differentiable_mask=false", "eval_rate=1", "checkpoint_rate=1",
                 f"dataset.activity_net.val_subset={TRAIN_CLI_VAL_SUBSET}", "print_freq=0",
                 *[f"{k}={v}" for k, v in world.items()]]
    common = ["--weights", SNAPSHOT, "--device", device, "--batch-size", str(BATCH),
              "--output-dir", out, "--config-overrides", *overrides]
    counters = kernel_counters()
    runs, launches, split, step_logs = [], [], [], []
    real_epoch = train_main.train_one_epoch

    def timed_epoch(train_step, state, loader, epoch, *args, **kwargs):
        timed = TimedLoader(loader)
        logs = []
        result = real_epoch(train_step, state, timed, epoch, *args,
                            step_logger=lambda log, step: logs.append(log), **kwargs)
        split.append({"epoch": epoch, "loader_wait_ms": [1e3 * s for s in timed.wait],
                      "step_ms": [1e3 * s for s in timed.busy]})
        step_logs.append(logs)
        return result

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    train_main.train_one_epoch = timed_epoch
    try:
        for extra in (["--epochs", str(TRAIN_CLI_EPOCHS)],
                      ["--epochs", str(TRAIN_CLI_EPOCHS + 1), "--resume",
                       os.path.join(out, "checkpoint")]):
            for k in counters.values():
                k.launches = 0
            runs.append(train_main.main([*extra, *common]))
            launches.append({k: c.launches for k, c in counters.items()})
        for k in counters.values():
            k.launches = 0
        multistep_out = os.path.join(out, "steps_per_dispatch_4")
        multistep = train_main.main([
            "--epochs", "1", "--weights", SNAPSHOT, "--device", device, "--batch-size",
            str(BATCH), "--output-dir", multistep_out, "--config-overrides", *overrides,
            f"steps_per_dispatch={MULTISTEP_K}"])
        multistep_launches = {k: c.launches for k, c in counters.items()}
    finally:
        train_main.train_one_epoch = real_epoch
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
    for k in counters.values():
        k.launches = 0
    stats, submission, scores = inference.main(
        ["--resume", os.path.join(out, "checkpoint"), "--device", device, "--batch-size",
         str(BATCH), "--config-overrides", *overrides,
         f"submission_dir={os.path.join(out, 'inference')}"])
    inference_launches = {k: c.launches for k, c in counters.items()}

    with open(os.path.join(out, "train_log.txt")) as f:
        log = [json.loads(line) for line in f]
    if [r["epoch"] for r in log] != list(range(TRAIN_CLI_EPOCHS + 1)) or not all(
            math.isfinite(r["train_loss"]) and math.isfinite(r["val_loss"]) for r in log):
        raise AssertionError(f"train_cli: train_log.txt {log}")
    if runs[1]["start_epoch"] != TRAIN_CLI_EPOCHS:
        raise AssertionError(f"train_cli: the resumed run started at {runs[1]['start_epoch']}")
    det = load_config().dvc.detr
    per_forward = det.enc_layers + det.dec_layers
    steps_per_epoch = -(-TRAIN_VIDEOS // BATCH)
    eval_batches = -(-TRAIN_CLI_VAL_SUBSET // BATCH)
    for run, n in zip(runs, launches):
        epochs = len(run["epochs"])
        steps = epochs * steps_per_epoch
        want = {"msda_bwd": per_forward * steps,
                "msda_fwd": per_forward * (steps + epochs * eval_batches),
                "hungarian": steps + epochs * eval_batches}
        if any(n[k] != v for k, v in want.items()):
            raise AssertionError(f"train_cli: launches {n} over {steps} steps and "
                                 f"{epochs * eval_batches} eval batches, expected {want}")
    want = {"msda_bwd": per_forward * steps_per_epoch,
            "msda_fwd": per_forward * (steps_per_epoch + eval_batches),
            "hungarian": steps_per_epoch + eval_batches}
    multistep_losses = [log["loss"] for log in step_logs[-1]]
    if any(multistep_launches[k] != v for k, v in want.items()) or \
            len(multistep_losses) != steps_per_epoch or \
            not all(math.isfinite(x) for x in multistep_losses):
        raise AssertionError(f"train_cli steps_per_dispatch={MULTISTEP_K}: launches "
                             f"{multistep_launches}, expected {want}; per-step losses "
                             f"{multistep_losses}")
    names = sorted(os.listdir(out))
    want_files = ["checkpoint"] + [f"checkpoint{e:04d}" for e in range(TRAIN_CLI_EPOCHS + 1)]
    if not set(want_files) <= set(names):
        raise AssertionError(f"train_cli: {names} lacks a checkpoint of {want_files}")
    if len(submission["results"]) != TRAIN_CLI_VAL_SUBSET or not all(
            math.isfinite(v) for v in scores.values()) or \
            inference_launches["msda_fwd"] != per_forward * eval_batches or \
            inference_launches["hungarian"] != eval_batches:
        raise AssertionError(f"train_cli: inference --resume gave {len(submission['results'])}"
                             f" videos, scores {scores}, launches {inference_launches}")
    seconds = [s for run in runs for s in run["train_seconds"]]
    return {"train_videos": TRAIN_VIDEOS, "batch": BATCH, "steps_per_epoch": steps_per_epoch,
            "epochs": [{k: v for k, v in r.items() if not k.startswith("score_")
                        or k in ("score_METEOR", "score_CIDEr", "score_F1_score")}
                       for r in log],
            "train_seconds_per_epoch": seconds,
            "epoch_split": split,
            "step_losses": [[log["loss"] for log in logs] for logs in step_logs],
            "steps_per_dispatch_4": {
                "epoch": {k: v for k, v in multistep["epochs"][0].items()
                          if k.startswith("train_") or k in ("epoch", "val_loss")},
                "train_seconds": multistep["train_seconds"][0],
                "examples_per_s": TRAIN_VIDEOS / multistep["train_seconds"][0],
                "step_losses": multistep_losses, "launches": multistep_launches},
            "checkpoint_seconds_per_epoch": [s for run in runs
                                             for s in run["checkpoint_seconds"]],
            "eval_seconds_per_epoch": [s for run in runs for s in run["eval_seconds"]],
            "examples_per_s_per_epoch": [TRAIN_VIDEOS / s for s in seconds],
            "resumed_start_epoch": runs[1]["start_epoch"], "launches": launches,
            "inference_launches": inference_launches, "inference_val_loss": stats["loss"],
            "inference_scores": score_summary(scores), "max_memory_allocated_bytes": peak,
            "files": names, "inference_run": (stats, submission)}


REF_DIR = os.path.join(ROOT, "build", "ref_checkpoint")
REF_SERVE_REQUESTS = 16


def ref_checkpoint(world: dict, resumed: tuple, device="cuda"):
    """Phase ref_checkpoint (after train_cli): a reference SAGA-DVC .pth
    into the port and out of it through the CLIs (utils/ref_bridge.py),
    the flagship at full width from conv_e79, the context mask off, over
    the evaluation world. (a) conv_e79's model written as a reference .pth
    (``reference_state_dict``) under build/ref_checkpoint, read back under
    ``weights_only`` (its leftover keys counted); the same with a pickled
    ``argparse.Namespace`` beside it refused without trust and loaded
    with it; inference.main
    --from-reference-checkpoint and --weights conv_e79 on the first
    TRAIN_CLI_VAL_SUBSET val videos: submissions, stats and scores equal.
    (b) tools/export_to_reference of train_cli's last checkpoint, read back
    under ``weights_only`` with its epoch, then inference.main
    --from-reference-checkpoint of it: equal to train_cli's inference
    --resume (``resumed``: its stats and submission). (c) serve.main
    --from-reference-checkpoint of (a)'s file, static, REF_SERVE_REQUESTS
    requests, decode_impl "fused" (grid "video"): the served model's
    state_dict bit for bit conv_e79's, K1 12 times a forward, the fused
    kernel once per decode step. (d) main.main from (a)'s file for one
    epoch of one step (train_subset BATCH), eval_rate 0 (the last epoch
    still evaluates its one batch): finite losses, K2 12 times the step,
    K1 12 times the step and the eval batch, K6 once each. Launches are
    counted over each CLI call. Any failed call fails the phase."""
    import torch

    from multimodal_feature_learning_tpu_torch import inference, serve
    from multimodal_feature_learning_tpu_torch import main as train_main
    from multimodal_feature_learning_tpu_torch.tools import export_to_reference
    from multimodal_feature_learning_tpu_torch.tools.profile_decode import decode_steps_run
    from multimodal_feature_learning_tpu_torch.utils import ref_bridge

    os.makedirs(REF_DIR, exist_ok=True)
    counters = kernel_counters()
    seconds, launches = {}, {}

    def counted(name, fn, *args):
        for k in counters.values():
            k.launches = 0
        t0 = time.monotonic()
        out = fn(*args)
        seconds[name] = time.monotonic() - t0
        launches[name] = {k: c.launches for k, c in counters.items()}
        return out

    overrides = ["use_differentiable_mask=false", "print_freq=0",
                 f"dataset.activity_net.val_subset={TRAIN_CLI_VAL_SUBSET}",
                 *[f"{k}={v}" for k, v in world.items()]]
    common = ["--device", device, "--batch-size", str(BATCH), "--config-overrides",
              *overrides]

    # (a) conv_e79 as a reference .pth; inference from it and from --weights
    t0 = time.monotonic()
    cfg, model, _, _ = build_flagship(device)
    pth = os.path.join(REF_DIR, "conv_e79.pth")
    sd = ref_bridge.reference_state_dict(model, cfg)
    torch.save({"model": sd, "epoch": 79}, pth)
    leftover = ref_bridge.import_reference_state_dict(
        torch.load(pth, map_location="cpu", weights_only=True)["model"], model, cfg)
    # a file with a pickled object beside the tensors, as the reference's
    # checkpoints carry their config: refused unless trusted
    pickled = os.path.join(REF_DIR, "conv_e79_with_args.pth")
    torch.save({"model": sd, "args": argparse.Namespace(lr=1e-4)}, pickled)
    try:
        ref_bridge.load_reference_checkpoint(pickled, model, cfg)
    except ValueError as e:
        refused = "--trust-checkpoint" in str(e)
    else:
        refused = False
    if not refused or ref_bridge.load_reference_checkpoint(pickled, model, cfg,
                                                           trust_pickle=True) != leftover:
        raise AssertionError("ref_checkpoint (a): a .pth with a pickled object was not "
                             "refused under weights_only, or did not load when trusted")
    seconds["write_pth"] = time.monotonic() - t0
    runs = {}
    for name, flag, src in (("weights", "--weights", SNAPSHOT),
                            ("reference", "--from-reference-checkpoint", pth)):
        runs[name] = counted(f"inference_{name}", inference.main, [
            flag, src, *common, f"submission_dir={os.path.join(REF_DIR, name)}"])
    (w_stats, w_sub, w_scores), (r_stats, r_sub, r_scores) = runs["weights"], runs["reference"]
    if len(r_sub["results"]) != TRAIN_CLI_VAL_SUBSET or r_sub["results"] != w_sub["results"] \
            or r_stats != w_stats or r_scores != w_scores:
        raise AssertionError(f"ref_checkpoint (a): --from-reference-checkpoint gave stats "
                             f"{r_stats}, scores {r_scores}; --weights {w_stats}, {w_scores}; "
                             f"{len(r_sub['results'])} videos")

    # (b) train_cli's last checkpoint exported, then inferred from
    exported = os.path.join(REF_DIR, "train_cli.pth")
    ckpt = os.path.join(EVAL_WORLD, "train_cli", "checkpoint")
    done = counted("export", export_to_reference.main,
                   ["--resume", ckpt, "--out", exported, "--device", device,
                    "--config-overrides", *overrides])
    epoch = torch.load(exported, map_location="cpu", weights_only=True)["epoch"]
    e_stats, e_sub, _ = counted("inference_exported", inference.main, [
        "--from-reference-checkpoint", exported, *common,
        f"submission_dir={os.path.join(REF_DIR, 'exported')}"])
    if epoch != TRAIN_CLI_EPOCHS or e_sub["results"] != resumed[1]["results"] \
            or e_stats != resumed[0]:
        raise AssertionError(f"ref_checkpoint (b): the export of epoch {epoch} gave stats "
                             f"{e_stats}; inference --resume {resumed[0]}")

    # (c) the serving CLI from (a)'s file, fused decode
    served, steps = [], []
    real_server = serve.DVCServer

    class RecordingServer(real_server):
        """The CLI's server, keeping its model and each forward's decode
        steps."""

        def __init__(self, served_model, *args, **kwargs):
            served.append(served_model)
            forward = served_model.forward_serve

            def recording_forward(*f_args, **f_kwargs):
                out = forward(*f_args, **f_kwargs)
                captions = out["captions"].reshape(-1, out["captions"].shape[-1])
                steps.append(decode_steps_run(captions, served_model.eos_idx,
                                              served_model.seq_len))
                return out

            served_model.forward_serve = recording_forward
            super().__init__(served_model, *args, **kwargs)

    serve.DVCServer = RecordingServer
    try:
        row = counted("serve", serve.main, [
            "--from-reference-checkpoint", pth, "--n-requests", str(REF_SERVE_REQUESTS),
            "--rps", str(SERVE_CLI_RPS), *common, "decode_impl=fused",
            "decode_fused_grid=video"])
    finally:
        serve.DVCServer = real_server
    per_forward = cfg.dvc.detr.enc_layers + cfg.dvc.detr.dec_layers
    n = launches["serve"]
    own, got = model.state_dict(), served[0].state_dict()
    if row["requests"] != REF_SERVE_REQUESTS or row["shed"] or \
            n["msda_fwd"] != per_forward * len(steps) or \
            n["fused_decode_video"] < sum(steps) or n["fused_decode_batch"] or \
            sorted(got) != sorted(own) or not all(torch.equal(got[k], own[k]) for k in own):
        raise AssertionError(f"ref_checkpoint (c): row {row}, launches {n} over {len(steps)} "
                             f"forwards of {steps} decode steps, or the served weights "
                             "differ from conv_e79's")
    del served[:], model, own, got

    # (d) the training CLI from (a)'s file, one step
    run = counted("train", train_main.main, [
        "--from-reference-checkpoint", pth, "--epochs", "1", "--output-dir",
        os.path.join(REF_DIR, "train"), *common, "eval_rate=0",
        f"dataset.activity_net.train_subset={BATCH}"])
    n, record = launches["train"], run["epochs"][0]
    want = {"msda_bwd": per_forward, "msda_fwd": 2 * per_forward, "hungarian": 2}
    if any(n[k] != v for k, v in want.items()) or not all(
            math.isfinite(v) for k, v in record.items()
            if k.startswith(("train_", "val_")) and isinstance(v, float)):
        raise AssertionError(f"ref_checkpoint (d): launches {n}, expected {want}; "
                             f"epoch {record}")
    return {"reference_keys": len(sd), "reference_params": sum(v.numel() for v in sd.values()),
            "leftover_keys": len(leftover), "exported": done, "exported_epoch": epoch,
            "val_loss": {"weights": w_stats["loss"], "reference": r_stats["loss"],
                         "exported": e_stats["loss"]},
            "serve_row": {k: row[k] for k in ("requests", "achieved_rps", "latency_p50_ms",
                                              "dispatches", "mean_step_ms")},
            "serve_decode_steps": steps,
            "train_epoch": {k: v for k, v in record.items()
                            if k.startswith("train_") or k in ("epoch", "val_loss")},
            "seconds_by_call": seconds, "launches": launches}


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


def check_results(cfg, model, requests, results, compare_cpu: bool = True,
                  rank: str = "stability", n_check: int = N_CHECK):
    """Served events are well formed and, with ``compare_cpu``, match the
    port's CPU path (plain MSDA core, CPU matmuls, ranking by ``rank``) on
    the first ``n_check`` videos by ``compare_results``."""
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
    video = np.stack([nearest_resize(f[None], T, axis=1)[0] for f, _ in requests[:n_check]])
    durs = np.array([d for _, d in requests[:n_check]], np.float32)
    cpu_model = copy.deepcopy(model).cpu()
    cpu_model.decode_impl = "xla"
    ref = cpu_model.forward_serve(torch.from_numpy(video),
                                  torch.zeros(video.shape[:2], dtype=torch.bool),
                                  torch.from_numpy(durs), rank=rank)
    cpu_results = [[{"segment": tuple(ref["segments"][i, j].tolist()),
                     "caption": ref["captions"][i, j].tolist()}
                    for j in range(int(ref["k"][i]))] for i in range(n_check)]
    return {"videos": n_check, **compare_results(requests[:n_check], results[:n_check],
                                                 cpu_results, "GPU against CPU serving")}


def check_fused(cfg, model, requests, compare_cpu: bool = True,
                min_token_agreement: float = 0.0):
    """Phase 8: the first BATCH requests as one batch through forward_serve
    with the fused decode (both grids), with the plain-op decode, and with
    int8 memory K/V, all on the card, and, with ``compare_cpu``, the fused
    decode on the port's CPU path for the first N_CHECK videos. On the card
    k and segments are equal (the proposal half is the same); the caption
    rows served (j < k) of the fused decode are at least 90% identical to
    the plain-op decode's and to the CPU path's (f32 sums in another order
    can flip a near-tie argmax, which changes the rest of that caption).
    With ``min_token_agreement`` (the bf16 model, whose two decode paths
    round at other places) their tokens must agree at least that often
    instead of their rows. A row whose every memory
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
        if (tokens < min_token_agreement) if min_token_agreement else same < 0.9 * rows:
            raise AssertionError(f"fused ({grid}) decode: {same}/{rows} caption rows and "
                                 f"{tokens:.4f} of tokens equal to the plain-op decode's")
        report[grid] = {"caption_rows_equal_to_plain": same, "caption_rows": rows,
                        "token_agreement_with_plain": tokens,
                        "all_served_rows_equal_to_plain": agreement(fused, plain)[0]}
        if grid == "video":
            video_fused = fused
    same_vb, _, _ = agreement(video_fused, fused)
    int8 = run(model, "fused", "video", "int8")
    same8, rows8, tokens8 = agreement(int8, video_fused)
    int8_plain = agreement(int8, plain, skip=blocked_rows)
    report["int8_vs_plain"] = {"caption_rows_equal": int8_plain[0],
                               "caption_rows": int8_plain[1], "token_agreement": int8_plain[2]}
    if not compare_cpu:
        return {"videos": BATCH, **report, "video_vs_batch_rows_equal": same_vb,
                "int8_vs_dense": {"caption_rows_equal": same8, "caption_rows": rows8,
                                  "token_agreement": tokens8}}

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


def evaluate_arms(cfg, model, batch, eval_arms=EVAL_ARMS, beam1_min_share: float = 1.0):
    """Phase 12: make_eval_step on one batch (on the model's device) in every
    arm of ``eval_arms`` (EVAL_ARMS), and beam 1. Every kernel's launch count is set to 0
    just before each arm and read just after it, as are the arm's MSDA calls
    by shape; the peak memory is that of the arms. Checks: every loss finite;
    K1 launched once per MSDA call of the forward; the fused arm's kernel
    once per decode step; beam 1 equal to greedy on at least
    ``beam1_min_share`` of the caption rows (by default every row), and
    every row where they part a near-tie (``beam1_divergence_gaps`` within
    NEAR_TIE). Beam 1 picks the top of score + log-softmax, greedy the top
    logit: the same token but where two logits are within the rounding of
    the running score, which the multimodal family's seeded random weights
    leave in a few of the 3,040 decisions of a batch."""
    import torch

    from multimodal_feature_learning_tpu_torch.engine.evaluate import make_eval_step
    from multimodal_feature_learning_tpu_torch.models.criterion import build_criterion
    from multimodal_feature_learning_tpu_torch.tools.profile_decode import decode_steps_run

    criterion, weight_dict = build_criterion(cfg, model.pad_idx)
    counters = kernel_counters()
    per_forward = msda_per_forward(cfg)
    arms, captions, shapes = {}, {}, {}
    torch.cuda.reset_peak_memory_stats()
    for name, val_mode, kw, impl in eval_arms + (("beam1", "beam", {"beam_size": 1}, "xla"),):
        model.decode_impl = impl
        try:
            step = make_eval_step(model, criterion, weight_dict, val_mode, **kw)
            for k in counters.values():
                k.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with recording_msda_calls(tensors=False) as calls, \
                    recording_matchings() as matchings:
                caps, denorm, losses = step(batch)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
        finally:
            model.decode_impl = "xla"
        launches = {k: c.launches for k, c in counters.items()}
        arm_shapes = calls_by_shape(calls)
        for key, n in arm_shapes.items():
            shapes[key] = shapes.get(key, 0) + n
        values = {k: float(v) for k, v in losses.items()}
        if not all(math.isfinite(v) for v in values.values()):
            raise AssertionError(f"eval {name}: non-finite losses {values}")
        steps = decode_steps_run(caps, model.eos_idx, model.seq_len) \
            if val_mode in ("one_by_one", "serve") and not kw.get("faster_eval") else None
        if launches["msda_fwd"] != per_forward:
            raise AssertionError(f"eval {name}: msda_fwd launched {launches['msda_fwd']} "
                                 f"times, the forward has {per_forward} MSDA calls")
        if launches["hungarian"] != len(matchings) or len(matchings) != 1:
            raise AssertionError(f"eval {name}: hungarian launched {launches['hungarian']} "
                                 f"times over {len(matchings)} matchings (one a forward)")
        if impl == "fused" and launches["fused_decode_video"] != steps:
            raise AssertionError(f"eval {name}: fused_decode_video launched "
                                 f"{launches['fused_decode_video']} times over {steps} "
                                 f"decode steps")
        captions[name] = caps.cpu()
        arms[name] = {"val_mode": val_mode, **kw, "decode_impl": impl, "ms": ms,
                      "captions_shape": list(caps.shape), "decode_steps": steps,
                      "loss": values["loss"], "loss_terms": len(values) - 1,
                      "caption_loss_terms": sum(k.startswith("loss_caption") for k in values),
                      "launches": launches, "msda_calls_by_shape": arm_shapes,
                      "segments_max_s": float(denorm.abs().max())}
    peak = torch.cuda.max_memory_allocated()
    n_rows = captions["one_by_one"].shape[0]
    beam1_rows = int((captions["beam1"] == captions["one_by_one"]).all(dim=1).sum())
    gaps = beam1_divergence_gaps(model, batch, captions["one_by_one"], captions["beam1"])
    if beam1_rows < beam1_min_share * n_rows or any(
            g["greedy_top2_logit_gap"] > NEAR_TIE or g["max_abs_logit_diff_greedy_vs_beam1"]
            > NEAR_TIE for g in gaps):
        raise AssertionError(f"beam 1 differs from greedy on {n_rows - beam1_rows} of "
                             f"{n_rows} caption rows: {gaps}")
    fused_rows = None
    if "one_by_one_fused" in captions:
        fused_rows = int((captions["one_by_one_fused"] == captions["one_by_one"])
                         .all(dim=1).sum())
    return {"batch": int(batch["video_tensor"].shape[0]), "arms": arms,
            "msda_calls_by_shape": shapes, "max_memory_allocated_bytes": peak,
            "beam1_rows_equal_to_greedy": beam1_rows,
            "beam1_divergences": gaps,
            "fused_rows_equal_to_plain": fused_rows, "rows": int(captions["one_by_one"].shape[0])}


# where beam 1 and greedy part, greedy's top-2 logit gap and the two decodes'
# logits must be within this of each other: a near-tie, which beam 1's sum of
# a running score (tens) and a log-softmax rounds at about 4e-6
NEAR_TIE = 1e-4


def beam1_divergence_gaps(model, batch, greedy, beam1):
    """In every row where beam 1 and greedy part, both decodes
    run again on ``batch`` with every step's logits recorded
    (``caption.decode_pair``): at the first position the row differs, the
    gap between greedy's two largest logits and the largest difference
    between the two decodes' logits of that row. Logits that agree to f32
    rounding with a gap of that size say the two decodes split a near-tie
    (beam 1 ranks score + log-softmax, greedy the logits)."""
    import torch

    rows = (greedy != beam1).any(dim=1).nonzero()[:, 0].tolist()
    if not rows:
        return []
    recorded = {}
    decode_pair = model.caption.decode_pair
    for mode, kw in (("one_by_one", {}), ("beam", {"beam_size": 1})):
        logits = []

        def recording(*args, **kwargs):
            logits.append(decode_pair(*args, **kwargs).float())
            return logits[-1]

        model.caption.decode_pair = recording
        try:
            with torch.no_grad():
                model.forward_eval(batch, mode, **kw)
        finally:
            del model.caption.decode_pair
        recorded[mode] = logits
    gaps = []
    for r in rows:
        t = int((greedy[r] != beam1[r]).nonzero()[0, 0])
        g, b = recorded["one_by_one"][t - 1][r], recorded["beam"][t - 1][r]
        top2 = g.topk(2).values
        gaps.append({"row": r, "position": t, "greedy_top2_logit_gap": float(top2[0] - top2[1]),
                     "max_abs_logit_diff_greedy_vs_beam1": float((g - b).abs().max())})
    return gaps


EVAL_CHECK_LOGP_TOL = 1e-3  # x max |ref| of the teacher-forced log-probabilities


class recording_decode_logits:
    """Within the block, every step of the model's plain-op decode
    (``caption.decode_pair``) keeps a CPU copy of its f32 logits: a list,
    in step order."""

    def __init__(self, model):
        self.caption = model.caption

    def __enter__(self):
        decode_pair, logits = self.caption.decode_pair, []

        def recording(*args, **kwargs):
            out = decode_pair(*args, **kwargs)
            logits.append(out.float().cpu())
            return out

        self.caption.decode_pair = recording
        return logits

    def __exit__(self, *exc):
        del self.caption.decode_pair


def device_partings(card_caps, cpu_caps, step_logits):
    """Each greedy row where the card's and the CPU's captions part: at the
    first differing position, the CPU's top-2 logit gap and the largest
    difference between the two devices' logits of that row. A gap within
    twice that difference is a near-tie that rounding may flip."""
    out = []
    for r in (card_caps != cpu_caps).any(dim=1).nonzero()[:, 0].tolist():
        t = int((card_caps[r] != cpu_caps[r]).nonzero()[0, 0])
        g, c = step_logits["cuda"][t - 1][r], step_logits["cpu"][t - 1][r]
        top2 = c.topk(2).values
        out.append({"row": r, "position": t, "cpu_top2_logit_gap": float(top2[0] - top2[1]),
                    "max_abs_logit_diff_card_vs_cpu": float((g - c).abs().max())})
    return out


def backbone_fns(model, batch) -> dict:
    """{name: a call that returns the backbone's features of ``batch``}:
    ViViT and AST of the raw multimodal family, the regular family's own
    ViViT over raw frames; nothing for a model on features."""
    from multimodal_feature_learning_tpu_torch.data.video_transforms import normalize

    frames = batch["video_tensor"]
    if hasattr(model, "video_backbone"):
        return {"vivit": lambda: model.video_backbone(normalize(frames)),
                "ast": lambda: model.audio_backbone(batch["audio_tensor"])}
    if hasattr(model.proposal, "backbone"):
        return {"vivit": lambda: model.proposal.backbone(normalize(frames))}
    return {}


def dropout_off(model):
    """Every ``Dropout`` of ``model`` at p = 0 (the regular family's query
    decoder fixes its rate at 0.1, outside the config)."""
    from multimodal_feature_learning_tpu_torch.models.layers import Dropout

    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return model


def eval_check(cfg, flat, vocab_size, batch=None, partings: bool = False,
               embedding_matrix=None):
    """Phase 15: one batch of 2 with dropout off, from conv_e79, through
    forward_eval on the card and on the port's CPU path: matched indices
    (final and auxiliary) equal; the teacher-forced log-probabilities of
    every caption layer within EVAL_CHECK_LOGP_TOL x max |ref|; the loss
    within rel 1e-4 and every term within rel 1e-3 (atol 1e-5), as
    train_check holds them; at least 90% of caption rows equal in one_by_one
    and in beam (beam 4), where f32 sums in another order can flip a
    near-tie. ``batch`` (a numpy batch of 2) replaces the synthetic one.
    With ``partings``, every greedy row where the two devices part must
    part at a near-tie: at its first differing position the CPU's two
    largest logits lie within twice the largest gap between the two
    devices' logits there (``device_partings``); and the backbones' features
    (``backbone_fns``) agree within 1e-4 of their largest. ``embedding_matrix``
    as ``build_family``'s."""
    import dataclasses

    import torch

    from multimodal_feature_learning_tpu_torch.data.anet import synthetic_batches
    from multimodal_feature_learning_tpu_torch.engine.train import batch_to_device
    from multimodal_feature_learning_tpu_torch.models.criterion import build_criterion

    cfg = without_dropout(cfg)
    if batch is None:
        batch = next(synthetic_batches(cfg, 2, vocab_size, seed=0))
    res, step_logits, features = {}, {}, {}
    for device in ("cuda", "cpu"):
        model = build_family(cfg, vocab_size, device, flat, embedding_matrix)
        criterion, weight_dict = build_criterion(cfg, model.pad_idx)
        tb = batch_to_device(batch, device)
        with recording_decode_logits(model) as step_logits[device]:
            out, caps, idx, idx_aux, mask = model.forward_eval(tb, "one_by_one")
        if partings:
            with torch.no_grad():
                features[device] = {k: fn().cpu() for k, fn in backbone_fns(model, tb).items()}
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
    extra = {}
    if partings:
        extra["partings"] = device_partings(g["caps"], c["caps"], step_logits)
        if any(p["cpu_top2_logit_gap"] > 2 * p["max_abs_logit_diff_card_vs_cpu"]
               for p in extra["partings"]):
            raise AssertionError(f"eval: the card and the CPU part away from a near-tie: "
                                 f"{extra['partings']}")
        extra["backbone_features"] = {}
        for k, ref in features["cpu"].items():
            err = (features["cuda"][k] - ref).abs().max().item()
            scale = ref.abs().max().item()
            if not err <= 1e-4 * scale:
                raise AssertionError(f"eval: {k} features differ by {err} > 1e-4 x {scale} "
                                     f"between the card and the CPU")
            extra["backbone_features"][k] = {"shape": list(ref.shape), "max_abs_err": err,
                                             "max_abs_ref": scale}
    return {**extra, "batch": 2, "indices_equal": True, "logp_max_abs_err": logp_err,
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
    the vocab's words; then, drawn on from the same generator, TRAIN_VIDEOS
    train videos made the same way. Returns the config overrides that point
    at it."""
    import numpy as np

    from multimodal_feature_learning_tpu_torch.data.anet import SPLIT_FILES
    from multimodal_feature_learning_tpu_torch.data.vocab import Vocab

    feat_dir = os.path.join(EVAL_WORLD, "features")
    os.makedirs(feat_dir, exist_ok=True)
    words = [f"w{i:04d}" for i in range(vocab_size - 4)]
    vocab = Vocab(["<unk>", "<pad>", "<bos>", "<eos>"] + words)
    vocab.save(os.path.join(EVAL_WORLD, "vocab.pkl"))
    rng = np.random.default_rng(0)
    for split, prefix, n in (("val", "v_eval", EVAL_VIDEOS), ("train", "v_train", TRAIN_VIDEOS)):
        ann = {}
        for i in range(n):
            key = f"{prefix}_{i:04d}"
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
                    rng.normal(size=(int(rng.integers(120, 901)), feature_dim))
                    .astype(np.float32))
        with open(os.path.join(EVAL_WORLD, SPLIT_FILES[split]), "w") as f:
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


def world_cfg(cfg, overrides: dict):
    """A copy of ``cfg`` pointed at the evaluation world, batch BATCH."""
    import copy

    from multimodal_feature_learning_tpu_torch.config import apply_overrides

    cfg = apply_overrides(copy.deepcopy(cfg), [f"{k}={v}" for k, v in overrides.items()])
    cfg.batch_size = BATCH
    return cfg


def eval_loop_arm(cfg, model, impl: str):
    """One arm of the evaluation loop: the world's val split through
    evaluate() with one_by_one and the ``impl`` decode on ``model``, scored.
    Every kernel's count is set to 0 just before and read just after.
    Returns (the arm's record, the submission)."""
    import random

    from multimodal_feature_learning_tpu_torch.data.anet import SPLIT_FILES, build_dataset
    from multimodal_feature_learning_tpu_torch.data.loader import DataLoader
    from multimodal_feature_learning_tpu_torch.engine.evaluate import make_eval_step
    from multimodal_feature_learning_tpu_torch.evaluation import run_eval
    from multimodal_feature_learning_tpu_torch.models.criterion import build_criterion
    from multimodal_feature_learning_tpu_torch.tools.profile_decode import decode_steps_run

    anet = cfg.dataset.activity_net
    gt_path = os.path.join(anet.anet_path, SPLIT_FILES["val"])
    counters = kernel_counters()
    criterion, weight_dict = build_criterion(cfg, model.pad_idx)
    score_fn = lambda sub: run_eval(cfg.eval, sub, gt_path, rng=random.Random(cfg.seed))  # noqa: E731
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
        stats, sub, scores = timed_evaluate(record)(
            step, loader, vocab, cfg, score_fn=score_fn, device="cuda")
        launches = {k: c.launches for k, c in counters.items()}
    finally:
        model.decode_impl = "xla"
    record["decode_steps"] = [decode_steps_run(c, model.eos_idx, model.seq_len)
                              for c in record.pop("captions")]
    return {"decode_impl": impl, **record, "launches": launches, "stats": stats,
            "scores": score_summary(scores)}, sub


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
    from multimodal_feature_learning_tpu_torch import inference
    from multimodal_feature_learning_tpu_torch.data.anet import SPLIT_FILES

    cfg = world_cfg(cfg, overrides)
    anet = cfg.dataset.activity_net
    with open(os.path.join(anet.anet_path, SPLIT_FILES["val"])) as f:
        gt = json.load(f)
    per_forward = cfg.dvc.detr.enc_layers + cfg.dvc.detr.dec_layers
    counters = kernel_counters()
    arms, subs = {}, {}
    for name, impl in (("one_by_one", "xla"), ("one_by_one_fused", "fused")):
        arms[name], subs[name] = eval_loop_arm(cfg, model, impl)

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
        if arm["launches"]["hungarian"] != arm["batches"]:
            raise AssertionError(f"eval_loop {name}: hungarian launched "
                                 f"{arm['launches']['hungarian']} times over "
                                 f"{arm['batches']} batches, one matching each")
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
    (their defaults are for manual runs), bench_fused_decode also with
    ``--dtype bfloat16``. onchip_decode_parity's fused arms
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
    out["bench_fused_decode_bf16"] = bench_fused_decode.run("cuda", iters=3, dtype="bfloat16")
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


def grads_by_tree(model) -> dict:
    """For each top-level module of ``model``: the share of its parameter
    tensors whose gradient is not all zero, and whether every gradient
    there is finite."""
    trees = {}
    for name, p in model.named_parameters():
        tree = trees.setdefault(name.split(".")[0], [0, 0, True])
        tree[0] += 1
        if p.grad is not None:
            tree[1] += bool(p.grad.abs().sum() > 0)
            tree[2] &= bool(p.grad.isfinite().all())
    return {t: {"nonzero_share": nz / n, "finite": fin} for t, (n, nz, fin) in trees.items()}


def train(cfg, flat, vocab_size, batches=None, batch_size: int = BATCH):
    """Phase 10: 1 + TRAIN_STEPS steps through train_one_epoch at full width,
    from conv_e79, with dropout. Kernel launch counts are set to 0 just
    before and read just after (K6 once a step, one matching each); then
    one more step under torch.profiler. The step logger synchronises before
    it reads the clock; with the loop's one-step lag of the metric fetch,
    the interval before step i's record covers step i + 1, so the first
    interval covers the warm-up step and the first, and the last none.
    ``batches`` (TRAIN_STEPS + 2 numpy batch dicts of ``batch_size``
    videos) replaces the synthetic feature batches (raw ingest)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from multimodal_feature_learning_tpu_torch.data.anet import synthetic_batches
    from multimodal_feature_learning_tpu_torch.engine.state import create_train_state
    from multimodal_feature_learning_tpu_torch.engine.train import (
        batch_to_device, make_train_step, train_one_epoch,
    )
    from multimodal_feature_learning_tpu_torch.models.criterion import build_criterion
    from multimodal_feature_learning_tpu_torch.ops import msda
    from multimodal_feature_learning_tpu_torch.ops.hungarian import HUNGARIAN

    model = build_family(cfg, vocab_size, "cuda", flat)
    criterion, weight_dict = build_criterion(cfg, model.pad_idx)
    state = create_train_state(cfg, model, steps_per_epoch=1000)
    step = make_train_step(criterion, weight_dict, seed=cfg.seed)
    if batches is None:
        batches = list(synthetic_batches(cfg, batch_size, vocab_size, seed=0,
                                         num_batches=TRAIN_STEPS + 2))
    records = []

    def record(values, global_step):
        torch.cuda.synchronize()
        records.append((time.perf_counter(), values))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    msda.MSDA_FWD.launches = msda.MSDA_BWD.launches = HUNGARIAN.launches = 0
    t0 = time.perf_counter()
    with recording_msda_calls(tensors=False) as calls, recording_matchings() as matchings:
        state, stats = train_one_epoch(step, state, batches[:TRAIN_STEPS + 1], epoch=0,
                                       print_freq=0, step_logger=record)
    launches = {"msda_fwd": msda.MSDA_FWD.launches, "msda_bwd": msda.MSDA_BWD.launches,
                "hungarian": HUNGARIAN.launches}
    peak = torch.cuda.max_memory_allocated()
    times = [t0] + [t for t, _ in records]
    step_ms = [1e3 * (b - a) for a, b in zip(times[:-1], times[1:])]
    losses = [v["loss"] for _, v in records]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    per_step = msda_per_forward(cfg)
    steps = len(records)
    for name in ("msda_fwd", "msda_bwd"):
        if launches[name] < per_step * steps:
            raise AssertionError(f"{name} launched {launches[name]} times over {steps} "
                                 f"training steps; the training path launches it {per_step} "
                                 f"times a step")
    if launches["hungarian"] != len(matchings) or len(matchings) != steps:
        raise AssertionError(f"hungarian launched {launches['hungarian']} times over "
                             f"{len(matchings)} matchings in {steps} training steps")
    share, n_msda, msda_missing = param_grad_report(model)
    trees = grads_by_tree(model)
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
    measured = sorted(step_ms[1:-1])
    median_ms = measured[len(measured) // 2]
    return {
        "batch": batch_size, "steps": steps, "warmup_steps": 1,
        "loss_per_step": losses,
        "grad_norm_per_step": [v["grad_norm"] for _, v in records],
        "lr": records[-1][1]["lr"],
        "step_ms": step_ms, "median_step_ms": median_ms,
        "examples_per_s": batch_size / (median_ms / 1e3),
        "launches": launches,
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "msda_calls_by_shape": calls_by_shape(calls),
        "params_with_nonzero_grad_share": share, "grads_by_tree": trees,
        "msdeformattn_params": n_msda, "msdeformattn_params_without_grad": len(msda_missing),
        "max_memory_allocated_bytes": peak,
        "profiled_step_wall_ms": prof_wall_ms,
        "profiled_step_device_kernel_ms": device_ms,
        "device_busy_share": device_ms / prof_wall_ms,
        "profiled_step_kernel_launches": sum(c for _, _, c in kernels),
        "msda_fwd_device_ms": sum(us for k, us, _ in kernels if "msda_fwd" in k) / 1e3,
        "msda_bwd_device_ms": sum(us for k, us, _ in kernels if "msda_bwd" in k) / 1e3,
        "hungarian_device_us": sum(us for k, us, _ in kernels if "hungarian" in k),
        "top_kernels": [{"name": k[:90], "ms": us / 1e3, "count": c} for k, us, c in top],
        "epoch_stats_loss": stats["loss"],
    }


# ---------------------------------------------------------------------------
# K6, the batched Hungarian matcher, and K train steps a dispatch
# ---------------------------------------------------------------------------

def matcher_problems(P, Q, G, kind: str, seed: int):
    """P problems of Q queries x G GT slots (numpy seed ``seed``): "random"
    normal costs, about 60% of the slots valid (one at least); "ties"
    integer costs 0-2 with identical query rows in a quarter of the
    problems; "invalid" a quarter of the problems without a valid slot;
    "guard" the 1e5 / -1e5 values of match_cost's NaN guard in about 7% of
    the entries."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cost = rng.normal(size=(P, Q, G)).astype(np.float32)
    valid = rng.random((P, G)) < 0.6
    valid[np.arange(P), rng.integers(0, G, P)] = True
    if kind == "ties":
        cost = rng.integers(0, 3, size=(P, Q, G)).astype(np.float32)
        cost[: P // 4] = cost[: P // 4, :1]
    elif kind == "invalid":
        valid[: P // 4] = False
    elif kind == "guard":
        u = rng.random((P, Q, G))
        cost[u < 0.05] = 1e5
        cost[u > 0.98] = -1e5
    return cost, valid


def hungarian_bound(cost, valid, search_steps):
    """(bound ms, "bytes" or "operations") of one K6 call: the bytes it must
    move (the cost and the validity read once, the int64 indices written
    once) over the memory rate, against the f32 operations this run's costs
    need (each search step about 5 a query, 2 subtractions, 2 compares and
    the update, and 10 for the argmin) over the f32 rate."""
    P, Q, G = cost.shape
    nbytes = cost.nbytes + valid.nbytes + P * G * 8
    ops = int(search_steps.sum()) * (5 * Q + 10)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def matching_problems(cfg) -> tuple:
    """(problems, queries, GT slots) of one training matching of ``cfg``'s
    family at batch BATCH: every decoder layer's segments against the GT."""
    regular = not (cfg.dvc.use_sparse_detr or cfg.dvc.use_deformable_detr)
    layers = cfg.dvc.decoder.depth if regular else cfg.dvc.detr.dec_layers
    return (layers * BATCH, cfg.dvc.num_queries, cfg.dataset.activity_net.max_gt_target_segments)


def chain_step_ns(dev) -> float:
    """Latency (ns) of one search step's dependent chain of K6's route
    "warp" on this card: the chain probe (``hungarian_chain_launch``, the
    step's shuffles, cost load, subtractions, key and warp argmin and
    nothing else) at two step counts, CUDA events, the difference over the
    difference of steps."""
    import torch

    from multimodal_feature_learning_tpu_torch.ops.hungarian import HUNGARIAN_CHAIN

    sink = torch.zeros(32, device=dev)
    few, many = 1 << 12, 1 << 16
    HUNGARIAN_CHAIN(sink, few)  # built and loaded
    ms = {n: time_cuda(lambda n=n: HUNGARIAN_CHAIN(sink, n), iters=5, warmup=1)
          for n in (few, many)}
    if not torch.isfinite(sink).all():
        raise AssertionError("the chain probe wrote non-finite values")
    return 1e6 * (ms[many] - ms[few]) / (many - few)


def profiled_launch_ms(fn, dev, match: str, n: int = 20) -> tuple:
    """Device ms of one launch of the kernels whose name holds ``match``,
    from torch.profiler over ``n`` calls of ``fn``: their time over the
    launches the profiler recorded, and that count (a short kernel's events
    may be dropped; the count shows it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize(dev)
    seen = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and match in e.key]
    count = sum(e.count for e in seen)
    return sum(e.self_device_time_total for e in seen) / 1e3 / max(count, 1), count


def wrapper_host_us(fn, calls: int = 200) -> float:
    """Median host microseconds of one call of ``fn`` (perf_counter, no
    synchronise: what a caller's thread spends to queue it)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(1e6 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return sorted(times)[calls // 2]


def matcher(family_problems: dict) -> list:
    """Phase matcher: K6 against the numpy version on every slot. Both get
    the same costs, the kernel on the card and numpy on ``cost.cpu()``: the
    flagship's training and evaluation shape (its 6 decoder layers x batch
    16 problems of 20 queries x 10 GT slots, ``family_problems["flagship"]``)
    with random costs, with ties, with problems without a valid slot and
    with the guard's 1e5 / -1e5; each other family's shape where it
    differs; a square case (10 x 10); the widest of route "warp" (31 x 31);
    and 1024 queries x 32 slots (route "global"). Each case names its plan
    (route, shared bytes). The flagship case also gives K6's device time
    from CUDA events over 50 eager calls (``ms``, host-paced where the
    kernel is shorter than a launch), from a CUDA graph of 50 calls
    (``graph_ms``) and from torch.profiler (``kernel_ms``, over the
    launches it recorded, ``kernel_events``), the wrapper's host µs a call,
    its bound, the chain floor (the longest problem's search steps x one
    step's chain latency from the chain probe), and the numpy version's host
    time (median of 5). No PyTorch call solves an LAP: no library time."""
    import dataclasses

    import numpy as np
    import torch

    from multimodal_feature_learning_tpu_torch.ops.hungarian import (
        HUNGARIAN, batched_hungarian, batched_hungarian_torch, hungarian_plan,
    )
    from multimodal_feature_learning_tpu_torch.tools.timing import graph_call_ms

    dev = torch.device("cuda")
    P, Q, G = family_problems["flagship"]
    cases = [("flagship", P, Q, G, kind) for kind in ("random", "ties", "invalid", "guard")]
    cases += [(name, *shape, "random") for name, shape in family_problems.items()
              if shape != (P, Q, G)]
    cases += [("square", P, G, G, "random"), ("widest_warp_route", P, 31, 31, "ties"),
              ("max_queries", 8, 1024, 32, "random")]
    lines, bad = [], []
    for seed, (name, p, q, g, kind) in enumerate(cases):
        cost, valid = matcher_problems(p, q, g, kind, seed)
        c, v = torch.from_numpy(cost).cuda(), torch.from_numpy(valid).cuda()
        got = batched_hungarian_torch(c, v)
        torch.cuda.synchronize()
        steps = []
        ref = batched_hungarian(c.cpu().numpy(), v.cpu().numpy(), search_steps=steps)
        differ = int((got.cpu().numpy() != ref).sum())
        line = {"case": name, "kind": kind, "problems": p, "queries": q, "gt_slots": g,
                "plan": dataclasses.asdict(hungarian_plan(q, g)),
                "slots": p * g, "slots_differing": differ,
                "search_steps": int(steps[0].sum()),
                "longest_problem_search_steps": int(steps[0].max()),
                "max_abs_err": float(np.abs(got.cpu().numpy() - ref).max())}
        if (name, kind) == ("flagship", "random"):
            call = lambda: HUNGARIAN(c, v)  # noqa: E731
            line["ms"] = time_cuda(call)
            line["graph_ms"] = graph_call_ms(call, dev)
            line["kernel_ms"], line["kernel_events"] = profiled_launch_ms(call, dev, "hungarian")
            line["wrapper_host_us"] = wrapper_host_us(lambda: batched_hungarian_torch(c, v))
            host = []
            for _ in range(5):
                t0 = time.perf_counter()
                batched_hungarian(cost, valid)
                host.append(1e3 * (time.perf_counter() - t0))
            line["plain_ms"] = sorted(host)[2]
            line["bound_ms"], line["bound_by"] = hungarian_bound(cost, valid, steps[0])
            line["chain_step_ns"] = chain_step_ns(dev)
            line["chain_floor_ms"] = (line["longest_problem_search_steps"]
                                      * line["chain_step_ns"] * 1e-6)
            line["library_ms"] = None
            line["library"] = "none: no PyTorch call solves a linear-sum assignment"
        lines.append(line)
        if differ:
            bad.append(line)
    if bad:
        raise AssertionError(f"K6 and the numpy matcher differ: {bad}")
    return lines


MULTISTEP_BATCHES = 9  # two chunks of MULTISTEP_K and a tail of 1
MULTISTEP_K = 4
MULTISTEP_LOSS_REL, MULTISTEP_LOSS_ATOL, MULTISTEP_GRAD_NORM_REL = 1e-5, 1e-6, 1e-4
MATCH_NEAR_TIE = 1e-4  # assignment cost gap under which two matchings tie


def matching_partings(records_a, records_b, max_gt: int) -> list:
    """Where two runs' matchings of each step differ: for each problem with
    a differing slot, the cost under run a's costs of run b's matching less
    that of run a's own (over the valid slots; 0 when only invalid slots
    differ), and the largest gap of the two runs' costs there."""
    import torch

    partings = []
    for step, ((cost_a, valid, idx_a), (cost_b, _, idx_b)) in enumerate(
            zip(records_a, records_b)):
        cols = torch.arange(max_gt, device=cost_a.device)
        for prob in torch.nonzero((idx_a != idx_b).any(dim=1)).flatten().tolist():
            ok = valid[prob]
            own = cost_a[prob, idx_a[prob], cols][ok].sum()
            other = cost_a[prob, idx_b[prob], cols][ok].sum()
            partings.append({
                "step": step, "problem": prob,
                "slots": int((idx_a[prob] != idx_b[prob]).sum()),
                "assignment_cost_gap": float(other - own),
                "max_cost_diff": float((cost_a[prob] - cost_b[prob]).abs().max())})
    return partings


def train_state_snapshot(state):
    """Copies, on the device, of the params and the AdamW state of
    ``state``, and its step (no host synchronisation)."""
    adamw = state.optimizer.adamw
    return {"step": state.step,
            "params": [p.detach().clone() for p in state.optimizer.params],
            "adam": [{k: v.clone() for k, v in adamw.state[p].items()}
                     if p in adamw.state else None for p in state.optimizer.params]}


def load_train_state(state, snap):
    """``state`` set to the snapshot ``train_state_snapshot`` took."""
    import torch

    adamw = state.optimizer.adamw
    with torch.no_grad():
        for p, q, adam in zip(state.optimizer.params, snap["params"], snap["adam"]):
            p.copy_(q)
            adamw.state.pop(p, None)
            if adam is not None:
                adamw.state[p] = {k: v.clone() for k, v in adam.items()}
    state.step = snap["step"]


def step_gaps(a: dict, b: dict) -> tuple:
    """(largest relative gap of the loss terms and the loss, relative gap of
    the grad norm, the terms outside MULTISTEP_LOSS_REL / _ATOL) of two
    steps' host metrics."""
    terms = [k for k in b if k.startswith("loss")]
    worst = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30) for k in terms)
    bad = [k for k in terms if abs(a[k] - b[k]) > max(MULTISTEP_LOSS_REL * abs(b[k]),
                                                      MULTISTEP_LOSS_ATOL)]
    return worst, abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"]), bad


def train_multistep(cfg, flat, vocab_size) -> dict:
    """Phase train_multistep: the flagship at full width from conv_e79,
    batch 16, dropout 0.1, MULTISTEP_BATCHES synthetic batches through
    train_one_epoch at chunk_k MULTISTEP_K (make_train_multistep: two
    chunks and a tail of 1), twice at chunk_k 1, then once more at chunk_k
    MULTISTEP_K, each from a fresh model.
    (a) Each chunk's steps run under torch.cuda.set_sync_debug_mode("error"),
    from after the chunk's one transfer to its last step's dispatch: a call
    that synchronises the host raises.
    (b) The runs launch the same kernels in the same order, and every one
    sums in a fixed order (K2 since its ordered sort, the DAM splat), so
    the two chunk_k 1 runs, and the two chunked ones, are equal bit for
    bit: every step's losses and matchings and the parameters after the
    last step. Each step of the chunked run is held against the single
    step replayed from the same state (its params and AdamW moments, copied
    on the device before the step; the replay runs after the run): every
    loss term and the loss within rel 1e-5 (atol 1e-6), the grad norm within
    rel 1e-4, the matchings equal on every slot but where the costs part a
    near-tie (the other matching within 1e-4 of the own one's cost, listed)
    and every parameter after the step within 1.01 lr. Free-running, the
    gaps of the chunked runs and of the second chunk_k 1 run to the first
    (loss of each step, slots matched differently, the largest parameter
    gap after the last step) are reported.
    (c) On the replay's model, without the snapshots: train_one_epoch over
    2 x MULTISTEP_K batches at chunk_k MULTISTEP_K and 1 in turns (ABBA),
    ms a step of each turn (up to a synchronize), the host ms to dispatch
    each chunk, the peak memory of the turns; then one chunk under
    torch.profiler (device ms, busy share, launches a step, K6's device
    us). Also the ms a step of the four checked runs (the first chunked
    one's includes its snapshots' copies) and K6 once a step in each."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from multimodal_feature_learning_tpu_torch.data.anet import synthetic_batches
    from multimodal_feature_learning_tpu_torch.engine import train as train_mod
    from multimodal_feature_learning_tpu_torch.engine.state import create_train_state
    from multimodal_feature_learning_tpu_torch.engine.train import (
        batch_to_device, make_train_multistep, make_train_step, stack_batches, train_one_epoch,
    )
    from multimodal_feature_learning_tpu_torch.models.criterion import build_criterion

    batches = list(synthetic_batches(cfg, BATCH, vocab_size, seed=0,
                                     num_batches=MULTISTEP_BATCHES))
    max_gt = cfg.dataset.activity_net.max_gt_target_segments
    counters = kernel_counters()

    def host_metrics(dispatched):
        per_step = []
        for m in dispatched:
            keys = [k for k in m if k not in ("lr", "grad_leaf_norms")]
            if isinstance(m["lr"], list):
                per_step += [{k: float(m[k][i]) for k in keys} for i in range(len(m["lr"]))]
            else:
                per_step.append({k: float(m[k]) for k in keys})
        return per_step

    def new_state():
        model = build_family(cfg, vocab_size, "cuda", flat)
        criterion, weight_dict = build_criterion(cfg, model.pad_idx)
        return create_train_state(cfg, model, steps_per_epoch=1000), criterion, weight_dict

    runs, snapshots = {}, []
    for name, chunk_k in (("chunked", MULTISTEP_K), ("single", 1), ("single_again", 1),
                          ("chunked_again", MULTISTEP_K)):
        state, criterion, weight_dict = new_state()
        step = make_train_step(criterion, weight_dict, seed=cfg.seed)
        real_factory = train_mod.make_train_step

        def snapshotting_factory(*args, **kwargs):
            inner = real_factory(*args, **kwargs)

            def snapshotting(state, batch, leaf_norms=False):
                snapshots.append(train_state_snapshot(state))
                return inner(state, batch, leaf_norms)

            return snapshotting

        if name == "chunked":
            train_mod.make_train_step = snapshotting_factory  # the chunk's inner steps
        try:
            multi = make_train_multistep(criterion, weight_dict, seed=cfg.seed)
        finally:
            train_mod.make_train_step = real_factory
        dispatched, dispatch_ms = [], []

        def single_step(state, batch, leaf_norms=False):
            if name == "chunked":  # the ragged tail
                snapshots.append(train_state_snapshot(state))
            out = step(state, batch, leaf_norms)
            dispatched.append(dict(out))
            return out

        def guarded_chunk(state, stacked, leaf_norms=False):
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = multi(state, stacked, leaf_norms)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            dispatch_ms.append(1e3 * (time.perf_counter() - t0))
            dispatched.append(dict(out))
            return out

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in counters.values():
            k.launches = 0
        t0 = time.perf_counter()
        with recording_matchings(keep=True) as matchings:
            state, _ = train_one_epoch(single_step, state, batches, epoch=0, print_freq=0,
                                       multi_step=guarded_chunk, chunk_k=chunk_k)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        runs[name] = {
            "ms_per_step": wall_ms / len(batches),
            "launches": {k: c.launches for k, c in counters.items()},
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "dispatch_host_ms": dispatch_ms, "metrics": host_metrics(dispatched),
            "matchings": matchings, "lr": state.optimizer.lr_schedule(0),
            "params": [p.detach().clone() for p in state.optimizer.params]}
        del state, multi, step
        torch.cuda.empty_cache()

    chunked, single = runs["chunked"], runs["single"]
    steps, lr = len(batches), chunked["lr"]
    bad = []
    for name, r in runs.items():
        if r["launches"]["hungarian"] != steps or len(r["matchings"]) != steps:
            bad.append(f"{name}: K6 launched {r['launches']['hungarian']} times over "
                       f"{len(r['matchings'])} matchings in {steps} steps")
    keys = ("msda_fwd", "msda_bwd", "hungarian")
    if any(chunked["launches"][k] != single["launches"][k] for k in keys):
        bad.append(f"launches differ: {chunked['launches']} vs {single['launches']}")
    # free-running, two runs at one chunk_k repeat bit for bit: every step's
    # losses and matchings, and the parameters after the last step
    repeats = {}
    for a, b in (("single", "single_again"), ("chunked", "chunked_again")):
        ra, rb = runs[a], runs[b]
        repeats[f"{a}_vs_{b}"] = rep = {
            "steps_with_other_metrics": [i for i, (x, y) in
                                         enumerate(zip(ra["metrics"], rb["metrics"])) if x != y],
            "steps_with_other_matchings": [i for i, (x, y) in
                                           enumerate(zip(ra["matchings"], rb["matchings"]))
                                           if not bitwise_equal(x[2], y[2])],
            "params_not_bitwise_equal": sum(not bitwise_equal(p, q)
                                            for p, q in zip(ra["params"], rb["params"]))}
        if len(ra["metrics"]) != steps or any(rep.values()):
            bad.append(f"{a} and {b} part: {rep}")

    # (b) each chunked step against the single step from the same state
    state, criterion, weight_dict = new_state()
    step = make_train_step(criterion, weight_dict, seed=cfg.seed)
    locked = []
    for i, snap in enumerate(snapshots):
        load_train_state(state, snap)
        with recording_matchings(keep=True) as replayed:
            m = step(state, batch_to_device(batches[i], "cuda"))
        got = {k: float(v) for k, v in m.items() if k != "lr"}
        worst, norm_gap, terms = step_gaps(chunked["metrics"][i], got)
        after = snapshots[i + 1]["params"] if i + 1 < len(snapshots) else chunked["params"]
        param_gap = max(float((p.detach() - q).abs().max()) for p, q in zip(state.optimizer.params,
                                                                    after))
        partings = matching_partings([chunked["matchings"][i]], replayed, max_gt)
        locked.append({"step": i, "loss_rel": worst, "grad_norm_rel": norm_gap,
                       "param_gap": param_gap, "matching_partings": partings})
        if terms or norm_gap > MULTISTEP_GRAD_NORM_REL or param_gap > 1.01 * lr or any(
                abs(p["assignment_cost_gap"]) > MATCH_NEAR_TIE for p in partings):
            bad.append(f"step {i} against its replay: terms {terms}, grad norm rel "
                       f"{norm_gap}, param gap {param_gap}, partings {partings}")
    del snapshots
    torch.cuda.empty_cache()

    # (c) on the replay's model, without snapshots: train_one_epoch over
    # 2 MULTISTEP_K batches at chunk_k MULTISTEP_K and at 1, in turns ABBA,
    # then one chunk under torch.profiler
    multi = make_train_multistep(criterion, weight_dict, seed=cfg.seed)
    timed_batches = batches[:2 * MULTISTEP_K]
    turns, chunk_host_ms = [], []

    def timed_chunk(state, stacked, leaf_norms=False):
        t1 = time.perf_counter()
        out = multi(state, stacked, leaf_norms)
        chunk_host_ms.append(1e3 * (time.perf_counter() - t1))
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for chunk_k in (MULTISTEP_K, 1, 1, MULTISTEP_K):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, _ = train_one_epoch(step, state, timed_batches, epoch=0, print_freq=0,
                                   multi_step=timed_chunk, chunk_k=chunk_k)
        torch.cuda.synchronize()
        turns.append({"chunk_k": chunk_k,
                      "ms_per_step": 1e3 * (time.perf_counter() - t1) / len(timed_batches)})
    peak = torch.cuda.max_memory_allocated()
    stacked = batch_to_device(stack_batches(batches[:MULTISTEP_K]), "cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        multi(state, stacked)
        host_ms = 1e3 * (time.perf_counter() - t1)
        torch.cuda.synchronize()
        prof_wall_ms = 1e3 * (time.perf_counter() - t1)
    kernels = device_kernels(prof)
    device_ms = sum(us for _, us, _ in kernels) / 1e3
    profiled = {
        "steps": MULTISTEP_K, "dispatch_host_ms": host_ms, "wall_ms": prof_wall_ms,
        "device_kernel_ms": device_ms, "device_busy_share": device_ms / prof_wall_ms,
        "kernel_launches_per_step": sum(c for _, _, c in kernels) / MULTISTEP_K,
        "hungarian_device_us_per_step":
            sum(us for k, us, _ in kernels if "hungarian" in k) / MULTISTEP_K}
    del state, multi
    torch.cuda.empty_cache()

    # free-running: the chunked runs and a second single run against the first
    free = {}
    for name in ("chunked", "chunked_again", "single_again"):
        r = runs[name]
        free[name] = {
            "loss_rel_per_step": [step_gaps(a, b)[0]
                                  for a, b in zip(r["metrics"], single["metrics"])],
            "slots_differing_per_step": [int((a[2] != b[2]).sum()) for a, b in
                                         zip(r["matchings"], single["matchings"])],
            "param_gap": max(float((p - q).abs().max())
                             for p, q in zip(r["params"], single["params"]))}
    if bad:
        raise AssertionError(f"train_multistep: {bad}")
    return {
        "batch": BATCH, "steps": steps, "chunk_k": MULTISTEP_K,
        "sync_free_chunks": len(chunked["dispatch_host_ms"]),
        "ms_per_step_in_turns": turns,
        "chunk_dispatch_host_ms_in_turns": chunk_host_ms,
        "max_memory_allocated_bytes_in_turns": peak,
        "profiled_chunk": profiled,
        "ms_per_step_checked_runs": {name: r["ms_per_step"] for name, r in runs.items()},
        "chunk_dispatch_host_ms_checked_run": chunked["dispatch_host_ms"],
        "launches": {name: r["launches"] for name, r in runs.items()},
        "loss_per_step": [m["loss"] for m in chunked["metrics"]],
        "against_replayed_single_steps": locked, "free_running_repeats": repeats,
        "free_running_against_single": free, "lr": lr}


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


def encoder_dloc_gaps(calls, enc_calls: int):
    """For each of the first ``enc_calls`` MSDA calls of the CPU step (the
    encoder's): K2 on the card and the
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
    for i in range(enc_calls):
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
            "Q": loc.shape[1], "S": v.shape[1], "taps": loc.numel(),
            "near_whole_token_taps": int(near.sum()),
            "max_abs_dloc": ref.abs().max().item(),
            "k2_vs_plain_all_taps": gap.max().item(),
            "k2_vs_plain_off_whole_tokens": gap.masked_fill(near, 0).max().item(),
            "taps_with_other_floor_card_vs_cpu": int(other_floor.sum()),
            "card_vs_cpu_step_gap_other_floor": step_gap.masked_fill(~other_floor, 0).max().item(),
            "card_vs_cpu_step_gap_same_floor": step_gap.masked_fill(other_floor, 0).max().item(),
        })
    return layers


def step_determinism(cfg, flat, vocab_size) -> dict:
    """Phase determinism, the train step: the flagship at full width from
    conv_e79, batch 16, dropout 0.1. One train step replayed twice from the
    same state (params, AdamW moments, step) on the same batch must give the
    same losses, matchings, gradients and updated parameters bit for bit.
    The same two replays with K2 swapped for the plain backward on the card
    (its scatter_add_ adds with atomics), and once more so under
    torch.use_deterministic_algorithms(True, warn_only=True), whose
    warnings name the ops that have no deterministic form: reported, not
    held (they find the sources of run-to-run variation outside K2)."""
    import warnings

    import torch

    from multimodal_feature_learning_tpu_torch.data.anet import synthetic_batches
    from multimodal_feature_learning_tpu_torch.engine.state import create_train_state
    from multimodal_feature_learning_tpu_torch.engine.train import (
        batch_to_device, make_train_step)
    from multimodal_feature_learning_tpu_torch.models.criterion import build_criterion
    from multimodal_feature_learning_tpu_torch.ops import msda
    from multimodal_feature_learning_tpu_torch.ops.ms_deform_attn import (
        ms_deform_attn_core_backward)

    model = build_family(cfg, vocab_size, "cuda", flat)
    criterion, weight_dict = build_criterion(cfg, model.pad_idx)
    state = create_train_state(cfg, model, steps_per_epoch=1000)
    step = make_train_step(criterion, weight_dict, seed=cfg.seed)
    batch = batch_to_device(next(synthetic_batches(cfg, BATCH, vocab_size, seed=0)), "cuda")
    snap = train_state_snapshot(state)
    names = [n for n, p in model.named_parameters() if p.requires_grad]

    def replay():
        load_train_state(state, snap)
        with recording_matchings(keep=True) as matchings:
            metrics = step(state, batch)
        torch.cuda.synchronize()
        return {"metrics": {k: v.clone() for k, v in metrics.items() if k != "lr"},
                "matchings": [idx for _, _, idx in matchings],
                "grads": [p.grad.detach().clone() if p.grad is not None else torch.zeros(0)
                          for p in state.optimizer.params],
                "params": [p.detach().clone() for p in state.optimizer.params]}

    def differing(a, b) -> dict:
        return {
            "metrics": [k for k in a["metrics"] if not bitwise_equal(a["metrics"][k],
                                                                     b["metrics"][k])],
            "matchings": [i for i, (x, y) in enumerate(zip(a["matchings"], b["matchings"]))
                          if not bitwise_equal(x, y)],
            "grads": [n for n, x, y in zip(names, a["grads"], b["grads"])
                      if not bitwise_equal(x, y)],
            "params": [n for n, x, y in zip(names, a["params"], b["params"])
                       if not bitwise_equal(x, y)]}

    def summary(diff: dict) -> dict:
        return {k: {"count": len(v), "first": v[:6]} for k, v in diff.items()}

    k2_diff = differing(replay(), replay())
    if any(k2_diff.values()):
        raise AssertionError(f"two replays of a train step differ: {summary(k2_diff)}")

    kernel_k2 = msda.MSDA_BWD
    msda.MSDA_BWD = ms_deform_attn_core_backward  # the wrapper's signature
    try:
        plain_diff = differing(replay(), replay())
        torch.use_deterministic_algorithms(True, warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            flagged_diff = differing(replay(), replay())
    finally:
        torch.use_deterministic_algorithms(False)
        msda.MSDA_BWD = kernel_k2
    flagged_warnings = sorted({str(w.message)[:240] for w in caught})
    del state, model, snap
    torch.cuda.empty_cache()
    return {"batch": BATCH, "replays_bitwise_equal": True,
            "plain_backward_replays_differing": summary(plain_diff),
            "plain_backward_deterministic_algorithms_differing": summary(flagged_diff),
            "deterministic_algorithms_warnings": flagged_warnings}


def train_check(cfg, flat, vocab_size, batch=None):
    """Phase 11: one step of batch 2 with dropout off (``dropout_off``), from
    conv_e79, on the card and on the port's CPU path (plain MSDA core and
    backward, CPU matmuls, the numpy matcher). Matchings equal, and K6's
    indices on the card equal the numpy matcher's on the card's own costs;
    total loss within rel 1e-4; every loss term within rel 1e-3 (atol
    1e-5); gradient norm within rel 1e-3. The card
    sums in another order than the CPU, so the sides differ
    by f32 rounding carried through a full-width forward and backward; the
    parameters whose clipped gradients differ most are reported. ``batch``
    (a numpy batch of 2) replaces the synthetic one."""
    import dataclasses

    import torch

    from multimodal_feature_learning_tpu_torch.data.anet import synthetic_batches
    from multimodal_feature_learning_tpu_torch.engine.state import create_train_state
    from multimodal_feature_learning_tpu_torch.engine.train import (
        batch_to_device, make_train_step,
    )
    from multimodal_feature_learning_tpu_torch.models.criterion import build_criterion
    from multimodal_feature_learning_tpu_torch.ops.hungarian import batched_hungarian

    cfg = without_dropout(cfg)
    if batch is None:
        batch = next(synthetic_batches(cfg, 2, vocab_size, seed=0))
    result, clipped, calls = {}, {}, {}
    for device in ("cuda", "cpu"):
        model = dropout_off(build_family(cfg, vocab_size, device, flat))
        criterion, weight_dict = build_criterion(cfg, model.pad_idx)
        tb = batch_to_device(batch, device)
        with torch.no_grad(), recording_matchings(keep=True) as matched:
            out, idx, idx_aux = model._propose_and_match(tb)
        if device == "cuda":
            (cost, valid, k6), = matched
            numpy_idx = batched_hungarian(cost.cpu().numpy(), valid.cpu().numpy())
            if not (k6.cpu().numpy() == numpy_idx).all():
                raise AssertionError("K6 and the numpy matcher differ on the card's costs")
        if device == "cuda":
            near = {k: taps_near_whole_tokens(out[f"sampling_locations_{k}"],
                                              out["temporal_shapes"]) for k in ("enc", "dec")
                    if f"sampling_locations_{k}" in out}
        state = create_train_state(cfg, model, steps_per_epoch=1000)
        with recording_msda_calls() as calls[device]:
            metrics = make_train_step(criterion, weight_dict, seed=cfg.seed)(state, tb)
        result[device] = (idx.cpu(), idx_aux.cpu(), {k: float(v) for k, v in metrics.items()
                                                     if k != "lr"})
        # the gradients after the clip, which scales both sides to norm 0.1
        clipped[device] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    enc_dloc = encoder_dloc_gaps(calls, msda_per_forward(cfg, encoder_only=True))
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
    return {"batch": 2, "indices_equal": True,
            "k6_equals_numpy_on_card_costs_slots": int(gi.numel() + ga.numel()),
            "loss_card": gm["loss"], "loss_cpu": cm["loss"],
            "loss_rel": rel["loss"], "grad_norm_card": gm["grad_norm"],
            "grad_norm_cpu": cm["grad_norm"], "grad_norm_rel": rel["grad_norm"],
            "terms": len(terms), "worst_term": max(terms, key=lambda k: rel[k]),
            "worst_term_rel": max(rel[k] for k in terms),
            "clipped_grad_gap_norm": math.sqrt(sum(g * g for g, _ in gaps)),
            "inside_taps_within_1e-4_of_a_whole_token": near,
            "encoder_dloc": enc_dloc,
            "largest_grad_gaps": [{"param": n, "gap_norm": g} for g, n in gaps[:5]]}


# ---------------------------------------------------------------------------
# parallel/ over torch.distributed
# ---------------------------------------------------------------------------

PARALLEL_STEPS = 3
PARALLEL_RANKS = 2  # processes on the one card, over gloo
PARALLEL_LAYOUTS = {"dp": (2, 1), "tp": (1, 2)}  # (data ranks, model ranks)


def parallel_run(cfg, flat, vocab_size, batches, mesh, tp: bool = False,
                 before_step=None) -> dict:
    """PARALLEL_STEPS flagship train steps from conv_e79 over ``batches``
    (this rank's rows of each, ``shard_batch``) through the parallel path
    with a ``mesh`` (``tp``: the parameters tensor-parallel and the
    decoder's value tokens split over "model"), else the plain step.
    ``before_step(state, i)`` runs ahead of step i, outside its counts and
    its clock. K1, K2 and K6 are counted over the steps alone. Returns the
    global metrics of each step, its matchings (layers, rows, slots), host
    ms of each step, the launches, the peak memory over the steps and the
    unsharded parameters after the last step."""
    import torch

    from multimodal_feature_learning_tpu_torch.engine.state import (
        create_train_state, full_state_dicts, shard_state)
    from multimodal_feature_learning_tpu_torch.engine.train import (
        batch_to_device, make_train_step, reduce_metrics)
    from multimodal_feature_learning_tpu_torch.models.criterion import build_criterion
    from multimodal_feature_learning_tpu_torch.ops import msda
    from multimodal_feature_learning_tpu_torch.ops.hungarian import HUNGARIAN
    from multimodal_feature_learning_tpu_torch.parallel.mesh import replicate_params, shard_batch

    model = replicate_params(build_family(cfg, vocab_size, "cuda", flat), mesh)
    criterion, weight_dict = build_criterion(cfg, model.pad_idx)
    state = create_train_state(cfg, model, steps_per_epoch=1000)
    if tp:
        shard_state(state, mesh, tp_axis="model")
        model.shard_tokens_axis(mesh)
    step = make_train_step(criterion, weight_dict, seed=cfg.seed, mesh=mesh)
    local = [batch_to_device(shard_batch(b, mesh), "cuda") for b in batches]
    counters = (msda.MSDA_FWD, msda.MSDA_BWD, HUNGARIAN)
    launches = dict.fromkeys(("msda_fwd", "msda_bwd", "hungarian"), 0)
    metrics, step_ms, matchings, peak = [], [], [], 0
    for i, b in enumerate(local):
        if before_step is not None:
            before_step(state, i)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        with recording_matchings(keep=True) as matched:
            m = reduce_metrics(step(state, b), mesh)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        for name, c in zip(launches, counters):
            launches[name] += c.launches
        peak = max(peak, torch.cuda.max_memory_allocated())
        metrics.append({k: v.detach().clone() for k, v in m.items() if k != "lr"})
        (_, _, idx), = matched
        matchings.append(idx.reshape(-1, b["gt_mask"].shape[0], idx.shape[-1]))
    out = {"metrics": metrics, "step_ms": step_ms, "launches": launches, "peak_bytes": peak,
           "matchings": matchings,
           "params": {k: v.detach().clone() for k, v in full_state_dicts(state)[0].items()}}
    del state, model, step
    torch.cuda.empty_cache()
    return out


def parallel_flagship():
    """(cfg, flat conv_e79 params, vocab size) of the flagship as
    ``build_flagship`` builds it, and the phase's PARALLEL_STEPS synthetic
    batches of BATCH (numpy seed 0)."""
    from multimodal_feature_learning_tpu_torch.config import load_config, recompute_losses
    from multimodal_feature_learning_tpu_torch.data.anet import synthetic_batches
    from multimodal_feature_learning_tpu_torch.utils.weights import load_npz

    cfg = load_config()
    cfg.use_differentiable_mask = False
    recompute_losses(cfg)
    flat = load_npz(SNAPSHOT)
    vocab_size = int(flat["BF16||caption||params||head||bias"].shape[0])
    batches = [{k: v for k, v in b.items() if not isinstance(v, list)} for b in
               synthetic_batches(cfg, BATCH, vocab_size, seed=0, num_batches=PARALLEL_STEPS)]
    return cfg, flat, vocab_size, batches


def parallel_rank(workdir: str) -> int:
    """``chip_smoke.py --parallel-rank <workdir>``: one of PARALLEL_RANKS
    processes (RANK / WORLD_SIZE / LOCAL_RANK / LOCAL_WORLD_SIZE /
    MASTER_ADDR / MASTER_PORT from the environment) on the one card. Joins
    the group (gloo: the ranks share the device) and runs ``parallel_run``
    in each of PARALLEL_LAYOUTS. Ahead of each step rank 0 replays it in
    one process over the whole batch from the same state (the unsharded
    parameters and AdamW moments, loaded into a plain model): the step each
    parallel step is held to. Writes its results to
    ``<workdir>/rank<r>.pt``."""
    import copy

    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from multimodal_feature_learning_tpu_torch.engine.state import (
        create_train_state, full_state_dicts)
    from multimodal_feature_learning_tpu_torch.engine.train import (
        batch_to_device, make_train_step)
    from multimodal_feature_learning_tpu_torch.models.criterion import build_criterion
    from multimodal_feature_learning_tpu_torch.parallel.mesh import (
        make_mesh, maybe_initialize_distributed)

    maybe_initialize_distributed("cuda")
    rank = dist.get_rank()
    cfg, flat, vocab_size, batches = parallel_flagship()
    res = {"backend": dist.get_backend(), "device": torch.cuda.current_device()}
    ref_state = ref_step = None
    if rank == 0:
        ref_model = build_family(cfg, vocab_size, "cuda", flat)
        ref_state = create_train_state(cfg, ref_model, steps_per_epoch=1000)
        ref_step = make_train_step(*build_criterion(cfg, ref_model.pad_idx), seed=cfg.seed)
        whole = [batch_to_device(b, "cuda") for b in batches]
    for layout, (n_data, n_model) in PARALLEL_LAYOUTS.items():
        replays = []

        def replay(state, i):
            model_sd, opt_sd = full_state_dicts(state)  # a collective under TP
            if rank != 0:
                return
            ref_state.model.load_state_dict(model_sd)
            # a copy: load_state_dict keeps tensors already on their device,
            # and the replay's update must not reach the parallel run's moments
            ref_state.optimizer.load_state_dict(copy.deepcopy(opt_sd))
            ref_state.step = state.step
            with recording_matchings(keep=True) as matched:
                m = ref_step(ref_state, whole[i])
            (_, _, idx), = matched
            replays.append({"metrics": {k: float(v) for k, v in m.items() if k != "lr"},
                            "matchings": idx.reshape(-1, BATCH, idx.shape[-1]).cpu()})

        run = parallel_run(cfg, flat, vocab_size, batches, make_mesh(n_data, n_model),
                           tp=n_model > 1, before_step=replay)
        res[layout] = {
            "metrics": [{k: float(v) for k, v in m.items()} for m in run["metrics"]],
            "matchings": [m.cpu() for m in run["matchings"]],
            "params": ({k: v.cpu() for k, v in run["params"].items()} if rank == 0
                       else None),
            "replays": replays,
            **{k: run[k] for k in ("step_ms", "launches", "peak_bytes")}}
    torch.save(res, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def parallel_gaps(runs: list, n_data: int) -> dict:
    """Each parallel step of ``runs`` (the ranks' results of one layout)
    against rank 0's replay of it in one process from the same state, to
    train_check's tolerances: matchings equal (the data ranks' rows joined
    in rank order), loss within rel 1e-4, every loss term 1e-3 (atol 1e-5),
    grad norm 1e-3. The ranks' global metrics must agree bit for bit, and
    the ranks of one data index their matchings."""
    import torch

    for run in runs[1:]:
        if run["metrics"] != runs[0]["metrics"]:
            raise AssertionError("the ranks' global metrics differ")
    per = PARALLEL_RANKS // n_data
    out = {"loss_rel": [], "grad_norm_rel": [], "worst_term_rel": []}
    for i, ref in enumerate(runs[0]["replays"]):
        a, b = ref["metrics"], runs[0]["metrics"][i]
        rel = {k: abs(b[k] - a[k]) / max(abs(a[k]), 1e-12) for k in a}
        bad = [k for k in a if k.startswith("loss_")
               and abs(b[k] - a[k]) > max(1e-3 * abs(a[k]), 1e-5)]
        if rel["loss"] > 1e-4 or rel["grad_norm"] > 1e-3 or bad:
            raise AssertionError(f"step {i}: loss rel {rel['loss']}, grad_norm rel "
                                 f"{rel['grad_norm']}, terms {bad}")
        for r in range(0, PARALLEL_RANKS, per):
            if not all(torch.equal(runs[r]["matchings"][i], runs[q]["matchings"][i])
                       for q in range(r, r + per)):
                raise AssertionError(f"step {i}: ranks of one data index match apart")
        joined = torch.cat([runs[r]["matchings"][i] for r in range(0, PARALLEL_RANKS, per)],
                           dim=1)
        if not torch.equal(joined, ref["matchings"]):
            raise AssertionError(f"step {i}: matchings differ from the one-process step")
        out["loss_rel"].append(rel["loss"])
        out["grad_norm_rel"].append(rel["grad_norm"])
        out["worst_term_rel"].append(max(rel[k] for k in a if k.startswith("loss_")))
    return out


def parallel() -> dict:
    """Phase parallel (see the module docstring): (a) NCCL world 1 in this
    process, bit for bit against the plain step; (b) DP 2 and (c) TP 2 in
    two processes on the card over gloo, each step against the one-process
    step at 16 rows from the same state."""
    import tempfile

    import torch
    import torch.distributed as dist

    from multimodal_feature_learning_tpu_torch.parallel.mesh import (
        make_mesh, maybe_initialize_distributed)

    cfg, flat, vocab_size, batches = parallel_flagship()
    per_step = {"msda_fwd": msda_per_forward(cfg), "msda_bwd": msda_per_forward(cfg),
                "hungarian": 1}
    plain = parallel_run(cfg, flat, vocab_size, batches, None)

    def check_launches(what: str, launches: dict):
        want = {k: n * PARALLEL_STEPS for k, n in per_step.items()}
        if launches != want:
            raise AssertionError(f"{what}: launches {launches}, expected {want}")

    check_launches("plain", plain["launches"])
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        maybe_initialize_distributed("cuda")
        backend = dist.get_backend()
        world1 = parallel_run(cfg, flat, vocab_size, batches, make_mesh(1, 1))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if backend != "nccl":
        raise AssertionError(f"world 1 on the card took {backend}, not nccl")
    check_launches("nccl world 1", world1["launches"])
    differing = {
        "metrics": [f"{i}:{k}" for i, (a, b) in enumerate(zip(plain["metrics"],
                                                               world1["metrics"]))
                    for k in a if not bitwise_equal(a[k], b[k])],
        "matchings": [i for i, (a, b) in enumerate(zip(plain["matchings"],
                                                        world1["matchings"]))
                      if not bitwise_equal(a, b)],
        "params": [k for k in plain["params"]
                   if not bitwise_equal(plain["params"][k], world1["params"][k])]}
    if any(differing.values()):
        raise AssertionError(f"the NCCL world-1 steps differ from the plain steps: "
                             f"{ {k: v[:6] for k, v in differing.items()} }")
    world1_ms, world1_launches = world1["step_ms"], world1["launches"]
    del world1
    torch.cuda.empty_cache()

    workdir = tempfile.mkdtemp(prefix="parallel_", dir=os.path.join(ROOT, "build"))
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-u", os.path.abspath(__file__), "--parallel-rank", workdir],
        env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(PARALLEL_RANKS), LOCAL_RANK=str(r),
                 LOCAL_WORLD_SIZE=str(PARALLEL_RANKS), MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(PARALLEL_RANKS)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log_text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"parallel rank {r} exited {p.returncode}:\n"
                                 f"{log_text[-4000:]}")
    ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
             for r in range(PARALLEL_RANKS)]
    out = {"steps": PARALLEL_STEPS, "batch": BATCH,
           "plain": {"step_ms": plain["step_ms"], "peak_bytes": plain["peak_bytes"],
                     "launches": plain["launches"],
                     "loss_per_step": [float(m["loss"]) for m in plain["metrics"]]},
           "nccl_world1": {"backend": backend, "bitwise_equal": True,
                           "step_ms": world1_ms, "launches": world1_launches},
           "backends": [r["backend"] for r in ranks]}
    if any(b != "gloo" for b in out["backends"]):
        raise AssertionError(f"two ranks on one card took {out['backends']}, not gloo")
    for layout, (n_data, n_model) in PARALLEL_LAYOUTS.items():
        runs = [r[layout] for r in ranks]
        for r, run in enumerate(runs):
            check_launches(f"{layout} rank {r}", run["launches"])
        free = [abs(m["loss"] - float(p["loss"])) / abs(float(p["loss"]))
                for m, p in zip(runs[0]["metrics"], plain["metrics"])]
        out[layout] = {
            "data_ranks": n_data, "model_ranks": n_model, "rows_a_rank": BATCH // n_data,
            **parallel_gaps(runs, n_data),
            # beside the plain run of this process, steps compounding: reported
            "free_running_loss_rel": free,
            "free_running_max_param_gap": max(
                float((plain["params"][k].cpu() - v).abs().max())
                for k, v in runs[0]["params"].items()),
            "step_ms": [run["step_ms"] for run in runs],
            "peak_bytes": [run["peak_bytes"] for run in runs],
            "launches_per_step_and_rank": [{k: n / PARALLEL_STEPS
                                            for k, n in run["launches"].items()}
                                           for run in runs]}
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# bf16: the JAX package's mixed-precision policy (compute_dtype "bfloat16")
# ---------------------------------------------------------------------------

BF16_ARMS = (  # (name, decode_impl, decode_kv, decode_fused_grid)
    ("plain", "xla", "dense", "video"),
    ("fused_video", "fused", "dense", "video"),
    ("fused_batch", "fused", "dense", "batch"),
    ("fused_int8", "fused", "int8", "video"),
)


SEGMENT_MATCH = 0.01  # x duration: two events are the same proposal


def against(requests, results, reference) -> dict:
    """How far ``results`` stay from ``reference`` (events per request):
    the share of requests with k equal; the events of ``results`` paired
    with an event of ``reference`` whose segment lies within SEGMENT_MATCH
    x duration at both ends (the stability ranking may order near-equal
    proposals apart, so rows are paired by segment, not by position); of
    the pairs, the share with the same caption and the share of tokens
    equal; and the share of rows equal position by position. Reported, not
    held: bf16 against f32 is another numerics, not a rounding of the same
    one."""
    import numpy as np

    k_equal = rows = paired = pairs_equal = tokens = tokens_equal = by_position = 0
    for (_, dur), got, ref in zip(requests, results, reference):
        k_equal += len(got) == len(ref)
        free = list(range(len(ref)))
        for j, a in enumerate(got):
            rows += 1
            by_position += j < len(ref) and a["caption"] == ref[j]["caption"]
            gaps = [float(np.max(np.abs(np.subtract(a["segment"], ref[i]["segment"])))) / dur
                    for i in free]
            if not gaps or min(gaps) > SEGMENT_MATCH:
                continue
            b = ref[free.pop(int(np.argmin(gaps)))]
            paired += 1
            pairs_equal += a["caption"] == b["caption"]
            tokens += len(a["caption"])
            tokens_equal += sum(x == y for x, y in zip(a["caption"], b["caption"]))
    return {"k_equal_share": k_equal / len(requests), "rows": rows,
            "rows_paired_by_segment": paired,
            "paired_rows_equal_share": pairs_equal / max(paired, 1),
            "paired_token_agreement": tokens_equal / max(tokens, 1),
            "rows_equal_by_position_share": by_position / rows}


def serve_bf16(cfg, model, requests, f32_results: dict):
    """Phase serve_bf16: the N_REQUESTS requests through DVCServer on the
    bf16 model (``compute_dtype="bfloat16"``, conv_e79), once per arm of
    BF16_ARMS (``serve_arms``: K1 twelve times a dispatch, the arm's fused
    kernel at least once a decode step and no other grid's, videos/s,
    latency, peak memory). K1's calls are recorded: both the encoder's and
    the decoder's take the kernel's bf16-value route, with the schedule
    their plans chose. Each arm's agreement with the f32 answers of the
    same arm (``against``; int8 against the f32 plain-op answers)."""
    from multimodal_feature_learning_tpu_torch.ops import msda

    plan_fn, plans = msda.msda_fwd_plan, {}

    def recording_plan(shapes, B, H, Dh, Q, P, itemsize, *a, **kw):
        plan = plan_fn(shapes, B, H, Dh, Q, P, itemsize, *a, **kw)
        plans.setdefault((Q, itemsize), plan.schedule)
        return plan

    msda.msda_fwd_plan = recording_plan
    try:
        out, served = serve_arms(cfg, model, requests, BF16_ARMS, "serve_bf16")
    finally:
        msda.msda_fwd_plan = plan_fn
    for name, arm in out.items():
        arm["against_f32"] = against(requests, served[name],
                                     f32_results.get(name, f32_results["plain"]))
    q_enc = min(int(model.num_tokens * cfg.dvc.detr.rho) + 1, model.num_tokens)
    if {i for _, i in plans} != {2} or {q for q, _ in plans} != {q_enc, model.num_queries}:
        raise AssertionError(f"serve_bf16: K1 ran with plans {plans}; the encoder (Q={q_enc}) "
                             f"and the decoder (Q={model.num_queries}) should both hand it "
                             f"bf16 value")
    out["msda_fwd_plans"] = [{"Q": q, "value_itemsize": i, "schedule": v}
                             for (q, i), v in sorted(plans.items())]
    return out, served


def serve_arms(cfg, model, requests, arms, what: str):
    """The requests through DVCServer once per arm of ``arms`` (name,
    decode_impl, decode_kv, decode_fused_grid), launches counted over each:
    K1 twelve times a dispatch, a fused arm's kernel at least once a decode
    step and the other grid's never, the plain-op arm's neither; every event
    well formed; videos/s, latency and peak memory. Returns ({arm: stats},
    {arm: results})."""
    per_forward = cfg.dvc.detr.enc_layers + cfg.dvc.detr.dec_layers
    out, served = {}, {}
    import torch

    for name, impl, kv, grid in arms:
        model.decode_impl, model.decode_kv, model.decode_fused_grid = impl, kv, grid
        torch.cuda.reset_peak_memory_stats()
        try:
            results, latencies, wall, launches, stats, steps = serve(model, requests)
        finally:
            model.decode_impl, model.decode_kv, model.decode_fused_grid = "xla", "dense", "video"
        peak = torch.cuda.max_memory_allocated()
        check_results(cfg, model, requests, results, compare_cpu=False)
        dispatches = stats["dispatches"]
        if len(results) != len(requests) or launches["msda_fwd"] != per_forward * dispatches:
            raise AssertionError(f"{what} {name}: {len(results)} answers, msda_fwd launched "
                                 f"{launches['msda_fwd']} times over {dispatches} dispatches")
        fused = {g: launches[f"fused_decode_{g}"] for g in ("video", "batch")}
        if impl == "fused":
            if fused[grid] < sum(steps) or any(n for g, n in fused.items() if g != grid):
                raise AssertionError(f"{what} {name}: {launches} over {steps} decode steps")
        elif any(fused.values()):
            raise AssertionError(f"{what} {name}: the plain-op decode launched {launches}")
        lat = sorted(latencies)
        served[name] = results
        out[name] = {
            "decode": [impl, kv, grid], "answered": len(results), "dispatches": dispatches,
            "videos_per_s": len(requests) / wall, "p50_latency_s": lat[len(lat) // 2],
            "max_latency_s": lat[-1], "step_s": stats["step_s"],
            "max_memory_allocated_bytes": peak, "launches": launches,
            "decode_steps_per_dispatch": steps}
    return out, served


# the long-video flagship: conv_e79 at a rescale length of 1200 (pyramid
# (1200, 600, 300, 150): S 2250, Sp 2304, 18 chunks of the fused kernel's
# cross-attention), f32 and bf16, the plain-op decode and the fused one in
# both grids with dense and int8 memory K/V
LONG_RESCALE_LEN = 1200
LONG_ARMS = (  # (name, decode_impl, decode_kv, decode_fused_grid)
    ("plain", "xla", "dense", "video"),
    ("fused_video", "fused", "dense", "video"),
    ("fused_batch", "fused", "dense", "batch"),
    ("fused_video_int8", "fused", "int8", "video"),
    ("fused_batch_int8", "fused", "int8", "batch"),
)


def serve_long(requests):
    """Phase serve_long: the N_REQUESTS requests (resized to 1200 tokens)
    through DVCServer on the long-video flagship, f32 and bf16, once per arm
    of LONG_ARMS (``serve_arms``), each fused arm held against the plain-op
    arm of the same model by ``compare_results``, as ``check_fused`` holds
    the flagship: k equal, segments within 1e-3 x duration, and at least 90%
    of caption rows equal in f32, of caption tokens in bf16."""
    import torch

    out = {}
    for dname in ("float32", "bfloat16"):
        cfg, model, source, _ = build_flagship("cuda", dname, LONG_RESCALE_LEN)
        arms, served = serve_arms(cfg, model, requests, LONG_ARMS, f"serve_long {dname}")
        for name, *_ in LONG_ARMS[1:]:
            arms[name]["against_plain"] = compare_results(
                requests, served[name], served["plain"],
                f"serve_long {dname} {name} against the plain-op decode",
                min_token_agreement=0.9 if dname == "bfloat16" else 0.0)
        out[dname] = {"weights": source, "num_tokens": model.num_tokens,
                      "Sp": -(-model.num_tokens // 128) * 128, "arms": arms}
        del model
        torch.cuda.empty_cache()
    return out


# the tests' narrow model (__graft_entry__._small_cfg's dims: d_model 64, 2
# heads, 2 + 2 transformer layers, 3 levels of 24 tokens, caption depth 2,
# 4 events, 8 caption tokens), weights from seed 0, the context mask on (the
# fused step's bias column)
NARROW_OVERRIDES = [
    "dvc.d_model=64", "dvc.num_queries=6", "dvc.detr.feature_dim=64", "dvc.detr.d_model=64",
    "dvc.detr.num_heads=2", "dvc.detr.enc_layers=2", "dvc.detr.dec_layers=2",
    "dvc.detr.transformer_ff_dim=128", "dvc.detr.video_rescale_len=24",
    "dvc.detr.num_feature_levels=3", "dvc.caption.d_model=64", "dvc.caption.depth=2",
    "dvc.caption.num_heads=2", "dataset.activity_net.video_rescale_len=24",
    "dataset.activity_net.max_caption_len_all=8",
    "dataset.activity_net.max_gt_target_segments=4",
]
NARROW_ARMS = LONG_ARMS


def serve_narrow(vocab_size: int):
    """Phase serve_narrow: the narrow model (NARROW_OVERRIDES) on the card,
    N_REQUESTS requests of its feature width through DVCServer once per arm
    of NARROW_ARMS, each fused arm held against the plain-op arm
    (``compare_results``); then ``check_fused``: one batch with the fused
    decode (both grids) against the plain-op decode on the card, and the
    fused decode on the card against the port's CPU path on N_CHECK
    videos."""
    from multimodal_feature_learning_tpu_torch.config import (
        apply_overrides, load_config, recompute_losses,
    )

    cfg = apply_overrides(load_config(), NARROW_OVERRIDES)
    recompute_losses(cfg)
    model = build_family(cfg, vocab_size, "cuda")
    requests = make_requests(cfg)
    arms, served = serve_arms(cfg, model, requests, NARROW_ARMS, "serve_narrow")
    for name, *_ in NARROW_ARMS[1:]:
        arms[name]["against_plain"] = compare_results(
            requests, served[name], served["plain"],
            f"serve_narrow {name} against the plain-op decode")
    checked = check_fused(cfg, model, requests)
    return {"d_model": cfg.dvc.caption.d_model, "heads": cfg.dvc.caption.num_heads,
            "caption_depth": cfg.dvc.caption.depth, "num_tokens": model.num_tokens,
            "context_mask": cfg.use_differentiable_mask,
            "params": sum(p.numel() for p in model.parameters()), "arms": arms,
            "check_fused": checked}


def eval_bf16(cfg, model, batch, f32_arms: dict, world: dict):
    """Phase eval_bf16: make_eval_step in every val_mode on the bf16 model
    (``evaluate_arms``, with its checks: finite losses, K1 once per MSDA
    call, the fused kernel once per decode step, beam 1 equal to greedy),
    each arm's loss beside the f32 model's on the same batch; then one arm
    of the evaluation loop from files to scores (one_by_one, plain-op
    decode) on the bf16 model, its launches checked as eval_loop's."""
    import math as _math

    arms = evaluate_arms(cfg, model, batch)
    for name, arm in arms["arms"].items():
        ref = f32_arms["arms"][name]["loss"]
        arm["f32_loss"] = ref
        arm["loss_rel_gap_to_f32"] = abs(arm["loss"] - ref) / abs(ref)
    loop_cfg = world_cfg(cfg, world)
    arm, sub = eval_loop_arm(loop_cfg, model, "xla")
    per_forward = cfg.dvc.detr.enc_layers + cfg.dvc.detr.dec_layers
    if arm["launches"]["msda_fwd"] != per_forward * arm["batches"] or not all(
            _math.isfinite(v) for v in arm["scores"].values()) or \
            len(sub["results"]) != EVAL_VIDEOS:
        raise AssertionError(f"eval_bf16 loop: launches {arm['launches']} over "
                             f"{arm['batches']} batches, scores {arm['scores']}, "
                             f"{len(sub['results'])} videos")
    return {**arms, "eval_loop_one_by_one": arm}


def train_bf16(cfg, flat, vocab_size, f32_run: dict):
    """Phase train_bf16: the train phase (1 + TRAIN_STEPS steps from
    conv_e79, batch BATCH, dropout, synthetic batches from seed 0) with
    ``compute_dtype="bfloat16"``, once with f32 masters and once with the
    master fold (``master_dtype="bfloat16"``): K2 launched 12 times a step,
    exactly; each run's median step ms, peak memory and its losses beside
    the f32 run's (the same batches and dropout masks)."""
    import copy

    per_step = cfg.dvc.detr.enc_layers + cfg.dvc.detr.dec_layers
    out = {}
    for masters in ("float32", "bfloat16"):
        c = copy.deepcopy(cfg)
        c.compute_dtype, c.master_dtype = "bfloat16", masters
        run = train(c, flat, vocab_size)
        if run["launches"]["msda_bwd"] != per_step * run["steps"]:
            raise AssertionError(f"train_bf16 ({masters} masters): msda_bwd launched "
                                 f"{run['launches']['msda_bwd']} times over {run['steps']} "
                                 f"steps, {per_step} a step")
        gaps = [abs(a - b) / abs(b) for a, b in zip(run["loss_per_step"],
                                                      f32_run["loss_per_step"])]
        out[f"{masters}_masters"] = {
            **{k: run[k] for k in ("steps", "loss_per_step", "grad_norm_per_step", "step_ms",
                                   "median_step_ms", "examples_per_s", "launches",
                                   "max_memory_allocated_bytes", "device_busy_share",
                                   "profiled_step_device_kernel_ms", "msda_fwd_device_ms",
                                   "msda_bwd_device_ms", "top_kernels")},
            "f32_loss_per_step": f32_run["loss_per_step"], "loss_rel_gap_to_f32": gaps,
            "f32_median_step_ms": f32_run["median_step_ms"],
            "f32_max_memory_allocated_bytes": f32_run["max_memory_allocated_bytes"]}
    return out


# ---------------------------------------------------------------------------
# the dense deformable family and the video + audio family (BASELINE #2, #3)
# ---------------------------------------------------------------------------

MM_EVAL_ARMS = (  # the multimodal family has no fused decode and no "serve" mode
    ("one_by_one", "one_by_one", {}, "xla"),
    ("teacher_forcing", "teacher_forcing", {}, "xla"),
    ("beam4", "beam", {"beam_size": 4}, "xla"),
    ("one_by_one_faster", "one_by_one", {"faster_eval": True}, "xla"),
)
DENSE_SERVE_ARMS = (("stability", "xla"), ("class", "xla"), ("stability", "fused"),
                    ("class", "fused"))
FAMILY_OVERRIDES = {
    "dense": ["dvc.use_sparse_detr=false", "dvc.use_deformable_detr=true"],
    "mm": ["dvc.input_modalities=video,audio", "dvc.use_bimodal_encoder=true"],
}


def family_config(family: str, use_differentiable_mask: bool = False):
    """The full-width config of BASELINE config #2 ("dense": the dense
    deformable family, tools/run_family_dense.sh) or #3 ("mm": video +
    audio with the BiModalEncoder, tools/run_family_convergence.sh), f32,
    both trained by the JAX package with the context mask off."""
    from multimodal_feature_learning_tpu_torch.config import (
        apply_overrides, load_config, recompute_losses,
    )

    cfg = apply_overrides(load_config(), FAMILY_OVERRIDES[family])
    cfg.use_differentiable_mask = use_differentiable_mask
    recompute_losses(cfg)
    return cfg


def family_model(cfg, vocab_size: int):
    """(model on the card with weights drawn from cfg.seed, those weights as
    flat flax params for the card-against-CPU checks)."""
    from multimodal_feature_learning_tpu_torch.utils.weights import export_flax_params

    model = build_family(cfg, vocab_size, "cuda")
    return model, export_flax_params(model)


def dense_serve(cfg, model, requests):
    """Phase dense_serve: the 48 requests through DVCServer on the dense
    family in each arm of DENSE_SERVE_ARMS (rank "stability" or "class",
    plain-op or fused "video" decode). Every kernel's launches counted over
    exactly the arm: K1 12 times a dispatch, the fused kernel once per
    decode step. The events are well formed; in each rank the fused arm
    answers as the plain-op one (``compare_results``)."""
    arms, results = {}, {}
    per_forward = msda_per_forward(cfg)
    for rank, impl in DENSE_SERVE_ARMS:
        model.decode_impl = impl
        try:
            with recording_msda_calls(tensors=False) as calls:
                res, latencies, wall, launches, stats, steps = serve(model, requests, rank)
        finally:
            model.decode_impl = "xla"
        check_results(cfg, model, requests, res, compare_cpu=False)
        dispatches = stats["dispatches"]
        if launches["msda_fwd"] != per_forward * dispatches or len(res) != N_REQUESTS:
            raise AssertionError(f"dense_serve {rank} {impl}: msda_fwd launched "
                                 f"{launches['msda_fwd']} times over {dispatches} dispatches")
        if impl == "fused" and launches["fused_decode_video"] < sum(steps):
            raise AssertionError(f"dense_serve {rank}: fused_decode_video launched "
                                 f"{launches['fused_decode_video']} times over {steps} steps")
        lat = sorted(latencies)
        results[(rank, impl)] = res
        arms[f"{rank}_{impl}"] = {
            "answered": len(res), "dispatches": dispatches, "videos_per_s": N_REQUESTS / wall,
            "p50_latency_s": lat[len(lat) // 2], "max_latency_s": lat[-1],
            "step_s": stats["step_s"], "launches": launches, "decode_steps": steps,
            "msda_calls_by_shape": calls_by_shape(calls)}
    agreement = {rank: compare_results(requests, results[(rank, "fused")],
                                       results[(rank, "xla")],
                                       f"dense_serve {rank}: fused against plain-op")
                 for rank in ("stability", "class")}
    differs = any([e["segment"] for e in a] != [e["segment"] for e in b]
                  for a, b in zip(results[("class", "xla")], results[("stability", "xla")]))
    return {"arms": arms, "fused_vs_plain": agreement,
            "class_rank_differs_from_stability": differs}, results


def family_cli(world: dict, family: str, device="cuda", family_overrides=None, cfg=None,
               train_videos: int = TRAIN_VIDEOS, val_videos: int = TRAIN_CLI_VAL_SUBSET,
               batch: int = BATCH):
    """Phases dense_cli, mm_cli and raw_cli: the training CLI (main.main) over the
    evaluation world's train split with the family's overrides, weights from
    cfg.seed, dropout on: one epoch with eval on the first
    TRAIN_CLI_VAL_SUBSET val videos and scoring, then ``--mode eval
    --resume`` of its checkpoint. The multimodal family reads the world's
    video features as audio too (no audio file), as the JAX package does.
    The epoch's loader waits, steps and eval batches are timed
    (TimedLoader around the CLI's train and val loaders). Checks: the epoch
    logged with finite losses and scores; K2 launched once per MSDA call of
    each train step, K1 once per call of each train step and eval batch, K6
    once a train step and an eval batch;
    the eval run starts at epoch 1 and gives the epoch's val loss (rel
    1e-4). ``family_overrides``, ``cfg`` (the
    family's config, for its MSDA calls), ``train_videos``, ``val_videos``
    and ``batch`` name another family and world (raw_cli)."""
    import shutil

    from multimodal_feature_learning_tpu_torch import main as train_main

    out = os.path.join(EVAL_WORLD, f"{family}_cli")
    if os.path.isdir(out):
        shutil.rmtree(out)
    family_overrides = family_overrides or FAMILY_OVERRIDES[family]
    overrides = [*family_overrides, "use_differentiable_mask=false", "eval_rate=1",
                 "checkpoint_rate=1", f"dataset.activity_net.val_subset={val_videos}",
                 "print_freq=0", *[f"{k}={v}" for k, v in world.items()]]
    common = ["--device", device, "--batch-size", str(batch), "--output-dir", out,
              "--config-overrides", *overrides]
    counters = kernel_counters()
    launches, waits = [], {}
    real_epoch, real_evaluate = train_main.train_one_epoch, train_main.evaluate

    def timed_epoch(train_step, state, loader, *args, **kwargs):
        timed = TimedLoader(loader)
        result = real_epoch(train_step, state, timed, *args, **kwargs)
        waits["train"] = {"loader_wait_ms": [1e3 * w for w in timed.wait],
                          "step_ms": [1e3 * b for b in timed.busy]}
        return result

    def timed_evaluate(eval_step, loader, *args, **kwargs):
        timed = TimedLoader(loader)
        result = real_evaluate(eval_step, timed, *args, **kwargs)
        waits["eval"] = {"loader_wait_ms": [1e3 * w for w in timed.wait],
                         "batch_ms": [1e3 * b for b in timed.busy]}
        return result

    for k in counters.values():
        k.launches = 0
    train_main.train_one_epoch, train_main.evaluate = timed_epoch, timed_evaluate
    try:
        run = train_main.main(["--epochs", "1", *common])
    finally:
        train_main.train_one_epoch, train_main.evaluate = real_epoch, real_evaluate
    launches.append({k: c.launches for k, c in counters.items()})
    for k in counters.values():
        k.launches = 0
    evaluated = train_main.main(["--mode", "eval", "--resume",
                                 os.path.join(out, "checkpoint"), *common])
    launches.append({k: c.launches for k, c in counters.items()})
    rec = run["epochs"][0]
    if rec["epoch"] != 0 or not all(math.isfinite(rec[k]) for k in ("train_loss", "val_loss",
                                                                    "score_METEOR")):
        raise AssertionError(f"{family}_cli: epoch record {rec}")
    per_forward = msda_per_forward(cfg or family_config(family))
    steps, eval_batches = -(-train_videos // batch), -(-val_videos // batch)
    want = [{"msda_bwd": per_forward * steps,
             "msda_fwd": per_forward * (steps + eval_batches), "hungarian": steps + eval_batches},
            {"msda_bwd": 0, "msda_fwd": per_forward * eval_batches, "hungarian": eval_batches}]
    for got, w in zip(launches, want):
        if any(got[k] != v for k, v in w.items()):
            raise AssertionError(f"{family}_cli: launches {launches}, expected {want}")
    val_rel = abs(evaluated["val_stats"]["loss"] - rec["val_loss"]) / abs(rec["val_loss"])
    if evaluated["start_epoch"] != 1 or not val_rel <= 1e-4:
        raise AssertionError(f"{family}_cli: --mode eval --resume started at "
                             f"{evaluated['start_epoch']} with val loss rel {val_rel}")
    return {"train_videos": train_videos, "val_videos": val_videos, "batch": batch,
            "steps": steps, "eval_batches": eval_batches,
            "epoch": {k: v for k, v in rec.items() if not k.startswith("score_")
                      or k in ("score_METEOR", "score_CIDEr", "score_F1_score")},
            "train_seconds": run["train_seconds"][0], "eval_seconds": run["eval_seconds"][0],
            "checkpoint_seconds": run["checkpoint_seconds"][0],
            "examples_per_s": train_videos / run["train_seconds"][0],
            "eval_mode_val_loss_rel": val_rel, "launches": launches[0],
            "eval_mode_launches": launches[1], "epoch_loader": waits}


# ---------------------------------------------------------------------------
# raw ingest and the regular family (BASELINE configs #4 and #5)
# ---------------------------------------------------------------------------

RAW_FAMILIES = {  # full-width configurations, the context mask off
    # config #5: RawMultimodalDVC; 8 heads (JAX's 12 do not divide 512), and
    # the audio rescale length at the 93 tokens AST gives 128 mels x 64 frames
    "raw": ["use_raw_videos=true", "dvc.input_modalities=video,audio",
            "dvc.vivit.num_heads=8", "dvc.ast.num_heads=8",
            "dataset.activity_net.audio_rescale_len=93"],
    # config #4: RegularDVC with its own ViViT (depth 4, temporal depth 2)
    "regular_raw": ["use_raw_videos=true", "dvc.use_sparse_detr=false"],
    # the regular family on .npy features
    "regular": ["dvc.use_sparse_detr=false"],
}
# the JAX init's parameter counts of each (tests/test_torch_weights.py,
# jax.eval_shape at a 6563-word vocabulary)
FULL_WIDTH_PARAMS = {"raw": 202_161_075, "regular_raw": 81_586_809, "regular": 58_083_449}
RAW_WORLD = os.path.join(ROOT, "build", "raw_world")
RAW_VIDEOS = 16  # videos of each split of the raw world
RAW_CHECK_FRAMES = 32  # video_rescale_len of the card-against-CPU checks
RAW_TRAIN_SIZES = (8, 4, 2)  # training batches tried, the largest that fits first
TRAIN_FIT_BYTES = 70e9  # a training step fits when its peak stays under this


def raw_family_config(name: str, frames: int = 0):
    """The full-width config of RAW_FAMILIES[name], f32, context mask off;
    ``frames`` > 0 cuts video_rescale_len (the dataset's and the
    proposal stack's) to that many frames."""
    from multimodal_feature_learning_tpu_torch.config import (
        apply_overrides, load_config, recompute_losses,
    )

    cfg = apply_overrides(load_config(), RAW_FAMILIES[name] + ["use_differentiable_mask=false"])
    if frames:
        cfg.dataset.activity_net.video_rescale_len = cfg.dvc.detr.video_rescale_len = frames
    recompute_losses(cfg)
    return cfg


def write_raw_world(eval_world: dict) -> dict:
    """The raw world on disk, from numpy seed 1: annotations only (the
    frames and the waves come from the synthetic decoder), RAW_VIDEOS val
    and RAW_VIDEOS train videos of 10-180 s with 1-10 events, the
    evaluation world's vocabulary and words. Returns the config overrides
    that point at it."""
    import numpy as np

    from multimodal_feature_learning_tpu_torch.data.anet import SPLIT_FILES
    from multimodal_feature_learning_tpu_torch.data.vocab import Vocab

    os.makedirs(RAW_WORLD, exist_ok=True)
    vocab_path = eval_world["dataset.activity_net.vocab_file_path"]
    words = Vocab.load(vocab_path).itos[4:]
    rng = np.random.default_rng(1)
    for split, prefix in (("val", "v_raw_eval"), ("train", "v_raw_train")):
        ann = {}
        for i in range(RAW_VIDEOS):
            dur = float(rng.uniform(10, 180))
            k = int(rng.integers(1, 11))
            centers, lengths = rng.uniform(0.2, 0.8, size=k), rng.uniform(0.05, 0.3, size=k)
            ann[f"{prefix}_{i:04d}"] = {
                "duration": dur,
                "timestamps": [[max(0.0, (c - ln / 2) * dur), min(dur, (c + ln / 2) * dur)]
                               for c, ln in zip(centers, lengths)],
                "sentences": [" ".join(rng.choice(words, size=int(rng.integers(4, 13))))
                              for _ in range(k)]}
        with open(os.path.join(RAW_WORLD, SPLIT_FILES[split]), "w") as f:
            json.dump(ann, f)
    return {"dataset.activity_net.anet_path": RAW_WORLD,
            "dataset.activity_net.vocab_file_path": vocab_path,
            "submission_dir": os.path.join(RAW_WORLD, "submission")}


def raw_samples(cfg, world: dict, split: str, n: int = RAW_VIDEOS):
    """The first ``n`` samples of ``split`` of the raw world under ``cfg``
    (decoded frames, and spectrograms with two modalities)."""
    from multimodal_feature_learning_tpu_torch.data.raw_anet import build_raw_dataset

    ds, _ = build_raw_dataset(split, world_cfg(cfg, world))
    return [s for s in (ds[i] for i in range(min(n, len(ds)))) if s is not None]


def raw_batch(cfg, samples) -> dict:
    """``collate_raw`` of the samples, as numpy arrays."""
    from multimodal_feature_learning_tpu_torch.data.raw_anet import collate_raw

    anet = cfg.dataset.activity_net
    batch = collate_raw(samples, 1, anet.max_gt_target_segments, anet.max_caption_len_all)
    return {k: v for k, v in batch.items() if hasattr(v, "dtype")}


def raw_ingest(cfg, world: dict):
    """Phase raw_ingest: the host side of raw ingest for the raw world's
    val videos at full width: per video the milliseconds of the synthetic
    decode (duration x 4 frames of 128 x 128 x 3), the nearest resample to
    video_rescale_len frames, the fbank (128 mels x 64 frames) and the whole
    dataset item (the base item's (64, 1) synthetic feature included, which
    it then drops, as JAX's); collate_raw of a batch of BATCH; then the
    loader (prefetch thread, batch 4) with a consumer that copies each batch
    to the card: its wait and copy per batch, and the bytes the copy moves
    (the frames as uint8, a quarter of their f32 bytes). Returns (the
    report, the val samples)."""
    import functools

    import numpy as np
    import torch

    from multimodal_feature_learning_tpu_torch.data.audio import aframes_to_fbank_static
    from multimodal_feature_learning_tpu_torch.data.loader import DataLoader
    from multimodal_feature_learning_tpu_torch.data.raw_anet import build_raw_dataset, collate_raw
    from multimodal_feature_learning_tpu_torch.data.video_transforms import (
        temporal_resample_nearest)
    from multimodal_feature_learning_tpu_torch.engine.train import batch_to_device

    anet = cfg.dataset.activity_net
    ds, vocab = build_raw_dataset("val", world_cfg(cfg, world))
    stages = {"decode_ms": [], "resample_ms": [], "fbank_ms": [], "item_ms": []}
    frames_decoded, samples = [], []
    for i, key in enumerate(ds.keys):
        dur = float(ds.annotation[key]["duration"])
        t0 = time.perf_counter()
        frames, wave, sr = ds.decoder(key, dur)
        t1 = time.perf_counter()
        temporal_resample_nearest(frames, anet.video_rescale_len)
        t2 = time.perf_counter()
        aframes_to_fbank_static(wave, float(sr), anet.num_mel_bins, anet.audio_target_length)
        t3 = time.perf_counter()
        samples.append(ds[i])
        t4 = time.perf_counter()
        frames_decoded.append(int(frames.shape[0]))
        for k, a, b in (("decode_ms", t0, t1), ("resample_ms", t1, t2), ("fbank_ms", t2, t3),
                        ("item_ms", t3, t4)):
            stages[k].append(1e3 * (b - a))
    t0 = time.perf_counter()
    batch = collate_raw(samples[:BATCH], vocab.pad_idx, anet.max_gt_target_segments,
                        anet.max_caption_len_all)
    collate_ms = 1e3 * (time.perf_counter() - t0)
    collate = functools.partial(collate_raw, pad_idx=vocab.pad_idx,
                                max_gt=anet.max_gt_target_segments,
                                max_caption_len=anet.max_caption_len_all)
    loader = TimedLoader(DataLoader(ds, 4, vocab.pad_idx, shuffle=False, collate_fn=collate))
    copy_ms, moved = [], []
    for b in loader:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tb = batch_to_device(b, "cuda")
        torch.cuda.synchronize()
        copy_ms.append(1e3 * (time.perf_counter() - t0))
        moved.append(sum(t.numel() * t.element_size() for t in tb.values()))
        if tb["video_tensor"].dtype != torch.uint8:
            raise AssertionError(f"raw_ingest: frames reached the card as "
                                 f"{tb['video_tensor'].dtype}")
    frames_bytes = int(batch["video_tensor"].nbytes)
    report = {"videos": len(samples), "frames_decoded": frames_decoded,
              **{k: v for k, v in stages.items()},
              **{f"median_{k}": float(np.median(v)) for k, v in stages.items()},
              "collate_ms_batch": collate_ms, "batch": BATCH,
              "batch_frames_uint8_bytes": frames_bytes,
              "batch_frames_f32_bytes": 4 * frames_bytes,
              "batch_audio_bytes": int(batch["audio_tensor"].nbytes),
              "loader_batch": 4, "loader_wait_ms": [1e3 * w for w in loader.wait],
              "loader_copy_ms": copy_ms, "loader_bytes_moved": moved}
    return report, samples


def forward_split(model, batch) -> dict:
    """One profiled forward_eval (one_by_one) of ``batch``: wall and device
    kernel ms, the device busy share and the largest kernels; then each
    backbone (``backbone_fns``) profiled alone, and its share of the
    forward's device kernel time (the DVC stack has the rest)."""
    import torch

    with torch.no_grad():
        wall, dev_ms, n, kernels = profile_call(lambda: model.forward_eval(batch, "one_by_one"))
        backbones = {name: profile_call(fn)[1] for name, fn in backbone_fns(model, batch).items()}
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    return {"wall_ms": wall, "device_kernel_ms": dev_ms, "device_busy_share": dev_ms / wall,
            "kernel_launches": n,
            "backbone_device_ms": backbones,
            "backbone_share_of_kernel_time": {k: v / dev_ms for k, v in backbones.items()},
            "dvc_stack_device_ms": dev_ms - sum(backbones.values()),
            "top_kernels": [{"name": k[:90], "ms": us / 1e3, "count": c} for k, us, c in top]}


def train_batches(cfg, samples, batch_size: int):
    """TRAIN_STEPS + 2 numpy batches of ``batch_size`` of the samples, in
    order and round again."""
    n = len(samples)
    return [raw_batch(cfg, [samples[(i * batch_size + j) % n] for j in range(batch_size)])
            for i in range(TRAIN_STEPS + 2)]


def fit_train_batch(cfg, flat, vocab_size, samples):
    """The largest of RAW_TRAIN_SIZES whose training step (one step of a
    model from ``flat``, dropout on) runs with a peak under TRAIN_FIT_BYTES:
    (that size, each size tried with its peak bytes or "out of memory")."""
    import torch

    from multimodal_feature_learning_tpu_torch.engine.state import create_train_state
    from multimodal_feature_learning_tpu_torch.engine.train import batch_to_device, make_train_step
    from multimodal_feature_learning_tpu_torch.models.criterion import build_criterion

    tried = {}
    for size in RAW_TRAIN_SIZES:
        model = build_family(cfg, vocab_size, "cuda", flat)
        criterion, weight_dict = build_criterion(cfg, model.pad_idx)
        state = create_train_state(cfg, model, steps_per_epoch=1000)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            make_train_step(criterion, weight_dict, seed=cfg.seed)(
                state, batch_to_device(train_batches(cfg, samples, size)[0], "cuda"))
            torch.cuda.synchronize()
            tried[size] = torch.cuda.max_memory_allocated()
        except torch.cuda.OutOfMemoryError:
            tried[size] = "out of memory"
        del model, state
        torch.cuda.empty_cache()
        if isinstance(tried[size], int) and tried[size] <= TRAIN_FIT_BYTES:
            return size, tried
    raise AssertionError(f"no training batch of {RAW_TRAIN_SIZES} fits: {tried}")


def family_eval(name: str, cfg, model, batch) -> dict:
    """Phases raw_eval, regular_raw_eval and regular_eval: evaluate_arms in
    MM_EVAL_ARMS (K1 36 times a raw forward, 0 times a regular one; beam 1
    equal to greedy on every row of the regular family, on 90% of the raw
    multimodal family's with every parting a near-tie, PR 13's multimodal
    rule), then ``forward_split``. One teacher-forced forward first warms
    the backbones' new shapes (cuBLAS picks its kernels on a first call),
    outside every arm."""
    model.forward_eval(batch, "teacher_forcing")
    evaluated = evaluate_arms(cfg, model, batch, MM_EVAL_ARMS,
                              beam1_min_share=0.9 if name == "raw" else 1.0)
    evaluated["forward_split"] = forward_split(model, batch)
    return evaluated


def family_train(name: str, cfg, flat, vocab_size, samples=None) -> dict:
    """Phases raw_train, regular_raw_train and regular_train: the train
    phase on the family, raw families at the batch ``fit_train_batch``
    finds, the feature family at BATCH on synthetic batches. K2 exactly 36
    times a raw step and never on the regular family; gradients finite and
    reaching every tree, the backbones' included."""
    fit = None
    if samples is None:
        trained = train(cfg, flat, vocab_size)
    else:
        size, tried = fit_train_batch(cfg, flat, vocab_size, samples)
        fit = {"batch": size, "peak_bytes_by_batch": {str(k): v for k, v in tried.items()}}
        trained = train(cfg, flat, vocab_size, train_batches(cfg, samples, size), size)
    want = msda_per_forward(cfg) * trained["steps"]
    if trained["launches"]["msda_bwd"] != want or trained["launches"]["msda_fwd"] != want:
        raise AssertionError(f"{name}_train: launches {trained['launches']}, expected {want} "
                             f"of each over {trained['steps']} steps")
    bad = {t: r for t, r in trained["grads_by_tree"].items()
           if not r["finite"] or r["nonzero_share"] < 0.5}
    if bad:
        raise AssertionError(f"{name}_train: gradients of {bad}")
    return {"batch_fit": fit, **trained}


def raw_family_phases(name: str, vocab_size: int, raw_world: dict, val_samples,
                      train_samples) -> dict:
    """Phases {name}_eval, {name}_train and {name}_check of one of
    RAW_FAMILIES, weights drawn from seed 0: its parameter count against
    the JAX init's; evaluation at batch BATCH (the raw world's val videos,
    or synthetic feature batches); training; and eval_check and train_check
    of a batch of 2 on the card against the CPU path (raw: the first two
    val videos at RAW_CHECK_FRAMES frames), with the partings and the
    backbones' features checked. Returns each phase's report."""
    import torch

    from multimodal_feature_learning_tpu_torch.data.anet import synthetic_batches
    from multimodal_feature_learning_tpu_torch.engine.train import batch_to_device

    cfg = raw_family_config(name)
    raw = cfg.use_raw_videos
    audio = len(cfg.dvc.input_modalities) == 2

    def strip(samples):  # one modality: no spectrograms in the batch
        return samples if audio else [{k: v for k, v in s.items() if k != "audio_feature"}
                                      for s in samples]

    model, flat = family_model(cfg, vocab_size)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != FULL_WIDTH_PARAMS[name]:
        raise AssertionError(f"{name}: {n_params} params, the JAX init has "
                             f"{FULL_WIDTH_PARAMS[name]}")
    reports = {}
    t = time.monotonic()
    if raw:
        batch = batch_to_device(raw_batch(cfg, strip(val_samples[:BATCH])), "cuda")
    else:
        batch = batch_to_device(next(synthetic_batches(cfg, BATCH, vocab_size, seed=0)), "cuda")
    reports["eval"] = {"params": n_params, **family_eval(name, cfg, model, batch)}
    log(f"{name}_eval", time.monotonic() - t, **reports["eval"])
    del model, batch
    torch.cuda.empty_cache()

    t = time.monotonic()
    reports["train"] = family_train(name, cfg, flat, vocab_size,
                                    strip(train_samples) if raw else None)
    log(f"{name}_train", time.monotonic() - t, **reports["train"])

    t = time.monotonic()
    check_batch = None
    cfg_check = cfg
    if raw:
        cfg_check = raw_family_config(name, frames=RAW_CHECK_FRAMES)
        check_batch = raw_batch(cfg_check, strip(raw_samples(cfg_check, raw_world, "val", 2)))
    reports["check"] = {
        "video_rescale_len": cfg_check.dataset.activity_net.video_rescale_len,
        "eval": eval_check(cfg_check, flat, vocab_size, check_batch, partings=True),
        "train": train_check(cfg_check, flat, vocab_size, check_batch)}
    log(f"{name}_check", time.monotonic() - t, **reports["check"])
    torch.cuda.empty_cache()
    return reports


# ---------------------------------------------------------------------------
# GloVe embeddings, the ViT transplant, the native collate, observability
# ---------------------------------------------------------------------------

GLOVE_DIR = os.path.join(ROOT, "build", "glove")
GLOVE_DIM = 300  # GloVe's width, not d_model's 512: the embedder's projection runs
GLOVE_LEFT_OUT = 97  # every 97th word of the vocabulary has no vector: a random row
GLOVE_STEPS = 3


def write_glove(vocab, path: str, dim: int = GLOVE_DIM, seed: int = 0) -> int:
    """A GloVe text file for the vocabulary's words but every
    GLOVE_LEFT_OUT-th (those rows of the matrix stay random): a word, then
    ``dim`` values from numpy seed ``seed``, spaces between. Returns the
    number of words written."""
    import numpy as np

    words = [w for i, w in enumerate(vocab.get_itos()) if i % GLOVE_LEFT_OUT]
    vecs = np.random.default_rng(seed).normal(0, 0.4, (len(words), dim)).astype(np.float32)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for w, v in zip(words, vecs):
            f.write(w + " " + " ".join(f"{x:.5f}" for x in v) + "\n")
    return len(words)


def replayed_steps(cfg, flat, vocab_size, steps: int, embedding_matrix=None) -> list:
    """``steps`` train steps of batch 2 with dropout off on the card, each
    replayed on the port's CPU path from the card's state before it (params
    and AdamW moments copied over), so that the two paths do not drift
    apart: per step the matchings equal, the loss within rel 1e-4, every
    term within rel 1e-3 (atol 1e-5) and the grad norm within rel 1e-3, as
    train_check holds one step; and the card's launches of K1, K2 and K6,
    which must reach msda_per_forward(cfg) a step each for K1 and K2 and one
    a step for K6."""
    import torch

    from multimodal_feature_learning_tpu_torch.data.anet import synthetic_batches
    from multimodal_feature_learning_tpu_torch.engine.state import create_train_state
    from multimodal_feature_learning_tpu_torch.engine.train import (
        batch_to_device, make_train_step)
    from multimodal_feature_learning_tpu_torch.models.criterion import build_criterion
    from multimodal_feature_learning_tpu_torch.ops import msda
    from multimodal_feature_learning_tpu_torch.ops.hungarian import HUNGARIAN

    cfg = without_dropout(cfg)
    per_step = msda_per_forward(cfg)
    batches = list(synthetic_batches(cfg, 2, vocab_size, seed=1, num_batches=steps))
    parts = {}
    for device in ("cuda", "cpu"):
        model = dropout_off(build_family(cfg, vocab_size, device, flat, embedding_matrix))
        criterion, weight_dict = build_criterion(cfg, model.pad_idx)
        parts[device] = (create_train_state(cfg, model, steps_per_epoch=1000),
                         make_train_step(criterion, weight_dict, seed=cfg.seed))
    lines = []
    for i, batch in enumerate(batches):
        snap = train_state_snapshot(parts["cuda"][0])
        load_train_state(parts["cpu"][0], {
            "step": snap["step"], "params": [p.cpu() for p in snap["params"]],
            "adam": [None if a is None else {k: v.cpu() for k, v in a.items()}
                     for a in snap["adam"]]})
        got = {}
        for device in ("cuda", "cpu"):
            state, step = parts[device]
            msda.MSDA_FWD.launches = msda.MSDA_BWD.launches = HUNGARIAN.launches = 0
            with recording_matchings(keep=True) as matched:
                metrics = step(state, batch_to_device(batch, device))
            got[device] = ({k: float(v) for k, v in metrics.items() if k != "lr"},
                           [idx.cpu() for _, _, idx in matched],
                           {"msda_fwd": msda.MSDA_FWD.launches,
                            "msda_bwd": msda.MSDA_BWD.launches,
                            "hungarian": HUNGARIAN.launches})
        (gm, gi, launched), (cm, ci, _) = got["cuda"], got["cpu"]
        if (launched["msda_fwd"] < per_step or launched["msda_bwd"] < per_step
                or launched["hungarian"] != 1):
            raise AssertionError(f"step {i} on the card did not go through the kernels: "
                                 f"{launched}, K1 and K2 {per_step} a step, K6 one")
        rel = {k: abs(gm[k] - cm[k]) / max(abs(cm[k]), 1e-12) for k in cm}
        bad = [k for k in cm if k.startswith("loss_")
               and abs(gm[k] - cm[k]) > max(1e-3 * abs(cm[k]), 1e-5)]
        if (not all(torch.equal(a, b) for a, b in zip(gi, ci)) or rel["loss"] > 1e-4
                or rel["grad_norm"] > 1e-3 or bad or not math.isfinite(gm["loss"])):
            raise AssertionError(f"step {i}: card and CPU disagree: loss rel {rel['loss']}, "
                                 f"grad norm rel {rel['grad_norm']}, terms {bad}")
        lines.append({"step": i, "loss_card": gm["loss"], "loss_cpu": cm["loss"],
                      "loss_rel": rel["loss"], "grad_norm_rel": rel["grad_norm"],
                      "worst_term_rel": max(rel[k] for k in cm if k.startswith("loss_")),
                      "launches": launched})
    del parts
    return lines


def glove(cfg, world: dict, requests) -> dict:
    """Phase glove: a GloVe file for the evaluation world's vocabulary
    (write_glove: GLOVE_DIM values a word, some words left out), the
    flagship at full width built from it through build_model_and_criterion
    (its caption embedding the GloVe matrix, then the Dense_0 projection to
    d_model and a ReLU), weights otherwise drawn from seed 0: the embedding
    equal to the matrix (its cache written); eval_check of a batch of 2 on
    the card against the CPU path; GLOVE_STEPS train steps, each against its
    CPU replay (replayed_steps); and check_fused on the 48 requests' first
    batch: the fused decode's tokens against the plain-op decode's, K3
    launched once per decode step."""
    import copy

    import torch

    from multimodal_feature_learning_tpu_torch.data.vocab import Vocab
    from multimodal_feature_learning_tpu_torch.models import build_model_and_criterion
    from multimodal_feature_learning_tpu_torch.models.load_weights import (
        build_word_embedding_matrix)
    from multimodal_feature_learning_tpu_torch.ops import fused_decode as fd
    from multimodal_feature_learning_tpu_torch.utils.weights import export_flax_params

    vocab = Vocab.load(world["dataset.activity_net.vocab_file_path"])
    path, cache = os.path.join(GLOVE_DIR, "glove.txt"), os.path.join(GLOVE_DIR, "matrix.pkl")
    t0 = time.perf_counter()
    words = write_glove(vocab, path)
    write_s = time.perf_counter() - t0
    if os.path.exists(cache):
        os.remove(cache)
    gcfg = copy.deepcopy(cfg)
    gcfg.dvc.caption.glove_file_path = path
    gcfg.dvc.caption.pretrained_word_embed_dim = GLOVE_DIM
    gcfg.dvc.caption.embedding_matrix_file_path = cache
    t0 = time.perf_counter()
    model, _, _ = build_model_and_criterion(gcfg, vocab, device="cuda", seed=0)
    build_s = time.perf_counter() - t0
    matrix = build_word_embedding_matrix(path, vocab, GLOVE_DIM, cache_path=cache)
    embedder = model.caption.target_embedding
    if not (torch.equal(embedder.embed.weight.detach().cpu(), torch.from_numpy(matrix))
            and hasattr(embedder, "Dense_0") and os.path.exists(cache)):
        raise AssertionError("the GloVe model's embedding is not the GloVe matrix")
    flat = export_flax_params(model)
    eval_checked = eval_check(gcfg, flat, len(vocab), embedding_matrix=matrix)
    steps = replayed_steps(gcfg, flat, len(vocab), GLOVE_STEPS, embedding_matrix=matrix)
    for k in fd.FUSED_DECODE.values():
        k.launches = 0
    fused = check_fused(gcfg, model, requests, compare_cpu=False)
    fused["fused_launches"] = {grid: k.launches for grid, k in fd.FUSED_DECODE.items()}
    if not all(fused["fused_launches"].values()):
        raise AssertionError(f"the fused decode did not launch: {fused['fused_launches']}")
    del model
    torch.cuda.empty_cache()
    return {"vocab": len(vocab), "glove_words": words, "unknown_rows": len(vocab) - words,
            "dim": GLOVE_DIM, "d_model": gcfg.dvc.d_model, "glove_write_s": write_s,
            "build_s": build_s, "eval_check": eval_checked, "train_steps_vs_cpu": steps,
            "check_fused": fused}


def vivit_transplant(vocab_size: int, raw_world: dict) -> dict:
    """Phase vivit_transplant: a ViT checkpoint drawn from numpy seed 0 in
    the layout of a timm export, shaped for config #5's ViViT (d_model 512,
    16 x 16 patches, 64 a 128 x 128 frame, and the class slot), carried by
    models/load_weights.py::transplant_vit_to_vivit into a one-layer ViViT
    of that width in each mode (model_name x tubelet depth and method), on
    the card and on the CPU: equal bit for bit, the patch kernel and bias
    and the positional rows as the npz gives them. Then the raw family
    (config #5 at RAW_CHECK_FRAMES frames, seeded weights) with the ViT
    transplanted into its ViViT: eval_check of the raw world's first 2 val
    videos on the card against the CPU path (partings and backbone
    features as raw_check holds them)."""
    import copy

    import numpy as np
    import torch

    from multimodal_feature_learning_tpu_torch.models.backbones import (
        VIVIT_MODES, VideoVisionTransformer)
    from multimodal_feature_learning_tpu_torch.models.load_weights import (
        inflate_patch_kernel_to_tubelet, transplant_vit_to_vivit)
    from multimodal_feature_learning_tpu_torch.utils.weights import export_flax_params

    cfg = raw_family_config("raw", frames=RAW_CHECK_FRAMES)
    viv, D = cfg.dvc.vivit, cfg.dvc.d_model
    patch, per_frame = viv.spatial_patch_size, (128 // viv.spatial_patch_size) ** 2
    rng = np.random.default_rng(0)
    vit = {"patch_embed.proj.weight": rng.normal(0, 0.02, (D, 3, patch, patch)).astype(np.float32),
           "patch_embed.proj.bias": rng.normal(0, 0.02, (D,)).astype(np.float32),
           "pos_embed": rng.normal(0, 0.02, (1, per_frame + 1, D)).astype(np.float32)}
    modes = []
    for mode in VIVIT_MODES:
        for pt, method in ((viv.temporal_patch_size, "central frame"), (2, "filter inflation"),
                           (3, "central frame")):
            torch.manual_seed(len(modes))
            cpu = VideoVisionTransformer(model_name=mode, d_model=D, depth=1, temporal_depth=1,
                                         num_heads=viv.num_heads, spatial_patch_size=patch,
                                         temporal_patch_size=pt)
            card = copy.deepcopy(cpu).cuda()
            for m in (cpu, card):
                transplant_vit_to_vivit(vit, m, num_frames=4, temporal_patch_size=pt,
                                        tokenization_method=method, model_name=mode)
            got, ref = card.state_dict(), cpu.state_dict()
            equal = all(bitwise_equal(got[k].cpu(), ref[k]) for k in ref)
            kernel = torch.from_numpy(inflate_patch_kernel_to_tubelet(
                vit["patch_embed.proj.weight"], pt, method).transpose(4, 3, 0, 1, 2).copy())
            took = torch.equal(ref["token_embeddings_layer.project_to_patch.weight"], kernel)
            if not (equal and took):
                raise AssertionError(f"ViT transplant ({mode}, {pt}, {method}): card and CPU "
                                     f"equal {equal}, kernel as inflated {took}")
            modes.append({"model_name": mode, "temporal_patch_size": pt, "method": method})
            del card
    model, _ = family_model(cfg, vocab_size)
    transplant_vit_to_vivit(vit, model.video_backbone,
                            num_frames=cfg.dataset.activity_net.video_rescale_len,
                            temporal_patch_size=viv.temporal_patch_size,
                            model_name=viv.model_name)
    flat = export_flax_params(model)
    del model
    torch.cuda.empty_cache()
    batch = raw_batch(cfg, raw_samples(cfg, raw_world, "val", 2))
    checked = eval_check(cfg, flat, vocab_size, batch, partings=True)
    return {"modes_card_equal_cpu": modes, "raw_model_name": viv.model_name,
            "video_rescale_len": cfg.dataset.activity_net.video_rescale_len,
            "eval_check": checked}


COLLATE_TURNS = 21  # calls of the native collate and of numpy, in turns


def native_collate(cfg, world: dict) -> dict:
    """Phase native_collate: the native collate (csrc/collate.cpp, built
    with the card host's g++ in the build phase, native.py) against numpy on
    the evaluation world's first BATCH val features: resize_nearest of the
    zero-padded f32 batch and of its mask to video_rescale_len, and
    pad_resize_batch (against numpy's zero-pad of the features, then its
    resize), bit for bit, with the host ms of each beside numpy's (medians
    of COLLATE_TURNS calls, the two in turns); then the loader over the world's val split (batch
    BATCH): its wait a batch with the library and under MFL_DISABLE_NATIVE,
    the batches equal."""
    import numpy as np

    from multimodal_feature_learning_tpu_torch import native
    from multimodal_feature_learning_tpu_torch.data.anet import build_dataset, nearest_resize
    from multimodal_feature_learning_tpu_torch.data.loader import DataLoader

    feat_dir = world["dataset.activity_net.video_features_file"]
    names = sorted(f for f in os.listdir(feat_dir) if f.startswith("v_eval"))[:BATCH]
    feats = [np.load(os.path.join(feat_dir, f)) for f in names]
    T = cfg.dataset.activity_net.video_rescale_len

    def numpy_pad():
        padded = np.zeros((len(feats), max(len(f) for f in feats), feats[0].shape[1]),
                          np.float32)
        mask = np.ones(padded.shape[:2], bool)
        for i, f in enumerate(feats):
            padded[i, :len(f)], mask[i, :len(f)] = f, False
        return padded, mask

    padded, mask = numpy_pad()

    def median_ms(*fns):
        """The last result of each of fns, and the median ms of its calls,
        called in turns COLLATE_TURNS times."""
        outs, times = [None] * len(fns), [[] for _ in fns]
        for _ in range(COLLATE_TURNS):
            for k, fn in enumerate(fns):
                t0 = time.perf_counter()
                outs[k] = fn()
                times[k].append(1e3 * (time.perf_counter() - t0))
        return [(o, sorted(t)[COLLATE_TURNS // 2]) for o, t in zip(outs, times)]

    if not native.available():
        raise AssertionError("MFL_DISABLE_NATIVE is set: the native collate does not run")
    report = {}
    for name, lib_fn, plain_fn in (
            ("resize_nearest_f32", lambda: native.resize_nearest(padded, T),
             lambda: nearest_resize(padded, T, axis=1)),
            ("resize_nearest_mask", lambda: native.resize_nearest(mask, T),
             lambda: nearest_resize(mask, T, axis=1)),
            ("pad_resize_batch", lambda: native.pad_resize_batch(feats, T),
             lambda: tuple(nearest_resize(a, T, axis=1) for a in numpy_pad()))):
        (got, lib_ms), (ref, numpy_ms) = median_ms(lib_fn, plain_fn)
        equal = all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in
                    zip(got if isinstance(got, tuple) else (got,),
                        ref if isinstance(ref, tuple) else (ref,)))
        if not equal:
            raise AssertionError(f"native {name} differs from numpy")
        report[name] = {"bitwise_equal": True, "native_ms": lib_ms, "numpy_ms": numpy_ms}

    anet = cfg.dataset.activity_net
    val_ds, vocab = build_dataset("val", cfg)
    waits, batches = {}, {}
    for arm, disabled in (("native", False), ("numpy", True), ("native_again", False)):
        old = os.environ.pop("MFL_DISABLE_NATIVE", None)
        if disabled:
            os.environ["MFL_DISABLE_NATIVE"] = "1"
        try:
            timed = TimedLoader(DataLoader(val_ds, BATCH, vocab.pad_idx, anet.video_rescale_len,
                                           anet.max_gt_target_segments,
                                           anet.max_caption_len_all, shuffle=False,
                                           seed=cfg.seed))
            batches[arm] = list(timed)
        finally:
            os.environ.pop("MFL_DISABLE_NATIVE", None)
            if old is not None:
                os.environ["MFL_DISABLE_NATIVE"] = old
        waits[arm] = [1e3 * w for w in timed.wait]
    for a, b in zip(batches["native"], batches["numpy"]):
        for k, v in a.items():
            if isinstance(v, np.ndarray) and not np.array_equal(v, b[k]):
                raise AssertionError(f"loader batches differ with and without the library: {k}")
    return {"videos": len(feats), "rescale_len": T, **report,
            "loader_batches": len(batches["native"]), "loader_wait_ms": waits}


def observability(cfg, flat, vocab_size) -> dict:
    """Phase observability: one flagship train step (conv_e79, batch 16,
    dropout 0.1) inside utils/observability.py::profile_section with a log
    directory: the Chrome trace it writes holds the step's CUDA kernels, K1
    and K2 among them; device_memory_stats after it: a non-zero peak, equal
    to torch.cuda.max_memory_allocated (the same allocator counter), and the
    card's memory as bytes_limit; save_grad_flow of the step's gradients
    (its JSON; the card's machine has no matplotlib, so no plot)."""
    import contextlib
    import io
    import shutil

    import torch

    from multimodal_feature_learning_tpu_torch.data.anet import synthetic_batches
    from multimodal_feature_learning_tpu_torch.engine.state import create_train_state
    from multimodal_feature_learning_tpu_torch.engine.train import (
        batch_to_device, make_train_step)
    from multimodal_feature_learning_tpu_torch.models.criterion import build_criterion
    from multimodal_feature_learning_tpu_torch.utils.observability import (
        device_memory_stats, profile_section, save_grad_flow)

    log_dir = os.path.join(ROOT, "build", "observability")
    shutil.rmtree(log_dir, ignore_errors=True)
    model = build_family(cfg, vocab_size, "cuda", flat)
    criterion, weight_dict = build_criterion(cfg, model.pad_idx)
    state = create_train_state(cfg, model, steps_per_epoch=1000)
    step = make_train_step(criterion, weight_dict, seed=cfg.seed)
    batch = batch_to_device(next(synthetic_batches(cfg, BATCH, vocab_size, seed=0)), "cuda")
    step(state, batch)  # warm: kernels loaded, allocator filled
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        with profile_section("train_step", log_dir, device="cuda"):
            step(state, batch)
    trace_path = os.path.join(log_dir, "train_step.pt.trace.json")
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names = {n: sum(n in e.get("name", "") for e in kernels) for n in ("msda_fwd", "msda_bwd",
                                                                        "hungarian")}
    mem = device_memory_stats()
    card = mem["cuda:0"]
    torch_peak = torch.cuda.max_memory_allocated()
    if not (kernels and all(names.values()) and card["peak_bytes_in_use"] > 0
            and card["peak_bytes_in_use"] == torch_peak):
        raise AssertionError(f"observability: {len(kernels)} kernels in the trace, {names}, "
                             f"peak {card['peak_bytes_in_use']} against {torch_peak}")
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    stats = save_grad_flow(grads, log_dir, step=1)
    if not all(math.isfinite(v["norm"]) for v in stats.values()):
        raise AssertionError("observability: non-finite grad-flow norms")
    del state, model
    torch.cuda.empty_cache()
    return {"printed": printed.getvalue().strip(), "trace_mb": os.path.getsize(trace_path) / 1e6,
            "trace_cuda_kernels": len(kernels), "trace_kernels_by_name": names,
            "device_memory_stats": mem, "max_memory_allocated_bytes": torch_peak,
            "grad_flow_params": len(stats),
            "grad_flow_files": sorted(f for f in os.listdir(log_dir) if f.startswith("grad"))}


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
    from multimodal_feature_learning_tpu_torch.ops.fused_decode import (
        STAGE_TIMING_FLAGS, width_flags,
    )
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
    # the fused decode's other widths (FUSED_WIDTHS and the narrow model), a
    # library each, built with the rest
    widths = sorted({width_flags(d[2], d[2] // d[3]) for _, d, _ in FUSED_WIDTHS} - {()})
    built = build.build(variants=[("fused_decode.cu", STAGE_TIMING_FLAGS)]
                        + [("fused_decode.cu", flags) for flags in widths])
    log("build", time.monotonic() - t, compiler_seconds=built,
        sources=sorted(p.name for p in CSRC_DIR.glob("*.c*")))
    # registers, shared memory and spills of the MSDA and fused decode kernels
    for source in ("msda_fwd.cu", "msda_bwd.cu", "fused_decode.cu"):
        print(f"ptxas {source}: " + " | ".join(build.ptxas_report(source)), flush=True)
    for flags in widths:
        print(f"ptxas fused_decode.cu {' '.join(flags)}: "
              + " | ".join(build.ptxas_report("fused_decode.cu", flags)), flush=True)

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
    t_widths = time.monotonic()
    width_lines = fused_widths()
    for line in width_lines:
        log("fused_widths", 0.0, **line)
    log("fused_widths", time.monotonic() - t_widths, shapes=len(FUSED_WIDTHS),
        cases=len(width_lines))
    probe_cases = check_probe_add()
    for c in probe_cases:
        log("kernel", 0.0, name="probe_add", **c)
    log("kernels", time.monotonic() - t, function_vs_plain_autograd_rel_err=function_err)

    t = time.monotonic()
    matcher_lines = matcher({"flagship": matching_problems(cfg0),
                             "dense": matching_problems(family_config("dense")),
                             "mm": matching_problems(family_config("mm")),
                             "regular": matching_problems(raw_family_config("regular"))})
    for line in matcher_lines:
        log("kernel", 0.0, name="hungarian", **line)
    log("matcher", time.monotonic() - t, cases=len(matcher_lines))

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
    continuous = serve_continuous(cfg, model, requests, results)
    log("serve_continuous", time.monotonic() - t, **continuous)

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
    cfg16, model16, _, _ = build_flagship("cuda", "bfloat16")
    served16, results16 = serve_bf16(cfg16, model16, requests, {
        "plain": results, "fused_video": fused_served["video"]["results"],
        "fused_batch": fused_served["batch"]["results"]})
    log("serve_bf16", time.monotonic() - t, **served16)

    t = time.monotonic()
    fused_checked16 = check_fused(cfg16, model16, requests, compare_cpu=False,
                                  min_token_agreement=0.9)
    log("check_fused_bf16", time.monotonic() - t, **fused_checked16)

    t = time.monotonic()
    continuous16 = serve_continuous(cfg16, model16, requests, results16["plain"])
    log("serve_continuous_bf16", time.monotonic() - t, **continuous16)

    t = time.monotonic()
    long_served = serve_long(requests)
    log("serve_long", time.monotonic() - t, **long_served)

    t = time.monotonic()
    narrow_served = serve_narrow(model.caption.head.out_features)
    log("serve_narrow", time.monotonic() - t, **narrow_served)

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

    t = time.monotonic()
    evaluated16 = eval_bf16(cfg16, model16, eval_batch, evaluated, world)
    log("eval_bf16", time.monotonic() - t, **evaluated16)
    del model, model16
    torch.cuda.empty_cache()

    t = time.monotonic()
    cli_served = serve_cli(world)
    log("serve_cli", time.monotonic() - t, **cli_served)

    t = time.monotonic()
    trained = train(cfg, flat, vocab_size)
    log("train", time.monotonic() - t, **trained)

    t = time.monotonic()
    multistepped = train_multistep(cfg, flat, vocab_size)
    log("train_multistep", time.monotonic() - t, **multistepped)

    t = time.monotonic()
    determined = {"k2": k2_determinism(dims), "dam": dam_determinism(),
                  "train_step": step_determinism(cfg, flat, vocab_size),
                  "free_running": multistepped["free_running_repeats"]}
    log("determinism", time.monotonic() - t, **determined)

    t = time.monotonic()
    observed = observability(cfg, flat, vocab_size)
    log("observability", time.monotonic() - t, **observed)

    t = time.monotonic()
    gloved = glove(cfg, world, requests)
    log("glove", time.monotonic() - t, **gloved)

    t = time.monotonic()
    collated = native_collate(world_cfg(cfg, world), world)
    log("native_collate", time.monotonic() - t, **collated)

    t = time.monotonic()
    trained16 = train_bf16(cfg, flat, vocab_size, trained)
    log("train_bf16", time.monotonic() - t, **trained16)

    t = time.monotonic()
    trained_cli = train_cli(world)
    resumed = trained_cli.pop("inference_run")
    log("train_cli", time.monotonic() - t, **trained_cli)

    t = time.monotonic()
    referenced = ref_checkpoint(world, resumed)
    log("ref_checkpoint", time.monotonic() - t, **referenced)

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

    # the dense deformable family (BASELINE config #2), seeded weights
    t = time.monotonic()
    cfg_d = family_config("dense")
    model_d, flat_d = family_model(cfg_d, vocab_size)
    dense_served, dense_results = dense_serve(cfg_d, model_d, requests)
    log("dense_serve", time.monotonic() - t,
        params=sum(p.numel() for p in model_d.parameters()), **dense_served)

    t = time.monotonic()
    dense_batch = batch_to_device(next(synthetic_batches(cfg_d, BATCH, vocab_size, seed=0)),
                                  "cuda")
    dense_evaluated = evaluate_arms(cfg_d, model_d, dense_batch)
    log("dense_eval", time.monotonic() - t, **dense_evaluated)

    t = time.monotonic()
    dense_checked = {
        "serve_rank_class": check_results(cfg_d, model_d, requests,
                                          dense_results[("class", "xla")], rank="class",
                                          n_check=2),
        "eval": eval_check(cfg_d, flat_d, vocab_size)}
    log("dense_check", time.monotonic() - t, **dense_checked)
    del model_d, dense_batch
    torch.cuda.empty_cache()

    t = time.monotonic()
    dense_trained = train(cfg_d, flat_d, vocab_size)
    dense_trained["check"] = train_check(cfg_d, flat_d, vocab_size)
    log("dense_train", time.monotonic() - t, **dense_trained)

    # the video + audio family with the BiModalEncoder (BASELINE config #3),
    # seeded weights, the context masks off (as the JAX package trained it)
    # and on
    mm_runs = {}
    for mask in (False, True):
        tag = "ctxmask" if mask else "cropmask"
        cfg_m = family_config("mm", use_differentiable_mask=mask)
        model_m, flat_m = family_model(cfg_m, vocab_size)
        n_params = sum(p.numel() for p in model_m.parameters())
        t = time.monotonic()
        mm_batch = batch_to_device(next(synthetic_batches(cfg_m, BATCH, vocab_size, seed=0)),
                                   "cuda")
        mm_evaluated = evaluate_arms(cfg_m, model_m, mm_batch, MM_EVAL_ARMS,
                                     beam1_min_share=0.9)
        log("mm_eval", time.monotonic() - t, context_mask=mask, params=n_params,
            **mm_evaluated)
        del model_m, mm_batch
        torch.cuda.empty_cache()
        t = time.monotonic()
        mm_trained = train(cfg_m, flat_m, vocab_size)
        log("mm_train", time.monotonic() - t, context_mask=mask, **mm_trained)
        t = time.monotonic()
        mm_checked = {"eval": eval_check(cfg_m, flat_m, vocab_size),
                      "train": train_check(cfg_m, flat_m, vocab_size)}
        log("mm_check", time.monotonic() - t, context_mask=mask, **mm_checked)
        mm_runs[tag] = {"train": mm_trained, "eval": mm_evaluated}
        torch.cuda.empty_cache()

    cli_runs = {}
    for family in ("dense", "mm"):
        t = time.monotonic()
        cli_runs[family] = family_cli(world, family)
        log(f"{family}_cli", time.monotonic() - t, **cli_runs[family])

    # raw ingest and the regular family (BASELINE configs #4 and #5), seeded
    # weights, the context mask off
    t = time.monotonic()
    raw_world = write_raw_world(world)
    cfg_r = raw_family_config("raw")
    ingested, raw_val = raw_ingest(cfg_r, raw_world)
    log("raw_ingest", time.monotonic() - t, **ingested)
    raw_train = raw_samples(cfg_r, raw_world, "train")
    raw_runs = {name: raw_family_phases(name, vocab_size, raw_world, raw_val, raw_train)
                for name in RAW_FAMILIES}
    del raw_val, raw_train
    t = time.monotonic()
    cli_runs["raw"] = family_cli(raw_world, "raw", family_overrides=RAW_FAMILIES["raw"],
                                 cfg=cfg_r, train_videos=RAW_VIDEOS, val_videos=RAW_VIDEOS,
                                 batch=raw_runs["raw"]["train"]["batch"])
    log("raw_cli", time.monotonic() - t, **cli_runs["raw"])

    t = time.monotonic()
    transplanted = vivit_transplant(vocab_size, raw_world)
    log("vivit_transplant", time.monotonic() - t, **transplanted)

    t = time.monotonic()
    paralleled = parallel()
    log("parallel", time.monotonic() - t, **paralleled)

    enc = next(c for c in cases if c["call"] == "encoder" and c["dtype"] == "float32")
    enc_bwd = next(c for c in bwd_cases if c["call"] == "encoder" and c["dtype"] == "float32")
    bf16_of = {  # the encoder call's bf16 case of each MSDA kernel
        "msda_fwd": next(c for c in cases if c["call"] == "encoder" and c["dtype"] == "bfloat16"),
        "msda_bwd": next(c for c in bwd_cases
                         if c["call"] == "encoder" and c["dtype"] == "bfloat16")}
    bf16_keys = ("max_abs_err", "ms", "eager_ms", "kernel_ms", "cold_kernel_ms", "plain_ms",
                 "bound_ms", "bound_by", "schedule")
    counters = kernel_counters()

    def ref_launches(name):
        """The launches of kernel ``name`` in each CLI call of ref_checkpoint."""
        return {call: n[name] for call, n in referenced["launches"].items()}

    def family_launches(name):
        """The launches of kernel ``name`` in each phase of the dense, the
        multimodal, the raw multimodal and the regular families, and in the
        parallel phase (each rank's)."""
        return {
            "parallel": {"plain": paralleled["plain"]["launches"][name],
                         "nccl_world1": paralleled["nccl_world1"]["launches"][name],
                         **{f"{layout}_rank{r}": n[name] * PARALLEL_STEPS for layout in
                            PARALLEL_LAYOUTS for r, n in enumerate(
                                paralleled[layout]["launches_per_step_and_rank"])}},
            "dense_serve": {arm: a["launches"][name]
                            for arm, a in dense_served["arms"].items()},
            "dense_eval": sum(a["launches"][name] for a in dense_evaluated["arms"].values()),
            "dense_train": dense_trained["launches"].get(name, 0),
            "mm_eval": {tag: sum(a["launches"][name] for a in r["eval"]["arms"].values())
                        for tag, r in mm_runs.items()},
            "mm_train": {tag: r["train"]["launches"].get(name, 0)
                         for tag, r in mm_runs.items()},
            **{f"{family}_cli": {"train": cli_runs[family]["launches"][name],
                                 "eval_mode": cli_runs[family]["eval_mode_launches"][name]}
               for family in ("dense", "mm", "raw")},
            **{f"{family}_eval": sum(a["launches"][name]
                                     for a in r["eval"]["arms"].values())
               for family, r in raw_runs.items()},
            **{f"{family}_train": r["train"]["launches"].get(name, 0)
               for family, r in raw_runs.items()}}

    # each phase's MSDA calls by (queries, value rows): one K1 launch each,
    # and in training one K2 launch each
    calls_by_shape = {
        "train": trained["msda_calls_by_shape"],
        "dense_serve": {arm: a["msda_calls_by_shape"]
                        for arm, a in dense_served["arms"].items()},
        "dense_train": dense_trained["msda_calls_by_shape"],
        **{f"mm_train_{tag}": r["train"]["msda_calls_by_shape"] for tag, r in mm_runs.items()},
        **{f"mm_eval_{tag}": r["eval"]["msda_calls_by_shape"] for tag, r in mm_runs.items()},
        "raw_train": raw_runs["raw"]["train"]["msda_calls_by_shape"],
        "raw_eval": raw_runs["raw"]["eval"]["msda_calls_by_shape"]}
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
            "msda_calls_by_shape": calls_by_shape,
            "launches": trained["launches"][name],
            "launches_by_path": {"serve": launches[name],
                                 "serve_continuous": continuous["launches"][name],
                                 "serve_fused": fused_served["video"]["launches"][name],
                                 "serve_cli": {row: n[name] for row, n
                                               in cli_served["launches"].items()},
                                 "train": trained["launches"][name],
                                 "train_cli": {
                                     "first_run": trained_cli["launches"][0][name],
                                     "resumed_run": trained_cli["launches"][1][name],
                                     "inference_resume":
                                         trained_cli["inference_launches"][name]},
                                 "ref_checkpoint": ref_launches(name),
                                 "eval": sum(a["launches"][name]
                                             for a in evaluated["arms"].values()),
                                 "eval_loop": {arm: a["launches"][name]
                                               for arm, a in looped["arms"].items()},
                                 "serve_bf16": {arm: served16[arm]["launches"][name]
                                                for arm, *_ in BF16_ARMS},
                                 "serve_continuous_bf16": continuous16["launches"][name],
                                 "train_bf16": {run: r["launches"][name]
                                                for run, r in trained16.items()},
                                 "eval_bf16": sum(a["launches"][name]
                                                  for a in evaluated16["arms"].values()),
                                 **family_launches(name)},
            "max_abs_err": max(c["max_abs_err"] for c in all_cases
                               if c["dtype"] == "float32"),
            "bf16": {"shape": shape.replace("f32", "bf16"),
                     **{k: bf16_of[name][k] for k in bf16_keys},
                     **({"model_path_plans": served16["msda_fwd_plans"]}
                        if name == "msda_fwd" else {})},
            "ms": case["ms"], "eager_ms": case["eager_ms"], "kernel_ms": case["kernel_ms"],
            "cold_kernel_ms": case["cold_kernel_ms"], "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"], "bound_by": case["bound_by"], "library_ms": None,
            "schedule": case["schedule"], "shape": shape,
            **({"ordered_sum": {"repeat_bitwise": True}} if name == "msda_bwd" else {}),
            "schedules": {f"{c['call']} {c['dtype']}": c["schedule"] for c in all_cases},
            "cases": all_cases,
        })
    for grid in ("video", "batch"):
        name = f"fused_decode_{grid}"
        lines = [line for line in fused_lines if line["grid"] == grid]
        f32_lines = [line for line in lines if line["dtype"] == "float32"]
        main_case, bf16_case = (next(line for line in lines if line["dtype"] == dt
                                     and line["kv"] == "dense" and not line["bias_col"])
                                for dt in ("float32", "bfloat16"))
        n = fused_served[grid]["launches"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": os.path.relpath(str(CSRC_DIR / counters[name].source), ROOT),
            "replaces": counters[name].replaces,
            "launches": n, "launches_by_path": {
                "serve_fused": n, "serve_continuous": continuous["launches"][name],
                "eval": sum(a["launches"][name] for a in evaluated["arms"].values()),
                "eval_loop": {arm: a["launches"][name] for arm, a in looped["arms"].items()},
                "serve_bf16": {arm: served16[arm]["launches"][name] for arm, *_ in BF16_ARMS},
                "serve_continuous_bf16": continuous16["launches"][name],
                "eval_bf16": sum(a["launches"][name] for a in evaluated16["arms"].values()),
                "dense_serve": {arm: a["launches"][name]
                                for arm, a in dense_served["arms"].items()},
                "dense_eval": sum(a["launches"][name]
                                  for a in dense_evaluated["arms"].values()),
                "serve_long": {dt: {arm: a["launches"][name] for arm, a in r["arms"].items()}
                               for dt, r in long_served.items()},
                "serve_narrow": {arm: a["launches"][name]
                                 for arm, a in narrow_served["arms"].items()},
                "ref_checkpoint": ref_launches(name)},
            "max_abs_err": max(line["max_abs_err"] for line in f32_lines),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
            "bound_f32_simt_ms": main_case["bound_f32_simt_ms"], "library_ms": None,
            "shape": f"one decode step, B={BATCH} G={fused_dims[1]} D={fused_dims[2]} "
                     f"depth {fused_dims[4]} Sp=640 f32, dense K/V, no bias column, step 9",
            "bf16": {"shape": "the same step in bf16 (bf16 tensor cores, m16n8k16)",
                     "max_abs_err": max(line["max_abs_err"] for line in lines
                                        if line["dtype"] == "bfloat16"),
                     **{k: bf16_case[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
                     "launches_serve_bf16": served16[f"fused_{grid}"]["launches"][name]},
            "cases": [{k: v for k, v in line.items() if k != "steps"} for line in lines],
            "widths": [{k: line[k] for k in (
                "shape", "dims", "Sp", "dtype", "kv", "schedule", "smem_bytes", "max_abs_err",
                "tolerance", "repeat_bitwise", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")} for line in width_lines if line["grid"] == grid],
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
    k6 = next(line for line in matcher_lines
              if line["case"] == "flagship" and line["kind"] == "random")
    kernels.append({
        "name": "hungarian", "route": "cuda",
        "source": os.path.relpath(str(CSRC_DIR / counters["hungarian"].source), ROOT),
        "replaces": counters["hungarian"].replaces + " (lax loops, no Pallas kernel)",
        "launches": trained["launches"]["hungarian"],
        "launches_by_path": {
            "train": trained["launches"]["hungarian"],
            "train_multistep": {run: n["hungarian"]
                                for run, n in multistepped["launches"].items()},
            "train_bf16": {run: r["launches"]["hungarian"] for run, r in trained16.items()},
            "train_cli": {"first_run": trained_cli["launches"][0]["hungarian"],
                          "resumed_run": trained_cli["launches"][1]["hungarian"],
                          "steps_per_dispatch_4":
                              trained_cli["steps_per_dispatch_4"]["launches"]["hungarian"],
                          "inference_resume": trained_cli["inference_launches"]["hungarian"]},
            "ref_checkpoint": ref_launches("hungarian"),
            "eval": sum(a["launches"]["hungarian"] for a in evaluated["arms"].values()),
            "eval_loop": {arm: a["launches"]["hungarian"] for arm, a in looped["arms"].items()},
            "eval_bf16": sum(a["launches"]["hungarian"] for a in evaluated16["arms"].values()),
            **family_launches("hungarian")},
        "max_abs_err": max(line["max_abs_err"] for line in matcher_lines),
        **{k: k6[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                              "graph_ms", "wrapper_host_us", "plan", "chain_step_ns",
                              "chain_floor_ms")},
        "in_train_step_device_us": trained["hungarian_device_us"],
        "shape": f"{k6['problems']} problems (6 decoder layers x B={BATCH}) of "
                 f"{k6['queries']} queries x {k6['gt_slots']} GT slots, f32",
        "cases": matcher_lines,
    })
    log("total", time.monotonic() - t_all)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--parallel-rank":
        sys.exit(parallel_rank(sys.argv[2]))
    sys.exit(main())
