"""Multi-scale deformable attention: the CUDA kernels' wrappers, the plans
that pick their schedules, and the autograd Function that joins them.

Counterpart of the JAX ``ops/pallas_msda.py::ms_deform_attn_pallas`` and its
custom VJP, which the model reaches with ``msda_backend="pallas"``. A tensor
on the CPU goes to the plain core and its plain backward
(``ops/ms_deform_attn.py``); a tensor on a CUDA device goes to the
hand-written kernels ``csrc/msda_fwd.cu`` (K1) and ``csrc/msda_bwd.cu`` (K2)
or raises. There is no fallback from a kernel to the plain version.

Each wrapper launches its kernel with a plan (``msda_fwd_plan``,
``msda_bwd_plan``) computed here from the shapes alone, so that the CPU
tests pin every rule: which schedule, how many rows and queries a block,
and the shared memory each block asks for (at most ``SMEM_PER_BLOCK``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Sequence

import torch

from .build import KernelBinding
from .ms_deform_attn import ms_deform_attn_core, ms_deform_attn_core_backward

SMEM_PER_BLOCK = 232_448  # shared memory one block may have on sm_90 (H100)
SMEM_PER_SM = 233_472     # shared memory of one SM; each resident block also takes 1 KB
H100_SMS = 132
MAX_LEVELS = 16
FWD_MAX_DH = 1024
BWD_MAX_DH = 256
# K1 stages a (b, h)'s value rows in shared memory when its taps read each
# row at least this many times on average (2 rows a tap); below it, it
# gathers the taps' rows from L2
FWD_STAGE_READS_PER_ROW = 4
FWD_THREADS = 512          # a block of the staged schedule
FWD_GATHER_THREADS = 256   # a block of the gather schedule
BWD_MAX_ROWS = 1024        # rows a K2 block owns at most
BWD_BLOCKS_PER_SM = 2      # K2 cuts levels into row ranges until the grid has this many
# a K2 block's shared memory is kept to what lets two blocks share an SM;
# it bounds the queries a round (their g rows and taps)
BWD_SMEM_TARGET = SMEM_PER_SM // 2 - 1024


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


@dataclass(frozen=True)
class MsdaFwdPlan:
    """How K1 runs on one call's shapes. ``schedule`` is "gather",
    "staged" (a block holds all S value rows of its (b, h) and channel
    slice) or "staged_chunked" (it walks them in chunks of ``rows``)."""
    schedule: str
    vec: int              # channels a lane loads at once (16 bytes, or 1)
    lanes_per_query: int
    rows: int             # value rows a chunk (0 in the gather schedule)
    q_tile: int           # queries a block
    threads: int
    smem_bytes: int


def msda_fwd_plan(shapes: Sequence[int], B: int, H: int, Dh: int, Q: int, P: int,
                  itemsize: int, aligned: bool = True, num_sms: int = H100_SMS) -> MsdaFwdPlan:
    """K1's schedule for value (B, S, H, Dh) of ``itemsize`` bytes and loc
    (B, Q, H, L, P). Raises on widths outside the kernel's contract."""
    L, S = len(shapes), sum(shapes)
    if Dh > FWD_MAX_DH or L > MAX_LEVELS:
        raise ValueError(f"the MSDA forward kernel takes Dh <= {FWD_MAX_DH} and L <= "
                         f"{MAX_LEVELS} levels, got Dh={Dh}, L={L}")
    full = 16 // itemsize
    vec = full if (Dh % full == 0 and aligned) else 1
    lpq = min(16, _pow2_at_least(-(-Dh // vec)))
    dc = lpq * vec
    slices = -(-Dh // dc)
    if 2 * Q * L * P < FWD_STAGE_READS_PER_ROW * S:
        groups = FWD_GATHER_THREADS // lpq
        return MsdaFwdPlan("gather", vec, lpq, 0, groups, FWD_GATHER_THREADS, 0)
    row_bytes = dc * itemsize
    stage = FWD_THREADS * 16  # each lane group's taps at hand (MsdaTapRows)
    slab = _round16(S * row_bytes)
    if slab + stage <= SMEM_PER_BLOCK:
        smem = slab + stage
        per_sm = max(1, min(2048 // FWD_THREADS, SMEM_PER_SM // (smem + 1024)))
        tiles = max(1, min(Q, per_sm * num_sms // (B * H * slices)))
        return MsdaFwdPlan("staged", vec, lpq, S, -(-Q // tiles), FWD_THREADS, smem)
    # the rows do not fit: one block an SM, partial sums of its queries kept
    # in shared memory (at most half of it) between chunks of rows
    tiles = max(1, min(Q, num_sms // (B * H * slices)))
    q_tile = min(-(-Q // tiles), SMEM_PER_BLOCK // 2 // (dc * 4))
    part = _round16(q_tile * dc * 4)
    rows = (SMEM_PER_BLOCK - part - stage - 16) // row_bytes
    smem = _round16(rows * row_bytes) + part + stage
    return MsdaFwdPlan("staged_chunked", vec, lpq, rows, q_tile, FWD_THREADS, smem)


@dataclass(frozen=True)
class MsdaBwdPlan:
    """How K2 runs on one call's shapes. ``schedule`` is "level" (a block
    owns all rows of one level of one (b, h)) or "chunked" (each level cut
    into ``chunks`` row ranges, a block each). A block takes the queries in
    rounds of ``q_round``, with their g rows in shared memory."""
    schedule: str
    vec: int              # channels a lane loads at once (4, or 1)
    chunks: int
    q_round: int
    threads: int
    smem_bytes: int


def msda_bwd_plan(shapes: Sequence[int], B: int, H: int, Dh: int, Q: int, P: int,
                  aligned: bool = True, num_sms: int = H100_SMS,
                  itemsize: int = 4) -> MsdaBwdPlan:
    """K2's schedule for value (B, S, H, Dh) of ``itemsize`` bytes (f32 4,
    bf16 2; the g rows a round stages in shared memory have the same) and
    loc (B, Q, H, L, P). Raises on widths outside the kernel's contract."""
    L, longest = len(shapes), max(shapes)
    if Dh > BWD_MAX_DH or L > MAX_LEVELS:
        raise ValueError(f"the MSDA backward kernel takes Dh <= {BWD_MAX_DH} and L <= "
                         f"{MAX_LEVELS} levels, got Dh={Dh}, L={L}")
    vec = 4 if (Dh % 4 == 0 and aligned) else 1
    chunks = max(-(-longest // BWD_MAX_ROWS), -(-BWD_BLOCKS_PER_SM * num_sms // (B * H * L)))
    chunks = min(chunks, longest)
    rows = -(-longest // chunks) + 1  # the rows a block owns, and its halo row
    cursors = rows * 4
    # a query's g row, and per tap its two dot products (8 bytes), two
    # entries (16) and a TapRec (12); at most 32767 taps a round (16-bit slots)
    per_query = Dh * itemsize + P * 36
    q_round = max(1, min(Q, 32767 // P, (BWD_SMEM_TARGET - cursors - 16) // per_query))
    # the dot products' room also holds the sort's two-byte count of each row
    # for at least one warp
    scratch = max(q_round * P * 8, -(-2 * rows // 8) * 8)
    smem = _round16(q_round * Dh * itemsize) + scratch + q_round * P * 28 + cursors
    # at 64 registers a thread an SM holds 1024 threads: two 512-thread
    # blocks, or four 256-thread ones where shared memory lets four share it
    threads = 256 if SMEM_PER_SM // (smem + 1024) >= 4 else 512
    return MsdaBwdPlan("level" if chunks == 1 else "chunked", vec, chunks, q_round,
                       threads, smem)


def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _as_f32(t: torch.Tensor) -> torch.Tensor:
    """A float tensor as the f32 contiguous tensor the kernels read."""
    if not t.is_floating_point():
        raise TypeError(f"expected a float tensor, got {t.dtype}")
    return t.float().contiguous()


def _check_msda_args(value, shapes, loc, aw):
    """Shapes, dtypes, devices and contiguity that both kernels take: value
    f32 or bf16, loc and aw f32. A dtype the kernels do not take raises
    before the device is looked at."""
    if value.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"value must be float32 or bfloat16, got {value.dtype}")
    if value.device.type != "cuda":
        raise ValueError(f"the MSDA kernels take CUDA tensors, got {value.device}")
    if value.dim() != 4 or loc.dim() != 5:
        raise ValueError(
            f"expected value (B,S,H,Dh) and loc (B,Q,H,L,P), got "
            f"{tuple(value.shape)} and {tuple(loc.shape)}")
    B, S, H, Dh = value.shape
    _, Q, _, L, P = loc.shape
    if loc.shape != (B, Q, H, len(shapes), P) or aw.shape != loc.shape:
        raise ValueError(
            f"loc {tuple(loc.shape)} / aw {tuple(aw.shape)} do not match "
            f"value {tuple(value.shape)} and {len(shapes)} levels")
    if sum(shapes) != S:
        raise ValueError(f"sum(temporal_shapes)={sum(shapes)} != S={S}")
    for name, t in (("loc", loc), ("aw", aw)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != value.device:
            raise ValueError(f"{name} is on {t.device}, value on {value.device}")
    if not (value.is_contiguous() and loc.is_contiguous() and aw.is_contiguous()):
        raise ValueError("value, loc and aw must be contiguous")
    return B, S, H, Dh, Q, L, P


class MsdaForwardKernel(KernelBinding):
    """``msda_fwd_launch`` (K1)."""

    source, symbol = "msda_fwd.cu", "msda_fwd_launch"
    # msda_fwd_launch(value, loc, aw, out, B, S, H, Dh, Q, L, P, level_T,
    #                 value_is_bf16, vec, lpq, rows, q_tile, threads, stream)
    argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 6 + [ctypes.c_void_p]

    def __call__(self, value, temporal_shapes, loc, aw):
        """The forward alone: its output carries no autograd history, so it
        refuses inputs that would need one. Differentiable callers go
        through ``ms_deform_attn`` (``MSDeformAttnFunction``). value is f32
        or bf16 (the output takes its dtype); loc and aw may be any float
        dtype and reach the kernel as f32, as JAX's wrapper casts them
        (``pallas_msda.py:86-87``)."""
        if torch.is_grad_enabled() and any(t.requires_grad for t in (value, loc, aw)):
            raise RuntimeError(
                "MSDA_FWD was called with inputs that require grad while grad "
                "mode is on; its output would cut the autograd graph. Call "
                "ops.msda.ms_deform_attn, which differentiates through K2")
        shapes = [int(t) for t in temporal_shapes]
        loc, aw = _as_f32(loc), _as_f32(aw)
        B, S, H, Dh, Q, L, P = _check_msda_args(value, shapes, loc, aw)
        out = torch.empty((B, Q, H * Dh), dtype=value.dtype, device=value.device)
        plan = msda_fwd_plan(shapes, B, H, Dh, Q, P, value.element_size(),
                             aligned=value.data_ptr() % 16 == 0, num_sms=_num_sms(value.device))
        if out.numel() == 0:
            return out
        fn = self._launcher()
        level_T = (ctypes.c_int * L)(*shapes)
        with torch.cuda.device(value.device):
            stream = torch.cuda.current_stream(value.device).cuda_stream
            rc = fn(value.data_ptr(), loc.data_ptr(), aw.data_ptr(), out.data_ptr(),
                    B, S, H, Dh, Q, L, P, level_T, int(value.dtype == torch.bfloat16),
                    plan.vec, plan.lanes_per_query, plan.rows, plan.q_tile, plan.threads,
                    stream)
        if rc != 0:
            raise RuntimeError(f"msda_fwd_launch failed with CUDA error {rc} ({plan})")
        self.launches += 1
        return out


MSDA_FWD = MsdaForwardKernel()


class MsdaBackwardKernel(KernelBinding):
    """``msda_bwd_launch`` (K2): value and grad_out f32 or bf16 (the same)."""

    source, symbol = "msda_bwd.cu", "msda_bwd_launch"
    # msda_bwd_launch(value, loc, aw, g, dvalue, dacc, dloc, daw, B, S, H, Dh,
    #                 Q, L, P, level_T, value_is_bf16, vec, chunks, q_round,
    #                 threads, stream)
    argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
        ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 5 + [ctypes.c_void_p]

    def __call__(self, value, temporal_shapes, loc, aw, grad_out):
        """(dvalue (B,S,H,Dh) in value's dtype, dloc and daw (B,Q,H,L,P) in
        the dtypes of loc and aw), as JAX's ``_bwd_pallas`` returns them.
        The kernel sums in f32 and rounds dvalue once; loc and aw reach it as
        f32. It writes every element of the three, so they start
        uninitialised."""
        shapes = [int(t) for t in temporal_shapes]
        loc32, aw32 = _as_f32(loc), _as_f32(aw)
        B, S, H, Dh, Q, L, P = _check_msda_args(value, shapes, loc32, aw32)
        if grad_out.shape != (B, Q, H * Dh) or grad_out.dtype != value.dtype \
                or grad_out.device != value.device or not grad_out.is_contiguous():
            raise ValueError(
                f"grad_out must be a contiguous {value.dtype} ({B}, {Q}, {H * Dh}) tensor "
                f"on {value.device}, got {tuple(grad_out.shape)} {grad_out.dtype} "
                f"on {grad_out.device}")
        bf16 = value.dtype == torch.bfloat16
        plan = msda_bwd_plan(shapes, B, H, Dh, Q, P,
                             aligned=value.data_ptr() % 16 == 0 and grad_out.data_ptr() % 16 == 0,
                             num_sms=_num_sms(value.device), itemsize=value.element_size())
        dvalue = torch.empty_like(value)
        dloc = torch.empty_like(loc32)
        daw = torch.empty_like(aw32)
        if loc.numel() == 0:
            return dvalue.zero_(), dloc.to(loc.dtype), daw.to(aw.dtype)
        # bf16 over more than one round of queries: the f32 sums between rounds
        dacc = torch.empty(value.shape, dtype=torch.float32, device=value.device) \
            if bf16 and plan.q_round < Q else None
        fn = self._launcher()
        level_T = (ctypes.c_int * L)(*shapes)
        with torch.cuda.device(value.device):
            stream = torch.cuda.current_stream(value.device).cuda_stream
            rc = fn(value.data_ptr(), loc32.data_ptr(), aw32.data_ptr(), grad_out.data_ptr(),
                    dvalue.data_ptr(), 0 if dacc is None else dacc.data_ptr(),
                    dloc.data_ptr(), daw.data_ptr(), B, S, H, Dh, Q, L, P, level_T, int(bf16),
                    plan.vec, plan.chunks, plan.q_round, plan.threads, stream)
        if rc != 0:
            raise RuntimeError(f"msda_bwd_launch failed with CUDA error {rc} ({plan})")
        self.launches += 1
        return dvalue, dloc.to(loc.dtype), daw.to(aw.dtype)


MSDA_BWD = MsdaBackwardKernel()


class MSDeformAttnFunction(torch.autograd.Function):
    """MSDA with its backward: K1 and K2 on a CUDA tensor, the plain core and
    the plain backward on the CPU. Saves value, loc and aw. value may be
    bf16 (the bf16 trunk's): the output and dvalue are in its dtype, dloc
    and daw in those of loc and aw."""

    @staticmethod
    def forward(ctx, value, temporal_shapes, loc, aw):
        shapes = tuple(int(t) for t in temporal_shapes)
        ctx.shapes = shapes
        ctx.save_for_backward(value, loc, aw)
        if value.device.type == "cpu":
            return ms_deform_attn_core(value, shapes, loc, aw)
        return MSDA_FWD(value, shapes, loc, aw)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, aw = ctx.saved_tensors
        grad_out = grad_out.contiguous()
        if value.device.type == "cpu":
            dvalue, dloc, daw = ms_deform_attn_core_backward(
                value, ctx.shapes, loc, aw, grad_out)
        else:
            dvalue, dloc, daw = MSDA_BWD(value, ctx.shapes, loc, aw, grad_out)
        return dvalue, None, dloc, daw


def ms_deform_attn(
    value: torch.Tensor,
    temporal_shapes: Sequence[int],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """Same contract as ``ms_deform_attn_core``: value (B,S,H,Dh), loc and
    aw (B,Q,H,L,P) -> (B,Q,H*Dh), differentiable in all three."""
    return MSDeformAttnFunction.apply(value, tuple(temporal_shapes),
                                      sampling_locations, attention_weights)
