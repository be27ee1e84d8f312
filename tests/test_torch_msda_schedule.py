"""The MSDA kernels' schedules, shared-memory rules and bindings, on the CPU.

K1 (``csrc/msda_fwd.cu``) and K2 (``csrc/msda_bwd.cu``) run only on the
card; what picks their schedules is Python (``ops/msda.py::msda_fwd_plan``,
``msda_bwd_plan``), and it is pinned here: the flagship's calls fit a
block's shared memory in f32 and bf16, a long pyramid takes the chunked
route, the decoder's 20 queries take the gather schedule, and widths
outside the kernels' contracts raise with the limit in the message. The
plans' byte counts mirror the launchers' checks against the same limit,
which the sources state."""

from __future__ import annotations

import ctypes
import inspect
import re
from pathlib import Path

import pytest
import torch

from multimodal_feature_learning_tpu_torch.ops import build, msda
from multimodal_feature_learning_tpu_torch.tools import msda_device_time, timing

FLAGSHIP = (300, 150, 75, 38)          # pyramid_shapes(563, 4)
LONG_PYRAMID = (1200, 600, 300, 150)
B, H, DH, P = 16, 8, 64, 4
Q_ENCODER, Q_DECODER = 282, 20          # int(563 * 0.5) + 1 sparse tokens; num_queries


def fits_an_sm(smem: int, blocks: int) -> bool:
    return blocks * (smem + 1024) <= msda.SMEM_PER_SM


@pytest.mark.parametrize("itemsize", [4, 2])
def test_flagship_encoder_call_stages_the_whole_slab(itemsize):
    plan = msda.msda_fwd_plan(FLAGSHIP, B, H, DH, Q_ENCODER, P, itemsize)
    assert plan.schedule == "staged"
    assert plan.rows == sum(FLAGSHIP)
    assert plan.vec * itemsize == 16 and plan.vec * plan.lanes_per_query == DH
    assert plan.smem_bytes <= msda.SMEM_PER_BLOCK
    # the slab (S rows of Dh channels) and one 16-byte tap record a thread
    assert plan.smem_bytes == sum(FLAGSHIP) * DH * itemsize + plan.threads * 16
    tiles = -(-Q_ENCODER // plan.q_tile)
    per_sm = msda.SMEM_PER_SM // (plan.smem_bytes + 1024)
    assert B * H * tiles <= per_sm * msda.H100_SMS  # one wave
    if itemsize == 4:
        assert plan.q_tile == Q_ENCODER  # one block a (b, h) on 132 SMs


def test_flagship_backward_fits_two_blocks_an_sm():
    for q in (Q_ENCODER, Q_DECODER):
        plan = msda.msda_bwd_plan(FLAGSHIP, B, H, DH, q, P)
        assert plan.schedule == "level" and plan.chunks == 1
        assert plan.q_round == q  # one round: every g row of the (b, h) at once
        assert plan.vec == 4
        assert plan.smem_bytes <= msda.SMEM_PER_BLOCK
        assert fits_an_sm(plan.smem_bytes, 1024 // plan.threads)  # 64 registers a thread
    enc = msda.msda_bwd_plan(FLAGSHIP, B, H, DH, Q_ENCODER, P)
    # g rows, 36 bytes a tap, the cursors of 300 rows and the halo
    assert enc.smem_bytes == Q_ENCODER * DH * 4 + Q_ENCODER * P * 36 + 301 * 4


@pytest.mark.parametrize("itemsize", [4, 2])
def test_long_pyramid_takes_the_chunked_route(itemsize):
    q = int(sum(LONG_PYRAMID) * 0.5) + 1
    plan = msda.msda_fwd_plan(LONG_PYRAMID, 2, H, DH, q, P, itemsize)
    assert plan.schedule == "staged_chunked"
    assert 0 < plan.rows < sum(LONG_PYRAMID)
    assert plan.smem_bytes <= msda.SMEM_PER_BLOCK
    bwd = msda.msda_bwd_plan(LONG_PYRAMID, 2, H, DH, q, P)
    assert bwd.schedule == "chunked" and bwd.chunks > 1
    assert bwd.q_round < q  # more than one round of queries
    assert bwd.smem_bytes <= msda.SMEM_PER_BLOCK
    # the tool's chunked case is this one
    assert ("long_pyramid", 2, q, LONG_PYRAMID) in msda_device_time.CASES


@pytest.mark.parametrize("itemsize", [4, 2])
def test_decoder_call_takes_the_gather_schedule(itemsize):
    plan = msda.msda_fwd_plan(FLAGSHIP, B, H, DH, Q_DECODER, P, itemsize)
    assert plan.schedule == "gather" and plan.rows == 0 and plan.smem_bytes == 0
    assert plan.threads == msda.FWD_GATHER_THREADS


def test_stage_rule_threshold_at_the_flagship_pyramid():
    """K1 stages the rows once its taps read each row four times on
    average: 2 * Q * L * P >= 4 * S, so Q >= 71 at S = 563, L = P = 4."""
    S = sum(FLAGSHIP)
    first = next(q for q in range(1, 300) if 2 * q * 16 >= msda.FWD_STAGE_READS_PER_ROW * S)
    assert first == 71
    assert msda.msda_fwd_plan(FLAGSHIP, B, H, DH, first - 1, P, 4).schedule == "gather"
    assert msda.msda_fwd_plan(FLAGSHIP, B, H, DH, first, P, 4).schedule == "staged"


@pytest.mark.parametrize("dh,itemsize,aligned,vec,lanes", [
    (64, 4, True, 4, 16), (64, 2, True, 8, 8), (64, 4, False, 1, 16), (16, 4, True, 4, 4),
    (24, 4, True, 4, 8), (6, 4, True, 1, 8), (12, 2, True, 1, 16), (1024, 4, True, 4, 16),
])
def test_forward_vector_width_and_lanes(dh, itemsize, aligned, vec, lanes):
    """16-byte vectors where Dh divides into them and value is aligned,
    else one channel a lane; a lane group covers Dh (rounded up to a power
    of two) or 16 lanes, and a wider Dh is cut into channel slices."""
    plan = msda.msda_fwd_plan(FLAGSHIP, B, H, dh, Q_ENCODER, P, itemsize, aligned=aligned)
    assert (plan.vec, plan.lanes_per_query) == (vec, lanes)
    assert plan.smem_bytes <= msda.SMEM_PER_BLOCK


def test_backward_vector_width():
    assert msda.msda_bwd_plan(FLAGSHIP, B, H, 64, Q_ENCODER, P).vec == 4
    assert msda.msda_bwd_plan(FLAGSHIP, B, H, 64, Q_ENCODER, P, aligned=False).vec == 1
    assert msda.msda_bwd_plan(FLAGSHIP, B, H, 6, Q_ENCODER, P).vec == 1
    wide = msda.msda_bwd_plan(FLAGSHIP, B, H, 256, Q_ENCODER, P)
    assert wide.smem_bytes <= msda.SMEM_PER_BLOCK and wide.q_round < Q_ENCODER


@pytest.mark.parametrize("fn,dh,levels,limit", [
    ("fwd", 1025, 4, "Dh <= 1024"), ("fwd", 64, 17, "L <= 16"),
    ("bwd", 257, 4, "Dh <= 256"), ("bwd", 64, 17, "L <= 16"),
])
def test_widths_outside_the_contract_raise(fn, dh, levels, limit):
    shapes = (4,) * levels
    with pytest.raises(ValueError, match=re.escape(limit)):
        if fn == "fwd":
            msda.msda_fwd_plan(shapes, 1, 1, dh, 8, 2, 4)
        else:
            msda.msda_bwd_plan(shapes, 1, 1, dh, 8, 2)


def test_sources_state_the_limit_the_plans_use():
    for source in ("msda_fwd.cu", "msda_bwd.cu"):
        src = (build.CSRC_DIR / source).read_text()
        assert f"#define MSDA_SMEM_LIMIT {msda.SMEM_PER_BLOCK}" in src
        assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in src


@pytest.mark.parametrize("source,kernel,schedules", [
    ("msda_fwd.cu", "_msda_fwd_kernel", ('"staged"', '"staged_chunked"', '"gather"')),
    ("msda_bwd.cu", "_msda_bwd_kernel", ("counting sort", "halo")),
])
def test_sources_name_the_tpu_kernel_their_design_and_bound(source, kernel, schedules):
    src = (build.CSRC_DIR / source).read_text()
    assert f"ops/pallas_msda.py::{kernel}" in src
    assert "Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): memory." in src
    for word in schedules:
        assert word in src


@pytest.mark.parametrize("symbol,binding", [
    ("msda_fwd_launch", msda.MsdaForwardKernel), ("msda_bwd_launch", msda.MsdaBackwardKernel),
])
def test_launcher_signatures_match_the_bindings(symbol, binding):
    src = (build.CSRC_DIR / binding.source).read_text()
    start = src.index(f'extern "C" int {symbol}(') + len(f'extern "C" int {symbol}(')
    params = [p.strip() for p in src[start:src.index(")", start)].split(",")]
    kinds = ["ptr" if "*" in p else "int" for p in params]
    assert kinds == ["int" if t is ctypes.c_int else "ptr" for t in binding.argtypes]


def test_backward_wrapper_launches_no_memset():
    """Every dvalue row is written by exactly one block, so the wrapper
    allocates its outputs uninitialised."""
    body = inspect.getsource(msda.MsdaBackwardKernel.__call__)
    assert "torch.empty_like(value)" in body
    assert "zeros" not in body.split("if loc.numel() == 0")[0]


def test_device_time_tool_loads_a_checkout_beside_this_one():
    root = Path(msda.__file__).resolve().parents[2]
    pkg = msda_device_time.load_checkout(root, "_msda_schedule_test")
    other = __import__("_msda_schedule_test.ops.msda", fromlist=["MSDA_FWD"])
    assert pkg.__name__ == "_msda_schedule_test"
    assert other.MSDA_FWD is not msda.MSDA_FWD  # its own launch counts and library
    assert Path(other.__file__).resolve() == Path(msda.__file__).resolve()


def test_device_time_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="card"):
        msda_device_time.run(turns=1)
    with pytest.raises(ValueError, match="CUDA"):
        timing.graph_call_ms(lambda: None, torch.device("cpu"))
