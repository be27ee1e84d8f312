"""K6's plan, argmin key and register route, on the CPU.

K6 (``csrc/hungarian.cu``) runs only on the card. What decides how it runs
is Python (``ops/hungarian.py::hungarian_plan``, which the launcher computes
again and holds the wrapper to), and it is pinned here: the two routes and
their shared memory up to 1024 queries, and the shapes it refuses. The kernel's argmin is the smallest order key
(``order_key``) at the lowest lane; hypothesis holds that to ``np.argmin``
on f32 values with both zeros, NaN, infinities, 1e18, the matcher's
+-1e5 guard and repeats, for one column a lane and for route "global"'s
columns reduced a lane at a time first. Then a numpy emulation of route
"warp", lane by lane (register state, the visited rows' potentials, the key
argmin, the augmenting path found and applied by shuffles), must equal
``batched_hungarian`` on every slot of ``chip_smoke.py``'s matcher cases,
which holds K6 to the same on the card; ``test_torch_matcher.py`` holds
``batched_hungarian`` against JAX."""

from __future__ import annotations

import re

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

import chip_smoke
from multimodal_feature_learning_tpu_torch.ops import build
from multimodal_feature_learning_tpu_torch.ops.hungarian import (
    HUNGARIAN, MAX_COLS, ROUTES, SMEM_NO_OPT_IN, HungarianPlan, batched_hungarian,
    hungarian_plan, order_key,
)

SOURCE = (build.CSRC_DIR / "hungarian.cu").read_text()
LANES = 32
IDLE_KEY = np.uint32(0xFFFFFFFF)
INF = np.float32(1e18)


def test_flagship_takes_the_register_route():
    plan = hungarian_plan(20, 10)
    assert plan == HungarianPlan("warp", 20 * 10 * 4)  # the problem's staged cost


@pytest.mark.parametrize("Q", [1, 2, 10, 20, 31, 32, 33, 100, 300, 1000, 1024])
def test_routes_and_shared_memory_up_to_the_contract(Q):
    for G in sorted({1, min(Q, 10), min(Q, 32), Q}):
        plan = hungarian_plan(Q, G)
        assert plan.route in ROUTES and plan.smem_bytes <= SMEM_NO_OPT_IN
        if Q + 1 <= 32:
            assert plan == HungarianPlan("warp", Q * G * 4)
        else:
            assert plan == HungarianPlan("global", 2 * (G + 1) * 4 + 5 * (Q + 1) * 4)


def test_largest_case_and_the_limits():
    assert hungarian_plan(31, 31) == HungarianPlan("warp", 31 * 31 * 4)
    assert hungarian_plan(1024, 32) == HungarianPlan("global", 2 * 33 * 4 + 5 * 1025 * 4)
    assert hungarian_plan(MAX_COLS, MAX_COLS).smem_bytes <= SMEM_NO_OPT_IN
    for Q, G in ((10, 11), (MAX_COLS + 1, 10), (20, 0), (0, 0)):
        with pytest.raises(ValueError, match="G <= Q"):
            hungarian_plan(Q, G)


def test_source_mirrors_the_plan_and_builds_without_fast_math():
    assert "if (Q + 1 <= 32)" in SOURCE
    assert "*smem = (size_t)Q * G * sizeof(float);" in SOURCE
    assert "*smem = (size_t)(G + 1) * 2 * 4 + (size_t)(Q + 1) * 5 * 4;" in SOURCE
    assert re.search(r"enum Route \{ kWarp = 0, kGlobal = 1 \}", SOURCE)
    assert ROUTES == ("warp", "global")
    # within the shared memory a block gets without cudaFuncSetAttribute
    assert "cudaFuncSetAttribute" not in SOURCE
    assert f"kMaxCols = {MAX_COLS}" in SOURCE
    # the build: sm_90a, no fast math, K6 among the kernels
    flags = " ".join(build.NVCC_FLAGS + tuple(HUNGARIAN.flags))
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert "hungarian.cu" in build.KERNEL_SOURCES
    # numpy's arithmetic: rounded adds only, no contracted or approximate ops
    assert not re.search(r"__f(div|mul|ma)|fmaf|__expf|__fdividef", SOURCE)
    assert SOURCE.count("__fsub_rn(__fsub_rn(") == 3  # (cost - u[i0]) - v[j] in each route


# ---------------------------------------------------------------------------
# the argmin key
# ---------------------------------------------------------------------------

SPECIAL = [0.0, -0.0, 1e18, -1e18, 1e5, -1e5, np.inf, -np.inf, np.nan, 1.0, -1.0, 1e-45]
values = st.one_of(st.sampled_from(SPECIAL),
                   st.floats(width=32, allow_nan=True, allow_infinity=True))


def first_min_key(x: np.ndarray) -> int:
    key = order_key(x)
    return int(np.flatnonzero(key == key.min())[0])  # a ballot of the lanes at it, ffs


@settings(max_examples=300, deadline=None)
@given(hnp.arrays(np.float32, st.integers(1, LANES), elements=values))
def test_smallest_key_first_lane_is_argmin(x):
    assert first_min_key(x) == int(np.argmin(x))


@settings(max_examples=200, deadline=None)
@given(hnp.arrays(np.float32, st.integers(1, 8),
                  elements=st.sampled_from([0.0, -0.0, 1e18, 1e5, -1e5, 2.0]),
                  ).map(lambda a: np.tile(a, 5)))
def test_key_ties_repeated_values_and_both_zeros(x):
    assert first_min_key(x) == int(np.argmin(x))


@settings(max_examples=200, deadline=None)
@given(hnp.arrays(np.float32, st.integers(1, MAX_COLS + 1), elements=values))
def test_lane_local_then_warp_argmin_is_argmin(x):
    """Route "global": lane l reduces its columns l, l + 32, ... to its
    first smallest key, then the warp takes the smallest key and, of the
    lanes at it, the lowest column (two reductions)."""
    key = order_key(x)
    n = len(x)
    best = np.full(LANES, IDLE_KEY, np.uint32)
    best_j = np.full(LANES, 0x7FFFFFFF, np.int64)
    for j in range(n):  # ascending j, strict <: each lane's first minimum
        lane = j % LANES
        if key[j] < best[lane]:
            best[lane], best_j[lane] = key[j], j
    kmin = best.min()
    j1 = int(np.where(best == kmin, best_j, 0x7FFFFFFF).min())
    assert j1 == int(np.argmin(x))


def test_key_orders_as_the_floats():
    x = np.array([-np.inf, -1e18, -1e5, -1.0, -1e-45, -0.0, 0.0, 1e-45, 1.0, 1e5, 1e18, np.inf],
                 np.float32)
    key = order_key(x)
    assert (np.diff(key.astype(np.int64)) >= 0).all()
    assert key[5] == key[6] and (np.diff(key.astype(np.int64))[np.arange(11) != 5] > 0).all()
    assert order_key(np.float32(np.nan)) == 0 and (key < IDLE_KEY).all()


# ---------------------------------------------------------------------------
# route "warp", lane by lane
# ---------------------------------------------------------------------------

def warp_route(cost: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """One problem as route "warp" solves it: cost (Q, G) f32, valid (G,)
    bool, Q + 1 <= 32; each array below holds one register of the 32
    lanes, and x[src] is a shuffle from lane src. Returns the (G,) matched
    queries."""
    Q, G = cost.shape
    cs = np.where(valid[:, None], cost.T, np.float32(0.0)).astype(np.float32)  # the staging
    lane = np.arange(LANES)
    col = (lane >= 1) & (lane <= Q)
    u = np.zeros(LANES, np.float32)   # row `lane`'s potential
    v = np.zeros(LANES, np.float32)
    p = np.zeros(LANES, np.int64)     # the row matched to column `lane`
    for i in range(1, G + 1):
        minv = np.full(LANES, INF, np.float32)
        used = np.zeros(LANES, bool)
        visited = np.zeros(LANES, bool)
        way = np.zeros(LANES, np.int64)
        p[0] = i
        j0, i0 = 0, i
        while True:
            used |= lane == j0
            visited |= lane == i0
            ui0 = u[i0]
            c = np.zeros(LANES, np.float32)
            c[col] = cs[i0 - 1, lane[col] - 1]
            cur = (c - ui0) - v
            upd = col & ~used & (cur < minv)
            minv = np.where(upd, cur, minv)
            way = np.where(upd, j0, way)
            masked = np.where(used, INF, minv)
            key = np.where(col, order_key(masked), IDLE_KEY)
            j1 = int(np.flatnonzero(key == key.min())[0])  # redux, ballot, ffs
            delta = masked[j1]
            u = np.where(visited, u + delta, u)
            v = np.where(used, v - delta, v)
            minv = np.where(used, minv, minv - delta)
            j0, i0 = j1, int(p[j1])
            if i0 == 0:
                break
        on_path = np.zeros(LANES, bool)
        j = j0
        while j != 0:  # a shuffle a hop finds the path
            on_path |= lane == j
            j = int(way[j])
        p = np.where(on_path, p[way], p)  # one shuffle: each takes its predecessor's row
    out = np.zeros(G, np.int64)
    matched = col & (p != 0)
    out[p[matched] - 1] = lane[matched] - 1
    return out


MATCHER_CASES = [("flagship", 96, 20, 10, kind) for kind in ("random", "ties", "invalid", "guard")]
MATCHER_CASES += [("square", 96, 10, 10, "random"), ("widest", 24, 31, 31, "ties")]


@pytest.mark.parametrize("case", MATCHER_CASES, ids=lambda c: f"{c[0]}-{c[4]}")
def test_register_route_equals_batched_hungarian(case):
    name, P, Q, G, kind = case
    cost, valid = chip_smoke.matcher_problems(P, Q, G, kind, seed=len(name) + P + Q + G)
    ref = batched_hungarian(cost, valid)
    got = np.stack([warp_route(c, v) for c, v in zip(cost, valid)])
    np.testing.assert_array_equal(got, ref)


def test_register_route_on_zero_signs_and_equal_rows():
    """Costs of -0.0 and +0.0 side by side, and identical query rows: ties
    the key must break as np.argmin does."""
    rng = np.random.default_rng(7)
    cost = rng.integers(0, 2, size=(16, 20, 10)).astype(np.float32)
    cost[cost == 0] = np.where(rng.random(int((cost == 0).sum())) < 0.5, -0.0, 0.0)
    cost[:4] = cost[:4, :1]
    valid = rng.random((16, 10)) < 0.7
    ref = batched_hungarian(cost, valid)
    got = np.stack([warp_route(c, v) for c, v in zip(cost, valid)])
    np.testing.assert_array_equal(got, ref)


def test_bindings_refuse_cpu_tensors_and_the_tool_times_the_flagship():
    import torch

    from multimodal_feature_learning_tpu_torch.config import load_config
    from multimodal_feature_learning_tpu_torch.ops.hungarian import HUNGARIAN_CHAIN
    from multimodal_feature_learning_tpu_torch.tools import msda_device_time

    with pytest.raises(ValueError, match="CUDA tensors"):
        HUNGARIAN(torch.zeros(2, 20, 10), torch.ones(2, 10, dtype=torch.bool))
    with pytest.raises(ValueError, match="on the card"):
        HUNGARIAN_CHAIN(torch.zeros(32), 10)
    assert HUNGARIAN.launches == 0 and HUNGARIAN_CHAIN.launches == 0
    # the tool's K6 case is the flagship's training matching
    assert msda_device_time.K6_CASES == (
        ("hungarian", *chip_smoke.matching_problems(load_config())),)
