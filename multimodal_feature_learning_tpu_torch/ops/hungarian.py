"""Exact linear-sum assignment: the batched matcher kernel (K6,
``csrc/hungarian.cu``) and its plain version in numpy; counterpart of the
JAX ``ops/hungarian.py``.

``batched_hungarian_torch`` takes the cost where it lies: a CUDA tensor goes
to K6 (one launch for every problem, no host synchronisation) or raises, a
CPU tensor to the numpy version. Both follow the JAX package's algorithm:
the e-maxx formulation of the O(n^3) potentials and shortest-augmenting-path
method, in f32, solved transposed (the GT slots are the rows), with
invalid GT slots as zero-cost rows and the same argmax inversion.
``jax.vmap`` runs the problems of a batch in lockstep; the numpy version
runs them together as rows of numpy arrays, each problem's loops stepping
only while that problem is still searching, so every problem takes the same
steps as it would alone and the indices equal the JAX package's on every
slot, ties and invalid slots included; K6 gives each problem a warp of its
own and repeats numpy's arithmetic, so its indices equal numpy's.
(``scipy.optimize.linear_sum_assignment`` is another algorithm: on tied
costs it may pick another optimal matching.)

K6 runs one of two routes, which ``hungarian_plan`` picks from (Q, G)
alone: "warp" where Q + 1 <= 32 (the cost staged in shared memory, a lane
a column, the state in registers) and "global" above that (the state in
shared memory, the cost read from device memory). ``order_key`` is the
numpy mirror of the kernel's argmin key.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .build import KernelBinding

_INF = np.float32(1e18)
MAX_COLS = 1024  # K6 takes up to this many queries (columns of the solve)
SMEM_NO_OPT_IN = 48 * 1024  # dynamic shared memory a block gets without asking
ROUTES = ("warp", "global")  # the launcher's route codes 0, 1


@dataclass(frozen=True)
class HungarianPlan:
    """How K6 runs on Q queries x G GT slots: its ``route`` (one warp and
    one block a problem on both) and the dynamic shared memory a block asks
    for."""
    route: str
    smem_bytes: int


@functools.lru_cache(maxsize=None)
def hungarian_plan(Q: int, G: int) -> HungarianPlan:
    """K6's plan for problems of ``Q`` queries x ``G`` GT slots, as the
    launcher computes it (``csrc/hungarian.cu::plan_route``). Route "warp"
    where Q + 1 <= 32: the column state in registers, the Q x G cost staged
    in shared memory. Otherwise route "global": the state in shared memory
    (u and the rows' validity G + 1 words each, v, minv, p, way and used
    Q + 1 each), the cost read from device memory. Both stay within
    SMEM_NO_OPT_IN. Raises ValueError outside K6's contract,
    1 <= G <= Q <= MAX_COLS."""
    if not 1 <= G <= Q <= MAX_COLS:
        raise ValueError(f"the hungarian kernel takes 1 <= G <= Q <= {MAX_COLS} "
                         f"(GT slots <= queries), got Q={Q} G={G}")
    if Q + 1 <= 32:
        return HungarianPlan("warp", Q * G * 4)
    return HungarianPlan("global", 2 * (G + 1) * 4 + 5 * (Q + 1) * 4)


def order_key(x: np.ndarray) -> np.ndarray:
    """The kernel's argmin key (``csrc/hungarian.cu::order_key``) of f32
    values, as uint32: ordered as the floats are, -0.0 and +0.0 one key
    (adding +0.0 makes -0.0 +0.0), every NaN the smallest (np.argmin takes
    the first NaN). The first index of the smallest key is np.argmin's."""
    z = np.asarray(x, np.float32) + np.float32(0.0)
    b = z.view(np.uint32)
    key = np.where(b & np.uint32(0x80000000), ~b, b | np.uint32(0x80000000))
    return np.where(np.isnan(z), np.uint32(0), key).astype(np.uint32)


def hungarian(cost: np.ndarray, search_steps: Optional[list] = None) -> np.ndarray:
    """Solve LSAP for a batch of problems, cost (P, n, m) with n <= m.
    Returns col_to_row (P, m) int32: the row matched to each column, -1 for
    an unmatched column. Minimises the sum of cost[row, col] over a full
    matching of all n rows. With ``search_steps`` (a list), the number of
    search steps each problem took, (P,) int64, is appended to it: the
    work of the solve, which depends on the data."""
    cost = np.asarray(cost, dtype=np.float32)
    nP, n, m = cost.shape
    if n > m:
        raise ValueError("hungarian expects n_rows <= n_cols; transpose first")
    ar = np.arange(nP)
    col = ar[:, None]
    # 1-indexed potentials and matching with a dummy slot 0: p[j] is the row
    # (1..n) matched to column j (0 = unmatched), j in 0..m. A problem that
    # has stopped searching takes no updates (delta 0, masks off), as a
    # vmapped while_loop leaves a finished element unchanged.
    u = np.zeros((nP, n + 1), np.float32)
    v = np.zeros((nP, m + 1), np.float32)
    p = np.zeros((nP, m + 1), np.int64)
    zero = np.float32(0.0)
    steps = np.zeros(nP, np.int64)
    for i in range(n):
        p[:, 0] = i + 1
        minv = np.full((nP, m + 1), _INF, np.float32)
        used = np.zeros((nP, m + 1), bool)
        way = np.zeros((nP, m + 1), np.int64)
        j0 = np.zeros(nP, np.int64)
        i0 = p[ar, j0]
        while True:
            act = i0 != 0
            if not act.any():
                break
            steps += act
            used[ar, j0] |= act
            cur = cost[ar, np.maximum(i0 - 1, 0)] - u[ar, i0][:, None] - v[:, 1:]
            upd = (cur < minv[:, 1:]) & ~used[:, 1:] & act[:, None]
            minv[:, 1:] = np.where(upd, cur, minv[:, 1:])
            way[:, 1:] = np.where(upd, j0[:, None], way[:, 1:])
            masked = np.where(used[:, 1:], _INF, minv[:, 1:])
            j1 = np.argmin(masked, axis=1) + 1
            delta = np.where(act, masked[ar, j1 - 1], zero)
            shift = used & act[:, None]
            # u[p[j]] += delta on the used columns: their rows are distinct,
            # and every other entry adds 0 (to row 0 or an unused row)
            u[col, p] += np.where(shift, delta[:, None], zero)
            u[:, 0] = 0.0
            v = np.where(shift, v - delta[:, None], v)
            minv = np.where(used, minv, minv - delta[:, None])
            j0 = np.where(act, j1, j0)
            i0 = p[ar, j0]
        # augment: walk `way` back to the dummy column
        while True:
            act = j0 != 0
            if not act.any():
                break
            j1 = np.where(act, way[ar, j0], 0)
            p[ar, j0] = np.where(act, p[ar, j1], p[ar, j0])
            j0 = j1
    if search_steps is not None:
        search_steps.append(steps)
    return (p[:, 1:] - 1).astype(np.int32)


def batched_hungarian(cost: np.ndarray, col_valid: np.ndarray,
                      search_steps: Optional[list] = None) -> np.ndarray:
    """Batched rectangular LSAP with column validity.

    cost (B, n_rows, n_cols), n_cols <= n_rows (queries x padded GT);
    col_valid (B, n_cols) bool. Returns (B, n_cols) int32: for each column
    (GT slot) the matched row (query). Entries of invalid columns are what
    the JAX package gives there; mask them with col_valid. ``search_steps``
    as in ``hungarian``."""
    cost = np.asarray(cost, dtype=np.float32)
    B, n_rows, n_cols = cost.shape
    if n_cols > n_rows:
        raise ValueError("batched_hungarian expects n_cols <= n_rows")
    cost_t = np.swapaxes(cost, 1, 2)
    cost_t = np.where(np.asarray(col_valid, bool)[:, :, None], cost_t, np.float32(0.0))
    p = hungarian(cost_t, search_steps)  # (B, n_rows): query j -> GT slot or -1
    match = p[:, None, :] == np.arange(n_cols)[None, :, None]  # (B, G, Q)
    return np.argmax(match, axis=-1).astype(np.int32)


class HungarianKernel(KernelBinding):
    """``hungarian_launch`` (K6): cost (P, Q, G) f32 and col_valid (P, G)
    bool, contiguous on the card, 1 <= G <= Q <= ``MAX_COLS``; returns the
    (P, G) int64 matched queries."""

    source, symbol = "hungarian.cu", "hungarian_launch"
    replaces = "multimodal_feature_learning_tpu/ops/hungarian.py:26"  # lax loops, no Pallas
    # hungarian_launch(cost, valid, out, P, Q, G, route, stream)
    argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

    def __call__(self, cost: torch.Tensor, col_valid: torch.Tensor) -> torch.Tensor:
        dev = cost.device
        if dev.type != "cuda":
            raise ValueError(f"the hungarian kernel takes CUDA tensors, got {dev}")
        if cost.dim() != 3 or cost.dtype != torch.float32 or not cost.is_contiguous():
            raise ValueError(f"cost must be a contiguous float32 (P, Q, G) tensor, got "
                             f"{cost.dtype} {tuple(cost.shape)}")
        P, Q, G = cost.shape
        if col_valid.shape != (P, G) or col_valid.dtype != torch.bool \
                or col_valid.device != dev or not col_valid.is_contiguous():
            raise ValueError(f"col_valid must be a contiguous bool ({P}, {G}) tensor on "
                             f"{dev}, got {col_valid.dtype} "
                             f"{tuple(col_valid.shape)} on {col_valid.device}")
        out = torch.empty((P, G), dtype=torch.int64, device=dev)
        if out.numel() == 0 and G <= Q <= MAX_COLS:
            return out  # no problems, or no GT slots: nothing to launch
        plan = hungarian_plan(Q, G)  # raises outside the contract
        fn = self._launcher()
        with torch.cuda.device(dev):
            rc = fn(cost.data_ptr(), col_valid.data_ptr(), out.data_ptr(), P, Q, G,
                    ROUTES.index(plan.route), torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"hungarian_launch failed with CUDA error {rc} "
                               f"(P={P} Q={Q} G={G}, {plan})")
        self.launches += 1
        return out


class HungarianChain(KernelBinding):
    """``hungarian_chain_launch``: one warp through ``steps`` dependent
    search steps of route "warp"'s chain and nothing else, into ``sink``
    (32 f32 on the card). Its time over the steps is the latency of one
    step's chain; the matcher never launches it."""

    source, symbol = "hungarian.cu", "hungarian_chain_launch"
    argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]

    def __call__(self, sink: torch.Tensor, steps: int) -> None:
        if sink.device.type != "cuda" or sink.dtype != torch.float32 or sink.numel() < 32:
            raise ValueError("the chain probe takes 32 float32 on the card")
        with torch.cuda.device(sink.device):
            rc = self._launcher()(sink.data_ptr(), steps,
                                  torch.cuda.current_stream(sink.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"hungarian_chain_launch failed with CUDA error {rc}")
        self.launches += 1


HUNGARIAN = HungarianKernel()
HUNGARIAN_CHAIN = HungarianChain()


def batched_hungarian_torch(cost: torch.Tensor, col_valid: torch.Tensor) -> torch.Tensor:
    """``batched_hungarian`` on tensors: cost (B, n_rows, n_cols) (queries x
    padded GT), col_valid (B, n_cols) -> (B, n_cols) int64 on the cost's
    device. A CUDA cost goes to K6, a CPU cost to the numpy version."""
    if cost.device.type == "cpu":
        idx = batched_hungarian(cost.detach().float().numpy(), col_valid.numpy())
        return torch.from_numpy(idx.astype(np.int64))
    # the kernel only reads the cost: no detach, and no copy where it is
    # already f32 and contiguous
    if cost.dtype != torch.float32 or not cost.is_contiguous():
        cost = cost.float().contiguous()
    if col_valid.dtype != torch.bool or not col_valid.is_contiguous():
        col_valid = col_valid.bool().contiguous()
    return HUNGARIAN(cost, col_valid)
