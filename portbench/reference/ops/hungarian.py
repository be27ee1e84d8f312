"""The Hungarian matcher of the plain reference: a frozen copy of the numpy
solver of the port's ``ops/hungarian.py`` (``order_key``, ``hungarian``,
``batched_hungarian``), which the port's K6 kernel equals on every slot,
ties included. A cost on any device is solved on the host."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_INF = np.float32(1e18)

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


def batched_hungarian_torch(cost: torch.Tensor, col_valid: torch.Tensor) -> torch.Tensor:
    """``batched_hungarian`` on tensors: cost (B, n_rows, n_cols), col_valid
    (B, n_cols) -> (B, n_cols) int64 on the cost's device, solved on the
    host."""
    idx = batched_hungarian(cost.detach().float().cpu().numpy(), col_valid.cpu().numpy())
    return torch.from_numpy(idx.astype(np.int64)).to(cost.device)
