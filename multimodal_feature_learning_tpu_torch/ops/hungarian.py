"""Exact linear-sum assignment on the host, in numpy; counterpart of the JAX
``ops/hungarian.py``.

The same algorithm as the JAX package's: the e-maxx formulation of the
O(n^3) potentials and shortest-augmenting-path method, in f32, solved
transposed (the GT slots are the rows), with invalid GT slots as
zero-cost rows and the same argmax inversion. ``jax.vmap`` runs the
problems of a batch in lockstep; here they run together as rows of numpy
arrays, each problem's loops stepping only while that problem is still
searching, so every problem takes the same steps as it would alone and the
indices equal the JAX package's on every slot, ties and invalid slots
included. (``scipy.optimize.linear_sum_assignment`` is another algorithm: on
tied costs it may pick another optimal matching.)
"""

from __future__ import annotations

import numpy as np

_INF = np.float32(1e18)


def hungarian(cost: np.ndarray) -> np.ndarray:
    """Solve LSAP for a batch of problems, cost (P, n, m) with n <= m.
    Returns col_to_row (P, m) int32: the row matched to each column, -1 for
    an unmatched column. Minimises the sum of cost[row, col] over a full
    matching of all n rows."""
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
    return (p[:, 1:] - 1).astype(np.int32)


def batched_hungarian(cost: np.ndarray, col_valid: np.ndarray) -> np.ndarray:
    """Batched rectangular LSAP with column validity.

    cost (B, n_rows, n_cols), n_cols <= n_rows (queries x padded GT);
    col_valid (B, n_cols) bool. Returns (B, n_cols) int32: for each column
    (GT slot) the matched row (query). Entries of invalid columns are what
    the JAX package gives there; mask them with col_valid."""
    cost = np.asarray(cost, dtype=np.float32)
    B, n_rows, n_cols = cost.shape
    if n_cols > n_rows:
        raise ValueError("batched_hungarian expects n_cols <= n_rows")
    cost_t = np.swapaxes(cost, 1, 2)
    cost_t = np.where(np.asarray(col_valid, bool)[:, :, None], cost_t, np.float32(0.0))
    p = hungarian(cost_t)  # (B, n_rows): query j -> GT slot or -1
    match = p[:, None, :] == np.arange(n_cols)[None, :, None]  # (B, G, Q)
    return np.argmax(match, axis=-1).astype(np.int32)
