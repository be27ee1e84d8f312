"""The port's Hungarian matcher against the JAX package's.

``ops/hungarian.py`` is a numpy copy of the JAX algorithm run on the host;
its indices must equal JAX's ``batched_hungarian`` on every slot, invalid
slots and ties included (identical query rows are common early in
training). scipy's ``linear_sum_assignment`` is the optimality oracle only:
on tied costs it may pick another optimal matching. ``models/matcher.py``
builds the cost 5 L1 - 2 gIoU on the model's device; its indices must equal
JAX's ``hungarian_match``. ``batched_hungarian_torch``, the tensor-facing
wrapper that sends a CUDA cost to the K6 kernel, takes the numpy version
for a CPU cost: its indices must equal JAX's too, as int64 on the cost's
device; the kernel's binding refuses what it does not take.""" 

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from multimodal_feature_learning_tpu.models.matcher import hungarian_match as jax_match
from multimodal_feature_learning_tpu.ops.hungarian import batched_hungarian as jax_lsap
from multimodal_feature_learning_tpu.ops.segment_ops import generalized_box_iou as jax_giou
from multimodal_feature_learning_tpu_torch.models.matcher import hungarian_match, match_cost
from multimodal_feature_learning_tpu_torch.ops import build
from multimodal_feature_learning_tpu_torch.ops.hungarian import (
    HUNGARIAN, MAX_COLS, batched_hungarian, batched_hungarian_torch, hungarian,
)
from multimodal_feature_learning_tpu_torch.ops.segment_ops import box_iou, generalized_box_iou


def random_problems(n, Q=20, G=10, seed=0):
    rng = np.random.default_rng(seed)
    cost = rng.normal(size=(n, Q, G)).astype(np.float32)
    cost[: n // 10] = np.round(cost[: n // 10])  # many ties
    valid = rng.random((n, G)) < 0.6
    valid[np.arange(n), rng.integers(0, G, n)] = True
    return cost, valid


@pytest.mark.parametrize("shape", [(20, 10), (6, 4), (10, 10)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_indices_equal_jax_on_random_problems(shape):
    Q, G = shape
    cost, valid = random_problems(150, Q, G, seed=Q + G)
    got = batched_hungarian(cost, valid)
    ref = np.asarray(jax_lsap(jnp.asarray(cost), jnp.asarray(valid)))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", ["all_equal", "identical_rows", "zero_valid_but_one"])
def test_indices_equal_jax_on_ties(case):
    n, Q, G = 8, 20, 10
    rng = np.random.default_rng(1)
    if case == "all_equal":
        cost = np.ones((n, Q, G), np.float32)
    else:
        cost = np.repeat(rng.normal(size=(n, 1, G)).astype(np.float32), Q, axis=1)
    valid = np.ones((n, G), bool) if case != "zero_valid_but_one" else np.eye(G, dtype=bool)[:n]
    got = batched_hungarian(cost, valid)
    ref = np.asarray(jax_lsap(jnp.asarray(cost), jnp.asarray(valid)))
    np.testing.assert_array_equal(got, ref)


def test_matching_is_optimal_against_scipy():
    cost, valid = random_problems(120, seed=3)
    got = batched_hungarian(cost, valid)
    for c, v, idx in zip(cost, valid, got):
        cols = np.nonzero(v)[0]
        rows = idx[cols]
        assert len(set(rows.tolist())) == len(rows)  # one query per GT slot
        r, cc = linear_sum_assignment(c[:, cols])
        np.testing.assert_allclose(c[rows, cols].sum(), c[r, cols[cc]].sum(), rtol=1e-5,
                                   atol=1e-5)


def test_single_problem_col_to_row():
    c = np.array([[4, 1, 3], [2, 5, 6]], np.float32)  # 2 rows, 3 columns
    np.testing.assert_array_equal(hungarian(c[None])[0], [1, 0, -1])


def segments(rng, shape):
    c = rng.uniform(0.05, 0.95, size=shape)
    l = rng.uniform(0.01, 0.6, size=shape)
    return np.stack([c, l], -1).astype(np.float32)


def test_hungarian_match_equals_jax():
    rng = np.random.default_rng(4)
    B, Q, G = 12, 20, 10
    pred = segments(rng, (B, Q))
    pred[:3] = pred[:3, :1]  # identical query rows
    pred[3, :, 1] = 0.0      # zero-length predictions
    gt = segments(rng, (B, G))
    mask = rng.random((B, G)) < 0.6
    mask[:, 0] = True
    gt = gt * mask[..., None]
    got = hungarian_match(torch.from_numpy(pred), torch.from_numpy(gt), torch.from_numpy(mask))
    ref = np.asarray(jax_match(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(mask)))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)


def test_cost_and_giou_match_jax():
    rng = np.random.default_rng(5)
    a, b = segments(rng, (3, 7)), segments(rng, (3, 5))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    xy = lambda s: torch.stack([s[..., 0] - s[..., 1] / 2, s[..., 0] + s[..., 1] / 2], -1)
    got = generalized_box_iou(xy(ta), xy(tb)).numpy()
    ref = np.stack([np.asarray(jax_giou(jnp.asarray(xy(ta)[i].numpy()),
                                        jnp.asarray(xy(tb)[i].numpy()))) for i in range(3)])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    iou, _ = box_iou(xy(ta), xy(tb))
    assert ((iou >= 0) & (iou <= 1)).all()
    cost = match_cost(ta, tb)
    assert cost.shape == (3, 7, 5) and torch.isfinite(cost).all()


def flagship_problems(seed=6):
    """96 problems (6 decoder layers x batch 16) of 20 queries x 10 GT
    slots, the flagship's train and eval shape: random costs, integer
    costs full of ties, identical query rows, the 1e5 / -1e5 values of
    ``match_cost``'s guard, and problems with one valid slot only."""
    cost, valid = random_problems(96, seed=seed)
    rng = np.random.default_rng(seed)
    cost[10:20] = rng.integers(0, 3, size=(10, 20, 10))
    cost[20:24] = cost[20:24, :1]
    cost[24, 3], cost[25, :, 2], cost[26, 5, 5] = 1e5, -1e5, 1e5
    valid[30:34] = False
    valid[30:34, 0] = True
    return cost, valid


def test_torch_wrapper_on_cpu_equals_jax():
    cost, valid = flagship_problems()
    got = batched_hungarian_torch(torch.from_numpy(cost), torch.from_numpy(valid))
    ref = np.asarray(jax_lsap(jnp.asarray(cost), jnp.asarray(valid)))
    assert got.dtype == torch.int64 and got.device.type == "cpu" and got.shape == (96, 10)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_search_steps_count_the_work():
    """``search_steps`` gets each problem's search steps: n for a problem
    whose rows all find a free column at once, at most n (n + 1) / 2."""
    cost, valid = flagship_problems()
    steps = []
    batched_hungarian(cost, valid, search_steps=steps)
    (per_problem,) = steps
    assert per_problem.shape == (96,) and (per_problem >= 10).all()
    assert (per_problem <= 55).all()
    diagonal = -np.eye(10, 20, dtype=np.float32)[None]
    steps = []
    hungarian(diagonal, search_steps=steps)
    assert steps[0].tolist() == [10]


def test_kernel_binding_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        HUNGARIAN(torch.zeros(2, 20, 10), torch.ones(2, 10, dtype=torch.bool))
    assert HUNGARIAN.launches == 0
    assert "hungarian.cu" in build.KERNEL_SOURCES and MAX_COLS >= 1024
