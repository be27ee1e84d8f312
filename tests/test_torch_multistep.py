"""K train steps per dispatch and the pipelined epoch loop of the port
against its own single steps and against the JAX package's loop.

At ``_small_cfg`` dims on the CPU, inputs from numpy seeds, the model's
weights drawn from a torch seed, dropout 0.1:

- ``make_train_multistep`` over K = 3 stacked batches equals three calls of
  ``make_train_step`` exactly (metrics, the last step's grad leaf norms and
  params): the same function on the same device;
- ``train_one_epoch`` at ``chunk_k`` 2 over 5 batches (two chunks and a
  ragged tail) equals ``chunk_k`` 1 exactly: steps, stats, logs, params;
- the loop's host side against JAX's ``train_one_epoch`` on scripted
  steps (no model): the step logger's logs and global steps, the step a
  non-finite loss is reported at (JAX prints it and exits, the port raises
  FloatingPointError), and the grad-flow files' names and contents, at
  ``chunk_k`` 1 and 2.

The multi-step's K steps against JAX's (losses, params, matchings) are in
``tests/test_torch_train.py``, which holds them to the JAX run it already
makes."""

from __future__ import annotations

import copy
import json
import math
import os
import re
from collections import namedtuple

import jax
import numpy as np
import pytest
import torch
from torch import nn

from test_torch_common import PAD, VOCAB_SIZE, array_batch, jax_small_cfg, torch_cfg_like

from multimodal_feature_learning_tpu.engine import train as jax_train
from multimodal_feature_learning_tpu.parallel.mesh import make_mesh
from multimodal_feature_learning_tpu_torch.data.anet import synthetic_batches
from multimodal_feature_learning_tpu_torch.engine.state import TrainState, create_train_state
from multimodal_feature_learning_tpu_torch.engine.train import (
    batch_to_device, make_train_multistep, make_train_step, stack_batches, train_one_epoch,
)
from multimodal_feature_learning_tpu_torch.models.criterion import build_criterion
from multimodal_feature_learning_tpu_torch.models.dvc import build_model

K = 3
STEPS_PER_EPOCH = 10


@pytest.fixture(scope="module")
def port_parts():
    """The small config (context mask on, dropout 0.1), the port's model
    with weights from torch seed 0, its criterion and weights."""
    tcfg = torch_cfg_like(jax_small_cfg(use_differentiable_mask=True))
    model = build_model(tcfg, VOCAB_SIZE, PAD, device="cpu", seed=0)
    criterion, weight_dict = build_criterion(tcfg, PAD)
    return tcfg, model, criterion, weight_dict


def test_multistep_equals_single_steps(port_parts):
    tcfg, model, criterion, weight_dict = port_parts
    assert tcfg.dvc.detr.transformer_dropout_prob == 0.1
    batches = [array_batch(tcfg, 4, seed=s) for s in range(K)]

    single = create_train_state(tcfg, copy.deepcopy(model), STEPS_PER_EPOCH)
    step = make_train_step(criterion, weight_dict, seed=5)
    want = [step(single, batch_to_device(b, "cpu"), leaf_norms=i == K - 1)
            for i, b in enumerate(batches)]

    multi = create_train_state(tcfg, copy.deepcopy(model), STEPS_PER_EPOCH)
    got = make_train_multistep(criterion, weight_dict, seed=5)(
        multi, batch_to_device(stack_batches(batches), "cpu"), leaf_norms=True)

    assert multi.step == single.step == K
    assert got["lr"] == [m["lr"] for m in want]
    norms = got.pop("grad_leaf_norms")
    assert norms.keys() == want[-1]["grad_leaf_norms"].keys()
    assert all(torch.equal(v, want[-1]["grad_leaf_norms"][k]) for k, v in norms.items())
    assert set(got) == set(want[0]) - {"grad_leaf_norms"}
    for k, v in got.items():
        if k != "lr":
            assert v.shape == (K,) and torch.equal(v, torch.stack([m[k] for m in want])), k
    assert len({float(m["loss"]) for m in want}) == K
    for (n, p), q in zip(single.model.named_parameters(), multi.model.parameters()):
        assert torch.equal(p, q), n


def test_chunked_epoch_equals_single_steps(port_parts):
    """5 batches at chunk_k 2 (two chunks of 2, a tail of 1) and at
    chunk_k 1: the same steps, logs, stats and params, bit for bit."""
    tcfg, model, criterion, weight_dict = port_parts
    batches = list(synthetic_batches(tcfg, 2, VOCAB_SIZE, seed=3, num_batches=5))
    runs = {}
    for chunk_k in (1, 2):
        state = create_train_state(tcfg, copy.deepcopy(model), STEPS_PER_EPOCH)
        logs = []
        state, stats = train_one_epoch(
            make_train_step(criterion, weight_dict, seed=7), state, batches, epoch=0,
            print_freq=0, step_logger=lambda log, step: logs.append((step, log)),
            multi_step=make_train_multistep(criterion, weight_dict, seed=7), chunk_k=chunk_k)
        runs[chunk_k] = (state, stats, logs)
    (s1, stats1, logs1), (s2, stats2, logs2) = runs[1], runs[2]
    assert s1.step == s2.step == 5
    assert [s for s, _ in logs2] == [1, 2, 3, 4, 5] and logs2 == logs1
    assert stats2 == stats1 and math.isfinite(stats1["loss"])
    for (n, p), q in zip(s1.model.named_parameters(), s2.model.parameters()):
        assert torch.equal(p, q), n


# -- the loop's host side against JAX's, on scripted steps ---------------------

LR = 2.0 ** -10  # exact in f32, as JAX hands the lr over
N_BATCHES, FREQ = 7, 3
JaxState = namedtuple("JaxState", "step")


def scripted(step: int, nan_at) -> dict:
    """The metrics of global step ``step`` (0-based): two logged terms, two
    auxiliary ones, a loss that is NaN at ``nan_at``."""
    loss = float("nan") if step == nan_at else 1.0 + 0.25 * step
    return {"loss": loss, "loss_bbox": 0.5 * step, "loss_bbox_0": 9.0,
            "loss_giou_enc_0": 3.0, "grad_norm": 0.125 * step}


def run_jax_loop(chunk_k, nan_at, grad_dir, capsys):
    def one(state, arrays, rng):
        m = {k: np.float32(v) for k, v in scripted(state.step, nan_at).items()}
        m["lr"] = np.float32(LR)
        return JaxState(state.step + 1), m, {"enc": {"w": np.float32(state.step)}}

    def multi(state, stacked, rng):
        n = len(stacked["video_tensor"])
        rows = [scripted(state.step + i, nan_at) for i in range(n)]
        m = {k: np.asarray([r[k] for r in rows], np.float32) for k in rows[0]}
        m["lr"] = np.full(n, LR, np.float32)
        return JaxState(state.step + n), m, {"enc": {"w": np.float32(state.step + n - 1)}}

    batches = [{"video_tensor": np.zeros((2, 3), np.float32)} for _ in range(N_BATCHES)]
    logs, stop = [], None
    try:
        jax_train.train_one_epoch(
            None, None, None, one, JaxState(0), batches, make_mesh(1, 1, jax.devices()[:1]),
            None, 0, print_freq=100, grad_flow_dir=str(grad_dir), grad_flow_freq=FREQ,
            step_logger=lambda log, step: logs.append((step, log)),
            multi_step=multi, chunk_k=chunk_k)
    except SystemExit:
        said = re.search(r"Loss is nan at epoch 0 step (\d+) \(global (\d+)\)",
                         capsys.readouterr().out)
        stop = (int(said.group(1)), int(said.group(2)))
    return logs, stop


def run_port_loop(chunk_k, nan_at, grad_dir):
    def one(state, batch, leaf_norms=False):
        m = {k: torch.tensor(v) for k, v in scripted(state.step, nan_at).items()}
        m["lr"] = LR
        if leaf_norms:
            m["grad_leaf_norms"] = {"enc||w": torch.tensor(float(state.step))}
        state.step += 1
        return m

    def multi(state, stacked, leaf_norms=False):
        n = len(stacked["video_tensor"])
        rows = [scripted(state.step + i, nan_at) for i in range(n)]
        m = {k: torch.tensor([r[k] for r in rows]) for k in rows[0]}
        m["lr"] = [LR] * n
        if leaf_norms:
            m["grad_leaf_norms"] = {"enc||w": torch.tensor(float(state.step + n - 1))}
        state.step += n
        return m

    batches = [{"video_tensor": np.zeros((2, 3), np.float32)} for _ in range(N_BATCHES)]
    logs, stop = [], None
    state = TrainState(step=0, model=nn.Linear(1, 1), optimizer=None)
    try:
        train_one_epoch(one, state, batches, 0, print_freq=0,
                        step_logger=lambda log, step: logs.append((step, log)),
                        grad_flow_dir=str(grad_dir), grad_flow_freq=FREQ,
                        multi_step=multi, chunk_k=chunk_k)
    except FloatingPointError as e:
        said = re.search(r"loss is nan at epoch 0 step (\d+) \(global (\d+)\)", str(e))
        stop = (int(said.group(1)), int(said.group(2)))
    return logs, stop


def grad_files(d):
    if not os.path.isdir(d):
        return {}
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name)) as f:
            out[name] = json.load(f)
    return out


@pytest.mark.parametrize("nan_at", [None, 2, 5], ids=["finite", "nan_at_2", "nan_at_5"])
@pytest.mark.parametrize("chunk_k", [1, 2])
def test_loop_host_side_follows_jax(chunk_k, nan_at, tmp_path, capsys):
    ref_logs, ref_stop = run_jax_loop(chunk_k, nan_at, tmp_path / "jax", capsys)
    got_logs, got_stop = run_port_loop(chunk_k, nan_at, tmp_path / "port")
    assert got_stop == ref_stop
    if nan_at is None:
        assert got_stop is None and [s for s, _ in got_logs] == list(range(1, N_BATCHES + 1))
    else:
        assert got_stop == (nan_at, nan_at + 1)
    assert got_logs == ref_logs
    assert all(set(log) == {"loss", "loss_bbox", "grad_norm", "lr"} for _, log in got_logs)
    files = grad_files(tmp_path / "port")
    assert files == grad_files(tmp_path / "jax")
    if nan_at is None:
        want = ["grads_e000_s00000.json", "grads_e000_s00003.json", "grads_e000_s00006.json"] \
            if chunk_k == 1 else \
            ["grads_e000_s00001.json", "grads_e000_s00003.json", "grads_e000_s00006.json"]
        assert list(files) == want
        assert [f["enc/w"] for f in files.values()] == [float(n[-10:-5]) for n in want]
