"""The bf16 fold of the master params (``cfg.master_dtype = "bfloat16"``)
and resume across master dtypes, as the JAX package's
``engine/state.py::create_train_state`` / ``load_checkpoint`` and
``tests/test_master_fold_resume.py`` hold them.

A fold puts every float param, and so both AdamW moments, in bf16; integer
and bool tensors pass through. An f32 checkpoint resumed into a fold comes
back as its values rounded to bf16 (the fold applies after the restore), a
folded checkpoint resumed with f32 masters as its bf16 values widened
exactly, and a checkpoint resumed into its own dtype exactly. Then one
train step of the small DVC model with the fold and bf16 compute: finite,
bf16 gradients on the bf16 masters, an f32 global norm, moments in bf16.
Last, the training CLI, inference and the serving CLI in bf16, with the
fold and a resume across master dtypes, through their config overrides."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch
from torch import nn

from test_torch_common import PAD, build_jax_model, build_port_model, jax_small_cfg, \
    torch_cfg_like

from multimodal_feature_learning_tpu_torch.config import Config
from multimodal_feature_learning_tpu_torch.data.anet import synthetic_batches
from multimodal_feature_learning_tpu_torch.engine.state import (
    create_train_state, load_checkpoint, save_checkpoint,
)
from multimodal_feature_learning_tpu_torch.engine.train import batch_to_device, make_train_step
from multimodal_feature_learning_tpu_torch.models.criterion import build_criterion


class Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.arange(12, dtype=torch.float32).reshape(3, 4) / 7.0)
        self.b = nn.Parameter(torch.ones(4))
        self.register_buffer("steps", torch.tensor(3, dtype=torch.int32))


def tiny_state(master_dtype="float32"):
    cfg = Config()
    cfg.master_dtype = master_dtype
    return create_train_state(cfg, Tiny(), steps_per_epoch=1)


def step(state):
    """One optimizer step of a fixed gradient, so the moments exist."""
    for p in state.model.parameters():
        p.grad = torch.full_like(p, 0.5)
    norm, _ = state.optimizer.step(state.step)
    state.step += 1
    return norm


def moments(state):
    return [v for s in state.optimizer.adamw.state.values() for k, v in s.items()
            if k in ("exp_avg", "exp_avg_sq")]


def test_fold_puts_params_and_adamw_moments_in_bf16():
    state = tiny_state("bfloat16")
    assert state.model.w.dtype == state.model.b.dtype == torch.bfloat16
    assert state.model.steps.dtype == torch.int32
    norm = step(state)
    assert norm.dtype == torch.float32
    assert len(moments(state)) == 4 and all(m.dtype == torch.bfloat16 for m in moments(state))
    assert all(p.dtype == torch.bfloat16 for p in state.model.parameters())
    f32 = tiny_state()
    step(f32)
    assert all(p.dtype == torch.float32 for p in f32.model.parameters())
    assert all(m.dtype == torch.float32 for m in moments(f32))


def test_resume_f32_checkpoint_with_bf16_fold(tmp_path):
    state32 = tiny_state()
    step(state32)
    path = save_checkpoint(str(tmp_path), state32, epoch=5)
    state16 = tiny_state("bfloat16")
    assert load_checkpoint(path, state16) == 5
    assert state16.step == 1 and state16.model.steps.dtype == torch.int32
    for p16, p32 in zip(state16.model.parameters(), state32.model.parameters()):
        assert p16.dtype == torch.bfloat16
        assert torch.equal(p16, p32.detach().to(torch.bfloat16))
    for m16, m32 in zip(moments(state16), moments(state32)):
        assert m16.dtype == torch.bfloat16 and torch.equal(m16, m32.to(torch.bfloat16))
    step(state16)  # the resumed fold trains on
    assert all(p.dtype == torch.bfloat16 for p in state16.model.parameters())


def test_resume_bf16_checkpoint_with_f32_masters(tmp_path):
    state16 = tiny_state("bfloat16")
    step(state16)
    path = save_checkpoint(str(tmp_path), state16, epoch=2)
    state32 = tiny_state()
    assert load_checkpoint(path, state32) == 2
    for p32, p16 in zip(state32.model.parameters(), state16.model.parameters()):
        assert p32.dtype == torch.float32
        assert torch.equal(p32, p16.detach().float())  # bf16 values, widened exactly
    assert all(m.dtype == torch.float32 for m in moments(state32))


def test_matched_master_dtype_still_exact(tmp_path):
    state32 = tiny_state()
    step(state32)
    path = save_checkpoint(str(tmp_path), state32, epoch=1)
    again = tiny_state()
    load_checkpoint(path, again)
    for a, b in zip(again.model.parameters(), state32.model.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_folded_train_step_of_the_model(compute_dtype):
    """The small DVC model with folded masters, in bf16 and in f32 compute
    (the f32 forward then runs over f32 copies of the bf16 masters): a
    finite step, bf16 gradients on the bf16 masters, an f32 grad norm and
    bf16 moments."""
    jcfg = jax_small_cfg()
    jcfg.compute_dtype = compute_dtype
    _, params = build_jax_model(jcfg)
    model = build_port_model(jcfg, params)
    cfg = torch_cfg_like(jcfg)
    cfg.master_dtype = "bfloat16"
    state = create_train_state(cfg, model, steps_per_epoch=10)
    criterion, weight_dict = build_criterion(cfg, PAD)
    batch = next(synthetic_batches(cfg, 2, 40, seed=0))
    metrics = make_train_step(criterion, weight_dict, seed=0)(
        state, batch_to_device(batch, "cpu"))
    assert np.isfinite(float(metrics["loss"]))
    assert metrics["grad_norm"].dtype == torch.float32 and float(metrics["grad_norm"]) > 0
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    assert grads and all(g.dtype == torch.bfloat16 for g in grads)
    assert moments(state) and all(m.dtype == torch.bfloat16 for m in moments(state))


def test_the_entry_points_run_in_bf16(tmp_path):
    """The training CLI with ``compute_dtype`` and ``master_dtype``
    "bfloat16" from its config overrides (a small synthetic world, the
    dims of ``tests/test_cli_drivers.py``), then its folded checkpoint
    resumed with f32 masters, then ``inference.main`` and the serving CLI,
    static and continuous, on that checkpoint in bf16: finite losses and
    scores, and every answer given."""
    from test_cli_drivers import TINY

    from multimodal_feature_learning_tpu_torch import inference, serve
    from multimodal_feature_learning_tpu_torch import main as port_main
    from multimodal_feature_learning_tpu_torch.config import apply_overrides

    dims = [o for o in TINY if not o.startswith("print_freq")]
    cfg = port_main.make_synthetic_world(apply_overrides(Config(), dims), str(tmp_path / "anet"))
    anet = cfg.dataset.activity_net
    over = ["--config-overrides", *dims, "print_freq=0", "dataset.activity_net.train_subset=8",
            "dataset.activity_net.val_subset=4",
            f"dataset.activity_net.anet_path={anet.anet_path}",
            f"dataset.activity_net.video_features_file={anet.video_features_file}",
            f"dataset.activity_net.vocab_file_path={tmp_path / 'vocab.pkl'}"]
    out = str(tmp_path / "run")
    common = ["--device", "cpu", "--batch-size", "4", "--output-dir", out]
    folded = port_main.main([*common, "--epochs", "1", *over, "compute_dtype=bfloat16",
                             "master_dtype=bfloat16"])
    ckpt = os.path.join(out, "checkpoint")
    saved = torch.load(ckpt, weights_only=True)["model"]
    assert all(v.dtype == torch.bfloat16 for v in saved.values() if v.is_floating_point())
    resumed = port_main.main([*common, "--epochs", "2", "--resume", ckpt, *over,
                              "compute_dtype=bfloat16"])
    assert resumed["start_epoch"] == 1
    for run in (folded, resumed):
        assert all(np.isfinite(e["train_loss"]) for e in run["epochs"]), run["epochs"]
    assert all(v.dtype == torch.float32 for v in torch.load(ckpt, weights_only=True)["model"]
               .values() if v.is_floating_point())
    stats, submission, scores = inference.main(
        ["--device", "cpu", "--resume", ckpt, "--batch-size", "4", *over,
         "compute_dtype=bfloat16", f"submission_dir={tmp_path / 'sub'}"])
    assert len(submission["results"]) == 4 and np.isfinite(stats["loss"])
    assert all(np.isfinite(v) for v in scores.values())
    for mode in ([], ["--continuous", "--chunk", "2"]):
        row = serve.main(["--device", "cpu", "--resume", ckpt, "--n-requests", "4",
                          "--rps", "500", "--batch-size", "2", *mode, *over,
                          "compute_dtype=bfloat16"])
        assert row["requests"] == 4 and row["shed"] == 0
