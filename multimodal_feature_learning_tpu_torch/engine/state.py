"""Train state, optimizer, LR schedule and checkpoints; counterpart of the
JAX ``engine/state.py``.

The optimizer is the JAX package's optax chain, clip_by_global_norm then
adamw (beta 0.9 / 0.999, eps 1e-8, weight decay on every parameter), with
the learning rate of a step-wise StepLR schedule. The clip follows optax's
formula, g * min(1, max_norm / |g|), not ``torch.nn.utils.clip_grad_norm_``'s
max_norm / (|g| + 1e-6). Checkpoints are
``torch.save`` dicts of {model, optimizer, step, epoch}, one file
``<output_dir>/<name>`` each.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
from torch import nn

from ..utils.precision import resolve_dtype


def make_lr_schedule(base_lr: float, lr_drop_epochs: int, steps_per_epoch: int):
    """StepLR per step: lr * 0.1 ** ((step // steps_per_epoch) // lr_drop);
    lr_drop <= 0 keeps the rate constant."""
    if lr_drop_epochs <= 0:
        return lambda step: base_lr

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return base_lr * 0.1 ** (epoch // lr_drop_epochs)

    return schedule


class ClippedAdamW:
    """Global-norm clip to optax's formula, then ``torch.optim.AdamW`` at the
    schedule's rate for the step. Parameters that received no gradient get
    a zero one, so weight decay reaches them as it does in optax."""

    def __init__(self, params, lr_schedule, clip_max_norm: float, weight_decay: float):
        self.params = [p for p in params if p.requires_grad]
        self.lr_schedule = lr_schedule
        self.clip_max_norm = float(clip_max_norm)
        self.adamw = torch.optim.AdamW(self.params, lr=lr_schedule(0), betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=weight_decay)

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, step: int):
        """Clip the gradients in place and update. Returns (global norm of
        the gradients before the clip, learning rate of the step)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        # the global norm in f32 whatever the masters' dtype (bf16 grads of a
        # folded model are widened for it; f32 grads are used as they are)
        norm = torch.nn.utils.get_total_norm([g.float() for g in grads])
        torch._foreach_mul_(grads, (self.clip_max_norm / norm).clamp(max=1.0))
        lr = self.lr_schedule(step)
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        return norm, lr

    def state_dict(self):
        return self.adamw.state_dict()

    def load_state_dict(self, sd):
        self.adamw.load_state_dict(sd)


def make_optimizer(cfg, model: nn.Module, steps_per_epoch: int) -> ClippedAdamW:
    return ClippedAdamW(model.parameters(),
                        make_lr_schedule(cfg.lr, cfg.lr_drop, steps_per_epoch),
                        cfg.clip_max_norm, cfg.weight_decay)


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: ClippedAdamW


def create_train_state(cfg, model: nn.Module, steps_per_epoch: int) -> TrainState:
    """The model and its optimizer at step 0. ``cfg.master_dtype``
    "bfloat16" first folds the f32 master copy: every float parameter is
    cast to bf16 in place, so the AdamW moments the optimizer derives from
    them are bf16 too (JAX ``create_train_state``)."""
    dtype = resolve_dtype(cfg.master_dtype)
    for p in model.parameters():
        if p.is_floating_point() and p.dtype != dtype:
            p.data = p.data.to(dtype)
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(cfg, model, steps_per_epoch))


def save_checkpoint(output_dir: str, state: TrainState, epoch: int,
                    name: str = "checkpoint") -> str:
    """Write ``<output_dir>/<name>`` (the JAX package's layout, one file
    here) and return its path."""
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, name)
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step, "epoch": epoch}, path)
    return path


def _load(path: str, model: nn.Module) -> dict:
    return torch.load(path, map_location=next(model.parameters()).device, weights_only=True)


def load_checkpoint(path: str, state: TrainState) -> int:
    """Restore model, optimizer and step into ``state``; returns the epoch.
    The checkpoint's master dtype may differ from ``state``'s (an f32
    checkpoint resumed into a bf16 fold, or back): the weights and the AdamW
    moments are cast onto the dtypes of ``state``'s parameters, as JAX's
    ``load_checkpoint`` casts the restore onto its template."""
    ckpt = _load(path, state.model)
    state.model.load_state_dict(ckpt["model"], strict=True)
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    return int(ckpt["epoch"])


def load_model_weights(path: str, model: nn.Module) -> int:
    """Restore only the model's weights from a checkpoint, strictly (the
    serving and evaluation entry points); returns the epoch."""
    ckpt = _load(path, model)
    model.load_state_dict(ckpt["model"], strict=True)
    return int(ckpt["epoch"])
