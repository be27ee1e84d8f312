"""Train state, optimizer, LR schedule and checkpoints; counterpart of the
JAX ``engine/state.py``.

The optimizer is the JAX package's optax chain, clip_by_global_norm then
adamw (beta 0.9 / 0.999, eps 1e-8, weight decay on every parameter), with
the learning rate of a step-wise StepLR schedule. The clip follows optax's
formula, g * min(1, max_norm / |g|), not ``torch.nn.utils.clip_grad_norm_``'s
max_norm / (|g| + 1e-6). Checkpoints are
``torch.save`` dicts of {model, optimizer, step, epoch}, one file
``<output_dir>/<name>`` each, written by rank 0 alone and always unsharded:
under tensor parallelism the slices of the parameters and of their AdamW
moments are gathered first, so a checkpoint resumes on any mesh
(``shard_state``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
from torch import nn

from ..parallel.mesh import barrier, is_main_process
from ..parallel.tp import (gather_tensor_like, shard_params_tp, shard_tensor_like,
                           sharded_sq_norm, tp_shard_info)
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
    a zero one, so weight decay reaches them as it does in optax. The global
    norm counts a tensor-parallel parameter's slices across its group, so
    every rank clips alike."""

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
        norm = global_grad_norm(self.params, grads)
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


def global_grad_norm(params, grads) -> torch.Tensor:
    """The global L2 norm of ``grads`` in f32 whatever the masters' dtype
    (bf16 grads of a folded model are widened for it; f32 grads are used as
    they are); the slices of tensor-parallel parameters are summed over
    their group."""
    sharded = sharded_sq_norm(zip(grads, params))
    if sharded is None:
        return torch.nn.utils.get_total_norm([g.float() for g in grads])
    rest = torch.nn.utils.get_total_norm(
        [g.float() for g, p in zip(grads, params) if tp_shard_info(p) is None])
    return (rest.square() + sharded).sqrt()


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


def full_state_dicts(state: TrainState):
    """(model state dict, optimizer state dict) of ``state`` unsharded: the
    slices of tensor-parallel parameters and of their AdamW moments
    gathered over their group (a collective: every rank calls it)."""
    named = dict(state.model.named_parameters())
    model_sd = {k: gather_tensor_like(v, named[k]) if k in named else v
                for k, v in state.model.state_dict().items()}
    opt_sd = state.optimizer.state_dict()
    opt_sd["state"] = {
        idx: {k: gather_tensor_like(v, state.optimizer.params[idx])
              if k in ("exp_avg", "exp_avg_sq") else v for k, v in st.items()}
        for idx, st in opt_sd["state"].items()}
    return model_sd, opt_sd


def save_checkpoint(output_dir: str, state: TrainState, epoch: int,
                    name: str = "checkpoint"):
    """Write ``<output_dir>/<name>`` (the JAX package's layout, one file
    here), unsharded, and return its path. Every rank calls it; rank 0
    alone writes, and the ranks leave together once the file is there (the
    others return None, as JAX's rank-gated save)."""
    model_sd, opt_sd = full_state_dicts(state)
    path = os.path.join(output_dir, name)
    if is_main_process():
        os.makedirs(output_dir, exist_ok=True)
        torch.save({"model": model_sd, "optimizer": opt_sd,
                    "step": state.step, "epoch": epoch}, path)
    barrier()
    return path if is_main_process() else None


def shard_state(state: TrainState, mesh, tp_axis=None) -> TrainState:
    """Place a loaded (unsharded) ``state`` on ``mesh``, the checkpoint
    resharding hook (JAX ``shard_state``): without ``tp_axis`` it stays
    replicated, as every rank loaded the same file; with it the parameters
    are placed tensor-parallel over that axis (``parallel.tp``) and each
    AdamW moment is sliced as its parameter. In place; returns ``state``."""
    if mesh is None or tp_axis is None:
        return state
    shard_params_tp(state.model, mesh, tp_axis)
    for p in state.optimizer.params:
        st = state.optimizer.adamw.state.get(p)
        for key in ("exp_avg", "exp_avg_sq"):
            if st and key in st:
                st[key] = shard_tensor_like(st[key], p)
    return state


def _load(path: str, model: nn.Module) -> dict:
    return torch.load(path, map_location=next(model.parameters()).device, weights_only=True)


def load_checkpoint(path: str, state: TrainState) -> int:
    """Restore model, optimizer and step into ``state``, an unsharded one
    (``shard_state`` places it after); returns the epoch.
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
