"""Train step and epoch loop; counterpart of the JAX ``engine/train.py``.

A step is forward_train (with the Hungarian matching on the host) ->
criterion -> weighted sum over ``weight_dict`` -> backward -> global-norm
clip -> AdamW. Dropout masks come from a ``torch.Generator`` the step owns,
seeded from (seed, step), the counterpart of the JAX package's
``fold_in(rng, state.step)``: the same seed and step give the same masks.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Iterable

import numpy as np
import torch

from ..models.layers import dropout_generator
from ..utils.weights import SEP, flax_key
from .logging import MetricLogger, SmoothedValue
from .state import TrainState


def step_seed(seed: int, step: int) -> int:
    """The dropout seed of ``step``: a fixed mix of the run's seed and the
    step, so that neighbouring seeds give unrelated masks."""
    return (int(seed) * 0x9E3779B97F4A7C15 + int(step) * 0xBF58476D1CE4E5B9 + 1) % (1 << 63)


# cfg.transfer_dtype -> the dtype float arrays cross to the card in (None: as they are)
TRANSFER_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def batch_to_device(batch: Dict, device, transfer_dtype=None) -> Dict[str, torch.Tensor]:
    """The array entries of a batch dict as tensors on ``device`` (host-side
    metadata such as keys and raw captions are dropped). With a
    ``transfer_dtype`` (``torch.bfloat16``) the float arrays cross in that
    dtype and are upcast to f32 on ``device``."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v)
        elif not isinstance(v, torch.Tensor):
            continue
        if transfer_dtype is not None and v.is_floating_point():
            out[k] = v.to(transfer_dtype).to(device).float()
        else:
            out[k] = v.to(device)
    return out


def forward_loss(model, criterion, weight_dict: Dict[str, float], batch):
    """forward_train -> criterion -> (weighted total, loss terms)."""
    out, indices, indices_aux, memory_mask = model.forward_train(batch)
    losses = criterion(out, batch, indices, indices_aux, memory_mask)
    total = sum(losses[k] * weight_dict[k] for k in losses if k in weight_dict)
    return total, losses


def make_train_step(criterion, weight_dict: Dict[str, float], seed: int = 0):
    """Returns train_step(state, batch, leaf_norms=False) -> metrics.
    ``batch`` holds tensors on the model's device; the step updates
    ``state`` in place (model, optimizer, step + 1). metrics: every loss
    term, ``loss`` (the weighted sum), ``grad_norm`` (before the clip), all
    0-dim tensors, and ``lr`` and ``matcher_ms`` (floats); with
    ``leaf_norms`` also ``grad_leaf_norms``, {flax key of the parameter
    (``utils.weights.flax_key``): 0-dim norm of its gradient before the
    clip} (0 where no gradient reached it)."""
    generators = {}

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   leaf_norms: bool = False):
        model = state.model
        dev = next(model.parameters()).device
        if dev not in generators:
            generators[dev] = torch.Generator(device=dev)
        gen = generators[dev].manual_seed(step_seed(seed, state.step))
        model.train()
        state.optimizer.zero_grad()
        with dropout_generator(gen):
            total, losses = forward_loss(model, criterion, weight_dict, batch)
        total.backward()
        if leaf_norms:
            norms = {flax_key(n, p.dim()):
                     p.grad.norm() if p.grad is not None else torch.zeros((), device=dev)
                     for n, p in model.named_parameters()}
        grad_norm, lr = state.optimizer.step(state.step)
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics.update(loss=total.detach(), grad_norm=grad_norm, lr=lr,
                       matcher_ms=model.matcher_ms)
        if leaf_norms:
            metrics["grad_leaf_norms"] = norms
        return metrics

    return train_step


def dump_grad_flow(grad_flow_dir: str, norms: Dict[str, torch.Tensor], epoch: int,
                   step_in_epoch: int) -> str:
    """Write the ``grad_leaf_norms`` of a step as {flax path "a/b/c": norm} to
    ``grads_e{epoch:03d}_s{step:05d}.json``, the JAX package's grad-flow
    file, its keys the flax params paths joined by "/"."""
    stats = {key.replace(SEP, "/"): float(v) for key, v in norms.items()}
    os.makedirs(grad_flow_dir, exist_ok=True)
    path = os.path.join(grad_flow_dir, f"grads_e{epoch:03d}_s{step_in_epoch:05d}.json")
    with open(path, "w") as f:
        json.dump(stats, f)
    return path


def train_one_epoch(train_step, state: TrainState, batches: Iterable[Dict], epoch: int,
                    print_freq: int = 10, step_logger=None, grad_flow_dir: str = "",
                    grad_flow_freq: int = 100, transfer_dtype=None):
    """One pass over ``batches`` (any iterable of batch dicts, numpy or
    tensors). Stops with FloatingPointError at the first non-finite loss.
    Returns (state, {metric: global average}) over the final-layer metrics
    (the auxiliary ``_0`` .. ``_enc_`` terms are not logged); the same
    filtered metrics go to ``step_logger(log, global_step)`` after every
    step. With ``grad_flow_dir``, every ``grad_flow_freq`` steps of the
    epoch (from its first) the per-parameter gradient norms are dumped there
    (``dump_grad_flow``). ``transfer_dtype`` as in ``batch_to_device``."""
    metric_logger = MetricLogger()
    metric_logger.add_meter("lr", SmoothedValue(window_size=1, fmt="{value:.6f}"))
    dev = next(state.model.parameters()).device
    batches = metric_logger.log_every(batches, print_freq, f"Epoch: [{epoch}]")
    for step_in_epoch, batch in enumerate(batches):
        dump = bool(grad_flow_dir) and step_in_epoch % grad_flow_freq == 0
        metrics = train_step(state, batch_to_device(batch, dev, transfer_dtype), leaf_norms=dump)
        if dump:
            dump_grad_flow(grad_flow_dir, metrics.pop("grad_leaf_norms"), epoch, step_in_epoch)
        values = {k: float(v) for k, v in metrics.items()}  # one sync per step
        if not math.isfinite(values["loss"]):
            raise FloatingPointError(
                f"loss is {values['loss']} at epoch {epoch} step {state.step - 1}: {values}")
        log = {k: v for k, v in values.items()
               if not any(f"_{i}" in k for i in range(10)) and "_enc_" not in k}
        metric_logger.update(**log)
        if step_logger is not None:
            step_logger(log, state.step)
    stats = {k: meter.global_avg for k, meter in metric_logger.meters.items()}
    return state, stats
