"""Train step, K steps per dispatch, and the epoch loop; counterpart of the
JAX ``engine/train.py``.

A step is forward_train (with the Hungarian matching on the model's device)
-> criterion -> weighted sum over ``weight_dict`` -> backward -> global-norm
clip -> AdamW, and holds no host synchronisation: on the card it is queued
ahead of the device. Dropout masks come from a ``torch.Generator`` the step
owns, seeded from (seed, step), the counterpart of the JAX package's
``fold_in(rng, state.step)``: the same seed and step give the same masks.
``make_train_multistep`` runs K such steps over a stacked batch, and
``train_one_epoch`` reads each dispatch's metrics only after the next one
is queued, as the JAX package's pipelined fetch does.

With a ``mesh`` (``parallel.mesh.make_mesh``) each process steps on its rows
of the global batch: the forward and the criterion run under
``parallel.mesh.data_parallel`` (global normalisers, the global dropout
mask's rows), the gradients are summed over the data axis before the clip,
so every rank takes the global step, and the loss terms a rank returns are
its rows' shares, summed over the ranks by ``reduce_metrics`` (once a
dispatch, in ``train_one_epoch``'s fetch).

With ``utils.observability.SPANS`` recording, a step is a ``train.step``
span around ``train.forward`` (with the model's ``train.match``),
``train.criterion``, ``train.backward`` and ``train.optimizer``; a K-step
dispatch a ``train.dispatch`` around its steps; and the epoch loop records
``train.data`` (the wait for the next batch), ``train.to_device`` and
``train.fetch`` (the lagged read of a dispatch's metrics, the loop's one
host sync).
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Iterable, List

import numpy as np
import torch

from ..models.layers import dropout_generator
from ..parallel.mesh import all_reduce_sum, data_parallel, sync_grads
from ..parallel.tp import sharded_sq_norm, tp_shard_info
from ..utils.observability import SPANS, flax_path
from ..utils.weights import flax_key
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
    with SPANS.span("train.forward"):
        out, indices, indices_aux, memory_mask = model.forward_train(batch)
    with SPANS.span("train.criterion"):
        losses = criterion(out, batch, indices, indices_aux, memory_mask)
        total = sum(losses[k] * weight_dict[k] for k in losses if k in weight_dict)
    return total, losses


def _leaf_norm(p: torch.Tensor) -> torch.Tensor:
    """Norm of ``p``'s gradient, over every slice of a tensor-parallel
    parameter."""
    if tp_shard_info(p) is None:
        return p.grad.norm()
    return sharded_sq_norm([(p.grad, p)]).sqrt()


def reduce_metrics(metrics: Dict, mesh) -> Dict:
    """The global batch's metrics from a rank's: every loss term (a rank's
    share) summed over the data axis in one collective; ``grad_norm`` (of
    the summed gradients already) and ``lr`` as they are. Without a mesh,
    ``metrics`` itself."""
    if mesh is None:
        return metrics
    keys = [k for k, v in metrics.items()
            if isinstance(v, torch.Tensor) and k != "grad_norm"]
    summed = all_reduce_sum(torch.stack([metrics[k].float() for k in keys]), mesh)
    return dict(metrics, **dict(zip(keys, summed.unbind(0))))


def make_train_step(criterion, weight_dict: Dict[str, float], seed: int = 0, mesh=None):
    """Returns train_step(state, batch, leaf_norms=False) -> metrics.
    ``batch`` holds tensors on the model's device; the step updates
    ``state`` in place (model, optimizer, step + 1). metrics: every loss
    term, ``loss`` (the weighted sum), ``grad_norm`` (before the clip), all
    0-dim tensors, and ``lr`` (a float); with
    ``leaf_norms`` also ``grad_leaf_norms``, {flax key of the parameter
    (``utils.weights.flax_key``): 0-dim norm of its gradient before the
    clip} (0 where no gradient reached it)."""
    generators = {}

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   leaf_norms: bool = False):
        with SPANS.span("train.step"):
            return step(state, batch, leaf_norms)

    def step(state, batch, leaf_norms):
        model = state.model
        dev = next(model.parameters()).device
        if dev not in generators:
            generators[dev] = torch.Generator(device=dev)
        gen = generators[dev].manual_seed(step_seed(seed, state.step))
        model.train()
        state.optimizer.zero_grad()
        with dropout_generator(gen), data_parallel(mesh):
            total, losses = forward_loss(model, criterion, weight_dict, batch)
        with SPANS.span("train.backward"):
            total.backward()
            sync_grads(model.parameters(), mesh)
        if leaf_norms:
            norms = {flax_key(n, p.dim()):
                     _leaf_norm(p) if p.grad is not None else torch.zeros((), device=dev)
                     for n, p in model.named_parameters()}
        with SPANS.span("train.optimizer"):
            grad_norm, lr = state.optimizer.step(state.step)
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics.update(loss=total.detach(), grad_norm=grad_norm, lr=lr)
        if leaf_norms:
            metrics["grad_leaf_norms"] = norms
        return metrics

    return train_step


def make_train_multistep(criterion, weight_dict: Dict[str, float], seed: int = 0,
                         mesh=None):
    """K train steps per call, the counterpart of JAX's
    ``make_train_multistep`` (a ``lax.scan`` of the step). Returns
    multi_step(state, stacked_batch, leaf_norms=False) -> metrics:
    ``stacked_batch`` holds tensors on the model's device with a leading K;
    the K steps run one after another with no host synchronisation between
    or inside them and update ``state`` in place. metrics: every metric of
    ``make_train_step`` as a (K,) tensor, ``lr`` a list of K floats; with
    ``leaf_norms`` also ``grad_leaf_norms`` of the last step. Each step is
    ``make_train_step``'s, with its dropout generator seeded from (seed,
    step), so K calls of one equal one call of the other. An eager loop has
    nothing to unroll: JAX's ``unroll`` has no counterpart. ``mesh`` as in
    ``make_train_step``."""
    train_step = make_train_step(criterion, weight_dict, seed, mesh)

    def multi_step(state: TrainState, stacked_batch: Dict[str, torch.Tensor],
                   leaf_norms: bool = False):
        K = len(next(iter(stacked_batch.values())))
        with SPANS.span("train.dispatch"):
            steps = [train_step(state, {k: v[i] for k, v in stacked_batch.items()},
                                leaf_norms=leaf_norms and i == K - 1) for i in range(K)]
        norms = steps[-1].pop("grad_leaf_norms", None)
        metrics = {k: torch.stack([m[k] for m in steps]) for k in steps[0] if k != "lr"}
        metrics["lr"] = [m["lr"] for m in steps]
        if norms is not None:
            metrics["grad_leaf_norms"] = norms
        return metrics

    return multi_step


def stack_batches(batches: List[Dict]) -> Dict:
    """The array entries of K batch dicts stacked on a leading K (numpy
    arrays or tensors; host-side metadata is dropped)."""
    out = {}
    for k, v in batches[0].items():
        if isinstance(v, np.ndarray):
            out[k] = np.stack([b[k] for b in batches])
        elif isinstance(v, torch.Tensor):
            out[k] = torch.stack([b[k] for b in batches])
    return out


def to_host_floats(values) -> List[float]:
    """Python floats of a list of same-shaped float tensors, behind one
    transfer (one host synchronisation on the card)."""
    return torch.stack([v.detach().float() for v in values]).tolist()


def dump_grad_flow(grad_flow_dir: str, norms: Dict[str, torch.Tensor], epoch: int,
                   step_in_epoch: int) -> str:
    """Write the ``grad_leaf_norms`` of a step as {flax path "a/b/c": norm} to
    ``grads_e{epoch:03d}_s{step:05d}.json``, the JAX package's grad-flow
    file, its keys the flax params paths joined by "/"."""
    values = to_host_floats(list(norms.values()))
    stats = {flax_path(key): v for key, v in zip(norms, values)}
    os.makedirs(grad_flow_dir, exist_ok=True)
    path = os.path.join(grad_flow_dir, f"grads_e{epoch:03d}_s{step_in_epoch:05d}.json")
    with open(path, "w") as f:
        json.dump(stats, f)
    return path


def _waited(batches: Iterable[Dict]):
    """``batches``, each wait for the next one a ``train.data`` span."""
    it = iter(batches)
    while True:
        with SPANS.span("train.data"):
            batch = next(it, None)
        if batch is None:
            return
        yield batch


def _is_aux(key: str) -> bool:
    """An auxiliary-layer metric, which the epoch computes but does not log:
    JAX's filter, a key holding ``_0`` .. ``_4`` or ``_enc_`` (so with 7 or
    more decoder or caption layers the terms of layer 5 on are logged)."""
    return any(f"_{i}" in key for i in range(5)) or "_enc_" in key


def train_one_epoch(train_step, state: TrainState, batches: Iterable[Dict], epoch: int,
                    print_freq: int = 10, step_logger=None, grad_flow_dir: str = "",
                    grad_flow_freq: int = 100, transfer_dtype=None, multi_step=None,
                    chunk_k: int = 1, mesh=None):
    """One pass over ``batches`` (any iterable of batch dicts, numpy or
    tensors), the JAX package's ``train_one_epoch``. Returns (state,
    {metric: global average}) over the metrics that JAX's loop logs (not the
    auxiliary terms, ``_is_aux``); the same filtered metrics go
    to ``step_logger(log, global_step)`` for every step, in step order.

    With ``multi_step`` (``make_train_multistep``) and ``chunk_k`` > 1,
    ``chunk_k`` batches are stacked, sent to the model's device in one
    transfer and run as one dispatch; a ragged tail of fewer than
    ``chunk_k`` batches runs as single steps of ``train_step``. The
    metrics of a dispatch are read (one host transfer) only after the next
    dispatch is queued, so at ``chunk_k`` 1 too they lag one step. A
    non-finite loss raises FloatingPointError naming the first step that
    had one; by then the optimizer may have run up to 2 ``chunk_k`` - 1
    steps past it. The pending metrics are read before the function
    returns, so no checkpoint follows a non-finite loss.

    With ``grad_flow_dir``, the per-parameter gradient norms of every
    ``grad_flow_freq``-th step of the epoch (from its first) are dumped
    there (``dump_grad_flow``); a dispatch of K steps gives the norms of
    its last step only, dumped under that step when the dispatch spans a
    multiple of ``grad_flow_freq``, as JAX's ``consume_many`` does.
    ``transfer_dtype`` as in ``batch_to_device``. With the steps' ``mesh``,
    each dispatch's loss terms are summed over the data axis in the fetch
    (``reduce_metrics``), so every rank logs the global batch's."""
    metric_logger = MetricLogger()
    metric_logger.add_meter("lr", SmoothedValue(window_size=1, fmt="{value:.6f}"))
    dev = next(state.model.parameters()).device

    def consume(metrics, first_step: int, first_global: int):
        """The host side of one dispatch: its metrics (0-dim, or (K,) from
        a multi-step dispatch) fetched in one transfer, then per step in
        order the grad-flow dump, the NaN guard and the logs: a
        ``train.fetch`` span."""
        with SPANS.span("train.fetch"):
            fetch(metrics, first_step, first_global)

    def fetch(metrics, first_step: int, first_global: int):
        norms = metrics.pop("grad_leaf_norms", None)
        metrics = reduce_metrics(metrics, mesh)
        lrs = metrics.pop("lr")
        lrs = lrs if isinstance(lrs, list) else [lrs]
        keys = list(metrics)
        rows = to_host_floats([metrics[k] for k in keys])
        for j, lr in enumerate(lrs):
            values = {k: (row[j] if isinstance(row, list) else row) for k, row in zip(keys, rows)}
            values["lr"] = lr
            step_in_epoch, global_step = first_step + j, first_global + j
            if norms is not None and j == len(lrs) - 1:
                dump_grad_flow(grad_flow_dir, norms, epoch, step_in_epoch)
            if not math.isfinite(values["loss"]):
                raise FloatingPointError(
                    f"loss is {values['loss']} at epoch {epoch} step {step_in_epoch} "
                    f"(global {global_step}): {values}")
            log = {k: v for k, v in values.items() if not _is_aux(k)}
            metric_logger.update(**log)
            if step_logger is not None:
                step_logger(log, global_step)

    step_in_epoch, pending, chunk = 0, None, []
    global0 = state.step

    def dispatched(metrics, k: int):
        """Queue the host side of a dispatch of ``k`` steps just launched,
        after reading the previous one's."""
        nonlocal pending, step_in_epoch
        if pending is not None:
            consume(*pending)
        pending = (metrics, step_in_epoch, global0 + step_in_epoch + 1)
        step_in_epoch += k

    def single(batch):
        dump = bool(grad_flow_dir) and step_in_epoch % grad_flow_freq == 0
        with SPANS.span("train.to_device"):
            batch = batch_to_device(batch, dev, transfer_dtype)
        dispatched(train_step(state, batch, leaf_norms=dump), 1)

    use_chunks = chunk_k > 1 and multi_step is not None
    total = len(batches) if hasattr(batches, "__len__") else None
    for batch in metric_logger.log_every(_waited(batches), print_freq, f"Epoch: [{epoch}]",
                                         total):
        if not use_chunks:
            single(batch)
            continue
        chunk.append(batch)
        if len(chunk) < chunk_k:
            continue
        with SPANS.span("train.to_device"):
            stacked = batch_to_device(stack_batches(chunk), dev, transfer_dtype)
        chunk = []
        dump = bool(grad_flow_dir) and (step_in_epoch + chunk_k - 1) // grad_flow_freq \
            > (step_in_epoch - 1) // grad_flow_freq
        dispatched(multi_step(state, stacked, leaf_norms=dump), chunk_k)
    for batch in chunk:  # ragged tail: fewer than chunk_k batches left
        single(batch)
    if pending is not None:
        consume(*pending)
    stats = {k: meter.global_avg for k, meter in metric_logger.meters.items()}
    return state, stats
