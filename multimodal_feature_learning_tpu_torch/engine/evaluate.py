"""Eval step and evaluation loop; counterpart of the JAX
``engine/evaluate.py``.

A step is forward_eval (matching on the host, then the captions of
``val_mode``) -> criterion -> the weighted total over ``weight_dict`` ->
the matched segments in seconds. ``evaluate`` runs the step over a loader's
batches, gathers the submission (an event for every ground-truth slot of
every real video), averages the loss terms, scores the submission and
saves it.
"""

from __future__ import annotations

import copy
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..config import check_decode_options
from ..data.loader import split_batch
from ..device import resolve_device
from ..ops.segment_ops import denormalize_segments
from ..utils.postprocess import (captions_to_string, get_sample_submission,
                                 pprint_eval_scores, save_submission)
from .logging import MetricLogger
from .train import batch_to_device


def make_eval_step(model, criterion, weight_dict: Dict[str, float],
                   val_mode: str = "one_by_one", faster_eval: bool = False,
                   beam_size: int = 0, length_penalty: float = 0.0):
    """Returns eval_step(batch) -> (captions, denormalized matched segments
    (B, G, 2) seconds, losses). ``batch`` holds tensors on the model's
    device, ground truth included. ``losses`` has every loss term and
    ``loss``, their sum weighted by ``weight_dict``, all 0-dim tensors. The
    step runs in eval mode without gradients; it is a plain function, with
    nothing compiled. ``serve`` runs no teacher-forced pass and matches the
    final decoder layer only, so its losses are the final layer's without
    the caption loss."""
    check_decode_options(val_mode=val_mode)
    if val_mode == "serve":
        criterion = copy.copy(criterion)
        criterion.losses = [k for k in criterion.losses if k != "captions"]

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor]):
        model.eval()
        out, captions, indices, indices_aux, memory_mask = model.forward_eval(
            batch, val_mode, faster_eval=faster_eval, beam_size=beam_size,
            length_penalty=length_penalty)
        losses = criterion(out, batch, indices, indices_aux, memory_mask)
        losses["loss"] = sum(losses[k] * weight_dict[k] for k in losses if k in weight_dict)
        rows = torch.arange(indices.shape[0], device=indices.device)[:, None]
        denorm = denormalize_segments(out["pred_segments"][rows, indices],
                                      batch["durations"][:, None])
        return captions, denorm, losses

    return eval_step


def evaluate(eval_step, loader, vocab, cfg, epoch: int = 0, score_fn=None,
             max_batches: Optional[int] = None, device="cuda"):
    """Runs ``eval_step`` (from ``make_eval_step``, on a model on ``device``)
    over ``loader``'s batches; returns (val_stats, submission, scores).

    Per batch: the arrays go to ``device``, the step runs, and its captions,
    segments and loss terms come back to the host together, behind one
    synchronisation. The submission holds, for each real video of the batch
    (dummy rows have no key), one event per ground-truth slot that
    ``gt_mask`` marks. ``val_stats`` averages over the batches every loss
    term whose name has no digit (no auxiliary layer's). ``score_fn``
    (submission -> the evaluator's scores) is followed by
    ``pprint_eval_scores``; ``scores`` is None without it. With
    ``cfg.save_submission`` the submission is written under
    ``cfg.submission_dir``."""
    dev = resolve_device(device)
    metric_logger = MetricLogger()
    submission = get_sample_submission()
    G = cfg.dataset.activity_net.max_gt_target_segments

    n_done = 0
    for batch in metric_logger.log_every(loader, cfg.print_freq, f"Eval: [{epoch}]"):
        arrays, meta = split_batch(batch)
        captions, denorm, losses = eval_step(batch_to_device(arrays, dev))
        names = [k for k in losses if not any(ch.isdigit() for ch in k)]
        host = [t.to("cpu", non_blocking=True) for t in
                (captions, denorm, torch.stack([losses[k].float() for k in names]))]
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        captions, denorm, values = (t.numpy() for t in host)
        gt_mask = np.asarray(arrays["gt_mask"])
        strings = captions_to_string(captions, vocab)

        for b, key in enumerate(meta["keys"]):
            submission["results"][key] = [
                {"sentence": strings[b * G + g],
                 "timestamp": [float(denorm[b, g, 0]), float(denorm[b, g, 1])]}
                for g in range(G) if gt_mask[b, g]]

        metric_logger.update(**{k: float(v) for k, v in zip(names, values)})
        n_done += 1
        if max_batches is not None and n_done >= max_batches:
            break

    stats = {k: meter.global_avg for k, meter in metric_logger.meters.items()}

    scores = None
    if score_fn is not None:
        scores = pprint_eval_scores(score_fn(submission), debug=cfg.eval.verbose)
        print("Eval scores:", scores)

    if cfg.save_submission:
        os.makedirs(cfg.submission_dir, exist_ok=True)
        save_submission(
            submission,
            os.path.join(cfg.submission_dir, f"submission_epoch_{epoch:04d}.json"))

    return stats, submission, scores
