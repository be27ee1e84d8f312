"""Eval step; counterpart of the JAX ``engine/evaluate.py::make_eval_step``.

A step is forward_eval (matching on the host, then the captions of
``val_mode``) -> criterion -> the weighted total over ``weight_dict`` ->
the matched segments in seconds. The evaluation loop over a dataset, the
submission and the scorers are not ported yet.
"""

from __future__ import annotations

import copy
from typing import Dict

import torch

from ..config import check_decode_options
from ..ops.segment_ops import denormalize_segments


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
