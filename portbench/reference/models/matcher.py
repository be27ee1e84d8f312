"""Set matcher: DETR-style Hungarian assignment; counterpart of the JAX
``models/matcher.py``. The cost is built and the assignment solved on the
predictions' device (``ops/hungarian.py``: K6 on the card)."""

from __future__ import annotations

import torch

from ..ops.hungarian import batched_hungarian_torch
from ..ops.segment_ops import generalized_box_iou, segment_cl_to_xy


def match_cost(pred_segments, gt_segments, cost_segment: float = 5.0,
               cost_giou: float = 2.0) -> torch.Tensor:
    """(B, Q, 2), (B, G, 2) (center, length) -> cost (B, Q, G):
    cost_segment * L1 - cost_giou * gIoU, non-finite values replaced (nan
    1e5, +inf 1e5, -inf -1e5) so the assignment stays well posed."""
    l1 = (pred_segments[:, :, None, :] - gt_segments[:, None, :, :]).abs().sum(-1)
    giou = generalized_box_iou(segment_cl_to_xy(pred_segments), segment_cl_to_xy(gt_segments))
    cost = cost_segment * l1 - cost_giou * giou
    return torch.nan_to_num(cost, nan=1e5, posinf=1e5, neginf=-1e5)


def hungarian_match(pred_segments, gt_segments, gt_mask, cost_segment: float = 5.0,
                    cost_giou: float = 2.0) -> torch.Tensor:
    """Returns (B, G) int64 on the predictions' device: GT slot -> matched
    query. Entries at invalid GT slots are arbitrary (mask with gt_mask)."""
    cost = match_cost(pred_segments.detach().float(), gt_segments.float(),
                      cost_segment, cost_giou)
    return batched_hungarian_torch(cost, gt_mask.bool())
