"""1-D temporal segment geometry; counterpart of the JAX ``ops/segment_ops.py``."""

from __future__ import annotations

import torch


def segment_cl_to_xy(x: torch.Tensor) -> torch.Tensor:
    """(center, length) -> (start, end). Last dim must be 2."""
    c, l = x[..., 0], x[..., 1]
    return torch.stack([c - 0.5 * l, c + 0.5 * l], dim=-1)


def segment_xy_to_cl(x: torch.Tensor) -> torch.Tensor:
    """(start, end) -> (center, length). Last dim must be 2."""
    s, e = x[..., 0], x[..., 1]
    return torch.stack([(s + e) / 2, e - s], dim=-1)


def box_iou(segment1: torch.Tensor, segment2: torch.Tensor):
    """Pairwise IoU of 1-D segments in (start, end) format, batched over
    leading dims: (..., N, 2) and (..., M, 2) -> iou, union each (..., N, M).
    Epsilon 1e-5 in the denominator, as the JAX package has it."""
    area1 = segment1[..., 1] - segment1[..., 0]
    area2 = segment2[..., 1] - segment2[..., 0]
    lt = torch.maximum(segment1[..., :, None, 0], segment2[..., None, :, 0])
    rb = torch.minimum(segment1[..., :, None, 1], segment2[..., None, :, 1])
    inter = (rb - lt).clamp(min=0)
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / (union + 1e-5), union


def generalized_box_iou(segment1: torch.Tensor, segment2: torch.Tensor) -> torch.Tensor:
    """Pairwise generalized IoU of 1-D segments in (start, end) format,
    batched over leading dims: (..., N, 2), (..., M, 2) -> (..., N, M)."""
    iou, union = box_iou(segment1, segment2)
    lt = torch.minimum(segment1[..., :, None, 0], segment2[..., None, :, 0])
    rb = torch.maximum(segment1[..., :, None, 1], segment2[..., None, :, 1])
    area = (rb - lt).clamp(min=0)
    return iou - (area - union) / (area + 1e-5)


def denormalize_segments(segments: torch.Tensor, durations: torch.Tensor) -> torch.Tensor:
    """(center, length) normalized -> (start, end) seconds, clamped to
    [0, duration] and order-fixed. ``durations`` broadcasts to segments[..., 0]."""
    c, l = segments[..., 0], segments[..., 1]
    d = durations
    start = torch.minimum((d / 2 * (2 * c - l)).clamp(min=0.0), d)
    end = torch.minimum((d / 2 * (2 * c + l)).clamp(min=0.0), d)
    return torch.stack([torch.minimum(start, end), torch.maximum(start, end)], dim=-1)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Logit with clamping."""
    x = x.clamp(0.0, 1.0)
    x1 = x.clamp(min=eps)
    x2 = (1.0 - x).clamp(min=eps)
    return torch.log(x1 / x2)
