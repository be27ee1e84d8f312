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
