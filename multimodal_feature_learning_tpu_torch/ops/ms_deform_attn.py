"""Plain PyTorch core of 1-D multi-scale deformable attention.

Counterpart of ``_core_gather`` in the JAX ``ops/ms_deform_attn.py``: per
query, head and level, sample the level's values at P continuous temporal
locations with linear interpolation (the 1-D case of ``grid_sample`` with
``align_corners=False`` and border padding), then sum with the attention
weights. Border semantics clamp the coordinate first,
``x = clip(loc * T - 0.5, 0, T - 1)``, which equals clamping both taps.

This is the CPU path of the port and the oracle that the CUDA kernel
(``csrc/msda_fwd.cu``) is held against.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _level_splits(temporal_shapes: Sequence[int]):
    """(start, length) pairs of each level in the flattened token axis."""
    starts, cur = [], 0
    for t in temporal_shapes:
        starts.append(cur)
        cur += int(t)
    return starts, cur


def ms_deform_attn_core(
    value: torch.Tensor,
    temporal_shapes: Sequence[int],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """Multi-scale deformable attention, accumulated in f32.

    Args:
      value: (B, S, H, Dh), S = sum(temporal_shapes); f32 or bf16.
      temporal_shapes: per-level token counts (L,).
      sampling_locations: (B, Q, H, L, P) in [0, 1] (unclamped).
      attention_weights: (B, Q, H, L, P).

    Returns (B, Q, H * Dh) in value's dtype.
    """
    starts, total = _level_splits(temporal_shapes)
    B, S, H, Dh = value.shape
    if S != total:
        raise ValueError(f"value token axis {S} != sum(temporal_shapes) {total}")
    _, Q, _, L, P = sampling_locations.shape
    v32 = value.float()
    out = value.new_zeros((B, Q, H, Dh), dtype=torch.float32)
    for l, (start, T) in enumerate(zip(starts, temporal_shapes)):
        T = int(T)
        v = v32[:, start:start + T].permute(0, 2, 1, 3)  # (B, H, T, Dh)
        x = (sampling_locations[:, :, :, l, :].float() * T - 0.5).clamp(0.0, T - 1.0)
        x0 = torch.floor(x)
        w1 = x - x0
        w0 = 1.0 - w1
        i0 = x0.long()
        i1 = (i0 + 1).clamp(max=T - 1)

        def gather(idx):  # (B, Q, H, P) -> (B, H, Q, P, Dh)
            flat = idx.permute(0, 2, 1, 3).reshape(B, H, Q * P, 1).expand(-1, -1, -1, Dh)
            return torch.gather(v, 2, flat).reshape(B, H, Q, P, Dh)

        w0 = w0.permute(0, 2, 1, 3)[..., None]  # (B, H, Q, P, 1)
        w1 = w1.permute(0, 2, 1, 3)[..., None]
        sampled = gather(i0) * w0 + gather(i1) * w1  # (B, H, Q, P, Dh)
        aw = attention_weights[:, :, :, l, :].float().permute(0, 2, 1, 3)[..., None]
        out = out + (sampled * aw).sum(dim=3).permute(0, 2, 1, 3)
    return out.reshape(B, Q, H * Dh).to(value.dtype)
