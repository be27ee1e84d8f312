"""Plain PyTorch core of 1-D multi-scale deformable attention.

Counterpart of ``_core_gather`` in the JAX ``ops/ms_deform_attn.py``: per
query, head and level, sample the level's values at P continuous temporal
locations with linear interpolation (the 1-D case of ``grid_sample`` with
``align_corners=False`` and border padding), then sum with the attention
weights. Border semantics clamp the coordinate first,
``x = clip(loc * T - 0.5, 0, T - 1)``, which equals clamping both taps.

This is the CPU path of the port and the oracle that the CUDA kernels
(``csrc/msda_fwd.cu``, ``csrc/msda_bwd.cu``) are held against.
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


def ms_deform_attn_core_backward(
    value: torch.Tensor,
    temporal_shapes: Sequence[int],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    grad_out: torch.Tensor,
):
    """Gradients of ``ms_deform_attn_core`` with respect to value, the
    sampling locations and the attention weights, in the gather form of the
    JAX ``ops/pallas_msda.py::_vjp_bwd_xla``. Per tap, with g0 and g1 the
    dot products of the output gradient with the two value rows:
    daw = g0 * w0 + g1 * w1; dloc = (g1 - g0) * aw * T only where the
    unclamped coordinate ``loc * T - 0.5`` lies strictly inside (0, T - 1),
    else 0 (autograd through ``torch.clamp`` would pass gradient at the exact
    boundary, which is not the kernel's contract); dvalue scatters
    aw * w0 * g and aw * w1 * g into the two rows.

    Args: as ``ms_deform_attn_core``, plus grad_out (B, Q, H * Dh).
    Returns (dvalue (B, S, H, Dh) in value's dtype, dloc and daw
    (B, Q, H, L, P) in the dtype of loc and aw).
    """
    starts, total = _level_splits(temporal_shapes)
    B, S, H, Dh = value.shape
    if S != total:
        raise ValueError(f"value token axis {S} != sum(temporal_shapes) {total}")
    _, Q, _, L, P = sampling_locations.shape
    v32 = value.float()
    g = grad_out.float().reshape(B, Q, H, Dh).permute(0, 2, 1, 3)[:, :, :, None, :]
    dvalue = torch.zeros((B, H, S, Dh), dtype=torch.float32, device=value.device)
    dloc = torch.zeros(sampling_locations.shape, dtype=torch.float32, device=value.device)
    daw = torch.zeros(sampling_locations.shape, dtype=torch.float32, device=value.device)
    for l, (start, T) in enumerate(zip(starts, temporal_shapes)):
        T = int(T)
        v = v32[:, start:start + T].permute(0, 2, 1, 3)  # (B, H, T, Dh)
        xr = sampling_locations[:, :, :, l, :].float().permute(0, 2, 1, 3) * T - 0.5
        x = xr.clamp(0.0, T - 1.0)  # (B, H, Q, P)
        inside = (xr > 0.0) & (xr < T - 1.0)
        x0 = torch.floor(x)
        w1 = x - x0
        w0 = 1.0 - w1
        i0 = x0.long()
        i1 = (i0 + 1).clamp(max=T - 1)
        aw = attention_weights[:, :, :, l, :].float().permute(0, 2, 1, 3)

        def rows(idx):  # (B, H, Q, P) -> flat token index expanded over Dh
            return idx.reshape(B, H, Q * P, 1).expand(-1, -1, -1, Dh)

        v0 = torch.gather(v, 2, rows(i0)).reshape(B, H, Q, P, Dh)
        v1 = torch.gather(v, 2, rows(i1)).reshape(B, H, Q, P, Dh)
        g0 = (g * v0).sum(-1)
        g1 = (g * v1).sum(-1)
        daw[:, :, :, l, :] = (g0 * w0 + g1 * w1).permute(0, 2, 1, 3)
        dloc[:, :, :, l, :] = torch.where(inside, (g1 - g0) * aw * T,
                                          torch.zeros_like(g0)).permute(0, 2, 1, 3)
        dv_l = torch.zeros((B, H, T, Dh), dtype=torch.float32, device=value.device)
        dv_l.scatter_add_(2, rows(i0), ((aw * w0)[..., None] * g).reshape(B, H, Q * P, Dh))
        dv_l.scatter_add_(2, rows(i1), ((aw * w1)[..., None] * g).reshape(B, H, Q * P, Dh))
        dvalue[:, :, start:start + T] = dv_l
    return (dvalue.permute(0, 2, 1, 3).to(value.dtype),
            dloc.to(sampling_locations.dtype), daw.to(attention_weights.dtype))
