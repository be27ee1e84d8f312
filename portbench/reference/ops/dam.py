"""Decoder attention map (DAM) helpers of Sparse-DETR token supervision;
counterpart of the JAX ``ops/dam.py``.

``attn_map_to_flat_grid`` splats each decoder sampling location's attention
weight onto the two nearest tokens of the flattened multi-level grid. It
keeps the reference's margin formula as executed: the "start" tap's margin
is ``frac - 1`` (negative), not ``1 - frac``. The scatter-add sums each
token's weights in a fixed order, so the splat, a target of the token loss,
is the same on every run: ``index_add_`` on the CPU (in index order), and on
a CUDA device ``index_put_`` with ``accumulate=True`` (PyTorch's sorted,
segmented sum, its deterministic form of ``index_add_``; ``index_add_``
itself adds with atomics there, in an order that changes from run to run).
One call does not serve both devices: on the CPU, ``index_put_`` with
``accumulate=True`` leaves index order past about 1e5 entries, and its sums
then change from run to run (PyTorch 2 on an 8-thread host).
"""

from __future__ import annotations

import torch

from ..device import host_constant


def idx_to_flat_grid(total_tokens: int, idx: torch.Tensor) -> torch.Tensor:
    """One-hot scatter of token indices: (B, K) -> (B, total_tokens) f32."""
    flat = torch.zeros((idx.shape[0], total_tokens), dtype=torch.float32, device=idx.device)
    return flat.scatter(1, idx.long(), 1.0)


def attn_map_to_flat_grid(temporal_shapes, level_start_index, sampling_locations,
                          attention_weights) -> torch.Tensor:
    """sampling_locations, attention_weights (B, layers, Q, H, L, P) ->
    (B, layers, H, S) with S = sum(temporal_shapes)."""
    B, num_layers, Q, H, L, P = sampling_locations.shape
    dev = sampling_locations.device
    shapes = host_constant([float(t) for t in temporal_shapes], torch.float32, dev)
    starts = host_constant([int(s) for s in level_start_index], torch.long, dev)
    S = int(sum(int(t) for t in temporal_shapes))

    loc = sampling_locations.permute(0, 1, 3, 2, 5, 4).reshape(-1, Q * P, L)
    w = attention_weights.permute(0, 1, 3, 2, 5, 4).reshape(-1, Q * P, L)
    N = loc.shape[0]
    tid_float = loc * shapes
    tid_start = torch.floor(tid_float).long()
    tid_end = tid_start + 1
    margin_start = tid_float - tid_start
    margin_end = tid_float - tid_end

    flat = torch.zeros((N * S,), dtype=torch.float32, device=dev)
    rows = (torch.arange(N, device=dev) * S)[:, None]
    for tid, margin in ((tid_start, margin_end), (tid_end, margin_start)):
        valid = (tid >= 0) & (tid < shapes.long())
        idx = (tid + starts) * valid
        weights = (w * valid * margin).reshape(N, -1)
        flat_idx = (rows + idx.reshape(N, -1)).reshape(-1)
        if flat.is_cuda:
            flat.index_put_((flat_idx,), weights.reshape(-1), accumulate=True)
        else:
            flat.index_add_(0, flat_idx, weights.reshape(-1))
    return flat.reshape(B, num_layers, H, S)


def compute_corr(flat_grid_topk, flat_grid_attn_map, temporal_shapes):
    """Share of decoder attention mass on the tokens the encoder kept, over
    all tokens and per level: a list of (B,) tensors."""
    if flat_grid_topk.dim() == 1:
        flat_grid_topk = flat_grid_topk[None]
        flat_grid_attn_map = flat_grid_attn_map[None]
    corr = [(flat_grid_topk * flat_grid_attn_map).sum(-1) / flat_grid_attn_map.sum(-1)]
    idx = 0
    for shape in temporal_shapes:
        sl = slice(idx, idx + int(shape))
        corr.append((flat_grid_topk[:, sl] * flat_grid_attn_map[:, sl]).sum(-1)
                    / flat_grid_attn_map[:, sl].sum(-1))
        idx += int(shape)
    return corr
