"""MSDeformAttn: projections and sampling locations around the MSDA core;
counterpart of the JAX ``models/msda_module.py``. The core runs through
``ops.msda.ms_deform_attn``: the CUDA kernel on the GPU, the plain core on
the CPU. JAX's module takes a ``backend`` (the config's ``msda_backend``:
"", "gather", "matmul", "matmul_acc", "pallas") that picks how JAX computes
the same function; the port runs this one path under every name, and the
models check the name when they are built
(``ops.msda.check_msda_backend``; JAX raises at the first call)."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..device import host_constant
from ..ops.msda import ms_deform_attn
from ..parallel.mesh import gather_from_group, split_sizes, split_to_group
from .layers import Linear


def _offset_bias_init(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """Directional bias: head h points along cos(2*pi*h/H) normalized to
    +-1, scaled by (point index + 1)."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = grid[:, None, None, 0].repeat(n_levels, 1).repeat(n_points, 2)  # (H, L, P)
    for i in range(n_points):
        grid[:, :, i] *= i + 1
    return grid.reshape(-1)


class MSDeformAttn(nn.Module):
    """``token_group`` (set by ``models.dvc.UnimodalDVC.shard_tokens_axis``):
    each rank of that process group projects its slice of the value tokens,
    and the projected values are gathered along the tokens before the
    core."""

    def __init__(self, d_model: int, n_levels: int = 4, n_heads: int = 8,
                 n_points: int = 4):
        super().__init__()
        self.d_model, self.n_levels = d_model, n_levels
        self.n_heads, self.n_points = n_heads, n_points
        hlp = n_heads * n_levels * n_points
        self.value_proj = Linear(d_model, d_model)
        self.sampling_offsets = Linear(d_model, hlp)
        self.attention_weights = Linear(d_model, hlp)
        self.output_proj = Linear(d_model, d_model)
        with torch.no_grad():
            self.sampling_offsets.weight.zero_()
            self.sampling_offsets.bias.copy_(
                torch.from_numpy(_offset_bias_init(n_heads, n_levels, n_points)))
            self.attention_weights.bias.zero_()
        self.token_group = None

    def forward(
        self,
        query: torch.Tensor,             # (B, Q, D), pos embed added
        reference_points: torch.Tensor,  # (B, Q, L, 1) or (B, Q, L, 2) in [0, 1]
        value_input: torch.Tensor,       # (B, S, D) flattened levels
        temporal_shapes: tuple,          # (L,)
        padding_mask=None,               # (B, S) True=pad
    ):
        """Returns (output (B, Q, D), sampling_locations (B, Q, H, L, P),
        attention_weights (B, Q, H, L, P))."""
        B, Q, _ = query.shape
        H, L, P = self.n_heads, self.n_levels, self.n_points
        Dh = self.d_model // H

        if self.token_group is None:
            value = self.value_proj(value_input)
        else:
            sizes = split_sizes(value_input.shape[1], dist.get_world_size(self.token_group))
            value = gather_from_group(
                self.value_proj(split_to_group(value_input, self.token_group, 1, sizes)),
                self.token_group, 1, sizes)
        if padding_mask is not None:
            value = value.masked_fill(padding_mask[..., None], 0.0)
        value = value.reshape(B, -1, H, Dh)

        offsets = self.sampling_offsets(query).reshape(B, Q, H, L, P)
        attn = self.attention_weights(query).reshape(B, Q, H, L * P)
        attn = torch.softmax(attn.float(), dim=-1).reshape(B, Q, H, L, P)

        ref_c = reference_points[:, :, None, :, 0:1]  # (B, Q, 1, L, 1)
        if reference_points.shape[-1] == 1:
            shapes = host_constant([float(t) for t in temporal_shapes], torch.float32,
                                   query.device)
            loc = ref_c + offsets / shapes[None, None, None, :, None]
        elif reference_points.shape[-1] == 2:
            ref_l = reference_points[:, :, None, :, 1:2]
            loc = ref_c + offsets / P * ref_l * 0.5
        else:
            raise ValueError("reference_points last dim must be 1 or 2")

        out = ms_deform_attn(value.contiguous(), tuple(temporal_shapes),
                             loc.float().contiguous(), attn.contiguous())
        return self.output_proj(out.to(value.dtype)), loc, attn
