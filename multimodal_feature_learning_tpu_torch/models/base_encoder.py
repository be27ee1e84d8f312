"""Multi-scale temporal feature pyramid; counterpart of the JAX
``models/base_encoder.py``.

Level 0 is a pointwise Conv1d + GroupNorm(32) of the input features; levels
1..L-1 are strided (k=3, s=2, p=1) Conv1d + GroupNorm, level 1 on the input
and deeper levels on the previous level. The public layout is channels-last
(B, T, C), as in the JAX package; the convolutions run channels-first.
"""

from __future__ import annotations

import torch
from torch import nn

from .embeddings import PositionEmbeddingVideoSine


def interpolate_mask_nearest(mask: torch.Tensor, new_size: int) -> torch.Tensor:
    """Nearest downsampling: out[i] = in[floor(i * T_in / T_out)]."""
    T_in = mask.shape[1]
    idx = (torch.arange(new_size, device=mask.device) * T_in) // new_size
    return mask[:, idx]


def pyramid_shapes(video_len: int, num_levels: int) -> tuple:
    """Per-level token counts: each strided conv gives ceil(T / 2)."""
    shapes = [video_len]
    t = video_len
    for _ in range(num_levels - 1):
        t = (t + 1) // 2
        shapes.append(t)
    return tuple(shapes)


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` rounded as flax's Conv: outside f32 the convolution is
    rounded to the compute dtype before the bias is added (``layers.Linear``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.float32 or self.bias is None:
            return super().forward(x)
        return self._conv_forward(x, self.weight, None) + self.bias[:, None]


class BaseEncoder(nn.Module):
    def __init__(self, num_feature_levels: int, d_model: int, feature_dim: int):
        super().__init__()
        self.pos_embed = PositionEmbeddingVideoSine(d_model // 2, normalize=True)
        self.input_proj = nn.ModuleList(
            [Conv1d(feature_dim, d_model, 1)]
            + [
                Conv1d(feature_dim if l == 1 else d_model, d_model, 3,
                          stride=2, padding=1)
                for l in range(1, num_feature_levels)
            ]
        )
        self.gn = nn.ModuleList(
            [nn.GroupNorm(32, d_model, eps=1e-5) for _ in range(num_feature_levels)]
        )

    def forward(self, vf: torch.Tensor, mask: torch.Tensor, duration: torch.Tensor):
        """vf (B, T, feature_dim), mask (B, T) True=pad, duration (B,) ->
        lists of srcs (B, T_l, D), masks (B, T_l), pos (B, T_l, D)."""
        x = vf.transpose(1, 2)  # (B, C, T)
        srcs, masks, poses = [], [], []
        prev = None
        for l, (conv, gn) in enumerate(zip(self.input_proj, self.gn)):
            inp = x if l <= 1 else prev
            src = gn(conv(inp))  # (B, D, T_l)
            m = mask if l == 0 else interpolate_mask_nearest(mask, src.shape[2])
            srcs.append(src.transpose(1, 2))
            masks.append(m)
            # the f32 sine table in the trunk's dtype, so a bf16 trunk stays bf16
            poses.append(self.pos_embed(m, duration).transpose(1, 2).to(src.dtype))
            prev = src
        return srcs, masks, poses
