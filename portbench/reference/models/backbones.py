"""Backbones; counterpart of the JAX ``models/backbones.py``.

* ``BiModalEncoder``: video <-> audio cross-attention over the two feature
  streams, ahead of the multimodal family's proposal stack.
* ``VideoVisionTransformer`` (ViViT) over raw frames and
  ``AudioSpectrogramTransformer`` (AST) over log-mel spectrograms, for raw
  ingest (``use_raw_videos``): a patch embedding (tubelet Conv3d, Conv2d),
  learned positional embeddings, class tokens and ``EncoderBlock`` stacks;
  ViViT in its four modes ("spatio temporal attention", "factorised
  encoder", "factorised self attention", "factorised dot product
  attention").

Only what the JAX package's callers build is here: every block pre-norm,
MLP ratio 4, biased q/k/v and no dropout. The patch convolutions pad as
flax's ``nn.Conv`` does by default ("SAME": ceil(in / stride) outputs, the
padding split low = total // 2, high = the rest). Module and parameter
names follow the flax tree (``encoder_3`` becomes ``encoder.3``;
``FactorisedDotProductAttentionBlock`` keeps flax's automatic
``LayerNorm_0``, ``MLP_0``, ``LayerNorm_1``), so the weights carry across
by name.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import MLP, CrossAttention


class BiModalEncoderLayer(nn.Module):
    """Video queries attend the audio and audio queries the video, then an
    MLP on each stream. Each sublayer reads LayerNorm(x) and adds its
    output to x."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.attention_av = CrossAttention(d_model, num_heads)
        self.attention_va = CrossAttention(d_model, num_heads)
        self.norm_av_1 = nn.LayerNorm(d_model, eps=1e-6)
        self.norm_va_1 = nn.LayerNorm(d_model, eps=1e-6)
        self.norm_av_2 = nn.LayerNorm(d_model, eps=1e-6)
        self.norm_va_2 = nn.LayerNorm(d_model, eps=1e-6)
        self.mlp_av = MLP(d_model, 4 * d_model, d_model)
        self.mlp_va = MLP(d_model, 4 * d_model, d_model)

    def forward(self, vid: torch.Tensor, aud: torch.Tensor):
        """vid (B, Tv, D), aud (B, Ta, D) -> the same shapes."""
        v_n, a_n = self.norm_av_1(vid), self.norm_va_1(aud)
        vid = vid + self.attention_av(v_n, a_n, a_n)
        aud = aud + self.attention_va(a_n, v_n, v_n)
        vid = vid + self.mlp_av(self.norm_av_2(vid))
        aud = aud + self.mlp_va(self.norm_va_2(aud))
        return vid, aud


class BiModalEncoder(nn.Module):
    """``depth`` BiModalEncoderLayers, named ``layer_{i}`` as flax names
    them, so that the weights carry across by name."""

    def __init__(self, d_model: int, depth: int, num_heads: int):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"layer_{i}", BiModalEncoderLayer(d_model, num_heads))

    def forward(self, vid: torch.Tensor, aud: torch.Tensor):
        for i in range(self.depth):
            vid, aud = getattr(self, f"layer_{i}")(vid, aud)
        return vid, aud



VIVIT_MODES = ("spatio temporal attention", "factorised encoder",
               "factorised self attention", "factorised dot product attention")


