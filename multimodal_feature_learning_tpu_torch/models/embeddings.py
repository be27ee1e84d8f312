"""Positional and vocabulary embeddings; counterpart of the JAX
``models/embeddings.py``."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..utils.precision import linear_promoted


def caption_positional_encoding(d_model: int, maxlen: int = 5000) -> torch.Tensor:
    """(1, maxlen, d_model) sin/cos table, computed in float64 and stored f32."""
    den = np.exp(-np.arange(0, d_model, 2) * math.log(10000) / d_model)
    pos = np.arange(0, maxlen)[:, None]
    table = np.zeros((maxlen, d_model), dtype=np.float32)
    table[:, 0::2] = np.sin(pos * den)
    table[:, 1::2] = np.cos(pos * den)
    return torch.from_numpy(table[None])


class PositionEmbeddingVideoSine(nn.Module):
    """Sine embedding over valid-token positions plus a learned duration
    embedding. pad_mask (B, T) True=pad, duration (B,) seconds ->
    (B, 2 * num_pos_feats, T)."""

    def __init__(self, num_pos_feats: int, temperature: float = 10000.0,
                 normalize: bool = True):
        super().__init__()
        self.num_pos_feats = num_pos_feats
        self.temperature = temperature
        self.normalize = normalize
        self.duration_embed_layer = nn.Linear(num_pos_feats, num_pos_feats)

    def forward(self, pad_mask: torch.Tensor, duration: torch.Tensor) -> torch.Tensor:
        F = self.num_pos_feats
        not_mask = (~pad_mask).float()
        x_embed = torch.cumsum(not_mask, dim=1)
        if self.normalize:
            x_embed = (x_embed - 0.5) / (x_embed[:, -1:] + 1e-6) * (2 * math.pi)
        dim_t = torch.arange(F, dtype=torch.float32, device=pad_mask.device)
        dim_t = self.temperature ** (2 * torch.floor(dim_t / 2) / F)
        pos_x = x_embed[:, :, None] / dim_t  # (B, T, F)
        B, T = pos_x.shape[:2]
        pos_x = torch.stack(
            [torch.sin(pos_x[:, :, 0::2]), torch.cos(pos_x[:, :, 1::2])], dim=3
        ).reshape(B, T, -1)

        # binary duration vector: ones in the first int(duration) slots
        slots = torch.arange(F, device=pad_mask.device)[None]
        dur_vec = (slots < duration.to(torch.int32)[:, None]).float()
        # f32 input: computed in f32 whatever the layer's dtype, as flax's Dense
        dur_embed = linear_promoted(self.duration_embed_layer, dur_vec)[:, None, :] \
            .expand(B, T, F)
        return torch.cat([pos_x, dur_embed], dim=2).transpose(1, 2)


class VocabularyEmbedder(nn.Module):
    """Token embedding scaled by sqrt(d_model)."""

    def __init__(self, vocab_size: int, d_model: int):
        super().__init__()
        self.d_model = d_model
        self.embed = nn.Embedding(vocab_size, d_model)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed(tokens) * math.sqrt(self.d_model)
