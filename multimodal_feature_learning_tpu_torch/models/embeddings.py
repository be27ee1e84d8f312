"""Positional and vocabulary embeddings; counterpart of the JAX
``models/embeddings.py``."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..utils.precision import linear_promoted
from .layers import Dropout, Linear


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
        pos_x = caption_sine_embedding(pad_mask, F, self.temperature,
                                       self.normalize).transpose(1, 2)  # (B, T, F)
        B, T = pos_x.shape[:2]

        # binary duration vector: ones in the first int(duration) slots
        slots = torch.arange(F, device=pad_mask.device)[None]
        dur_vec = (slots < duration.to(torch.int32)[:, None]).float()
        # f32 input: computed in f32 whatever the layer's dtype, as flax's Dense
        dur_embed = linear_promoted(self.duration_embed_layer, dur_vec)[:, None, :] \
            .expand(B, T, F)
        return torch.cat([pos_x, dur_embed], dim=2).transpose(1, 2)


def caption_sine_embedding(pad_mask: torch.Tensor, num_pos_feats: int,
                           temperature: float = 10000.0, normalize: bool = True) -> torch.Tensor:
    """Sine embedding over the valid positions, JAX's
    ``caption_sine_embedding`` (no model of either package calls it; the
    video embedding is built on it). pad_mask (B, T) True=pad ->
    (B, num_pos_feats, T)."""
    x_embed = torch.cumsum((~pad_mask).float(), dim=1)
    if normalize:
        x_embed = (x_embed - 0.5) / (x_embed[:, -1:] + 1e-6) * (2 * math.pi)
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=pad_mask.device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / num_pos_feats)
    pos_x = x_embed[:, :, None] / dim_t  # (B, T, F)
    B, T = pos_x.shape[:2]
    pos_x = torch.stack(
        [torch.sin(pos_x[:, :, 0::2]), torch.cos(pos_x[:, :, 1::2])], dim=3
    ).reshape(B, T, -1)
    return pos_x.transpose(1, 2)


class LearnedPositionalEmbedding(nn.Module):
    """A learned positional table added to the input, then dropout (masks
    from the trainer's generator, ``models/layers.py::dropout_generator``);
    JAX's ``LearnedPositionalEmbedding``, which no model calls."""

    def __init__(self, max_tokens: int, d_model: int, dropout: float = 0.0):
        super().__init__()
        self.positional_embedding = nn.Parameter(
            nn.init.trunc_normal_(torch.empty(1, max_tokens, d_model), std=0.02,
                                  a=-0.04, b=0.04))
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(x + self.positional_embedding[:, :x.shape[1]].to(x.dtype))


class VocabularyEmbedder(nn.Module):
    """Token embedding scaled by sqrt(d_model). With a pretrained matrix
    (vocab, dim), GloVe's (``models/load_weights.py``), the embedding
    starts from it and, where dim is not d_model, goes through a Dense
    (``Dense_0``, flax's name; ``models/layers.py::Linear``, so bf16 rounds
    where flax rounds) and a ReLU, as JAX's embedder does."""

    def __init__(self, vocab_size: int, d_model: int, pretrained_matrix=None):
        super().__init__()
        self.d_model = d_model
        if pretrained_matrix is None:
            self.embed = nn.Embedding(vocab_size, d_model)
            return
        matrix = torch.from_numpy(np.array(pretrained_matrix, dtype=np.float32))
        if matrix.dim() != 2 or matrix.shape[0] != vocab_size:
            raise ValueError(f"the pretrained matrix is {tuple(matrix.shape)}, "
                             f"not ({vocab_size}, dim)")
        self.embed = nn.Embedding.from_pretrained(matrix, freeze=False)
        if matrix.shape[1] != d_model:
            self.Dense_0 = Linear(matrix.shape[1], d_model)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed(tokens)
        if hasattr(self, "Dense_0"):
            x = torch.relu(self.Dense_0(x))
        return x * math.sqrt(self.d_model)
