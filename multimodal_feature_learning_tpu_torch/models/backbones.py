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

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import MLP, CrossAttention, Linear


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


class EncoderBlock(nn.Module):
    """Pre-norm transformer block: x + attention(LN(x)), then x + MLP(LN(x))."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.attention = CrossAttention(d_model, num_heads)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-6)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-6)
        self.mlp = MLP(d_model, 4 * d_model, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x)
        x = x + self.attention(h, h, h)
        return x + self.mlp(self.norm2(x))


class FactorisedSelfAttentionBlock(nn.Module):
    """Spatial self-attention, then temporal self-attention, then the MLP
    (ViViT model 3), each pre-norm; x (B, T, P, D)."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.spatial_attention = CrossAttention(d_model, num_heads)
        self.temporal_attention = CrossAttention(d_model, num_heads)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-6)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-6)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-6)
        self.mlp = MLP(d_model, 4 * d_model, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, P, D = x.shape
        xs = self.norm1(x).reshape(B * T, P, D)
        x = x + self.spatial_attention(xs, xs, xs).reshape(B, T, P, D)
        xt = self.norm2(x).transpose(1, 2).reshape(B * P, T, D)
        x = x + self.temporal_attention(xt, xt, xt).reshape(B, P, T, D).transpose(1, 2)
        return x + self.mlp(self.norm3(x))


class FactorisedDotProductAttentionBlock(nn.Module):
    """Half the heads attend within a frame, half across frames at one
    patch position (ViViT model 4); x (B, T, P, D)."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=1e-6)
        self.q = Linear(d_model, d_model)
        self.k = Linear(d_model, d_model)
        self.v = Linear(d_model, d_model)
        self.proj = Linear(d_model, d_model)
        self.MLP_0 = MLP(d_model, 4 * d_model, d_model)
        self.LayerNorm_1 = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, P, D = x.shape
        H = self.num_heads
        Dh = D // H
        h_s = H // 2
        y = self.LayerNorm_0(x)

        def heads(z):  # (B, T, P, D) -> (B, H, T, P, Dh)
            return z.reshape(B, T, P, H, Dh).permute(0, 3, 1, 2, 4)

        qh, kh, vh = heads(self.q(y)), heads(self.k(y)), heads(self.v(y))
        scale = Dh ** -0.5
        # spatial heads: over P within each frame
        att_s = torch.softmax(torch.matmul(qh[:, :h_s] * scale,
                                           kh[:, :h_s].transpose(-1, -2)), dim=-1)
        out_s = torch.matmul(att_s, vh[:, :h_s])
        # temporal heads: over T at each patch position
        qt, kt, vt = (z[:, h_s:].transpose(2, 3) for z in (qh, kh, vh))  # (B, h, P, T, Dh)
        att_t = torch.softmax(torch.matmul(qt * scale, kt.transpose(-1, -2)), dim=-1)
        out_t = torch.matmul(att_t, vt).transpose(2, 3)
        out = torch.cat([out_s, out_t], dim=1).permute(0, 2, 3, 1, 4).reshape(B, T, P, D)
        x = x + self.proj(out)
        return x + self.MLP_0(self.LayerNorm_1(x))


def same_padding(sizes: Sequence[int], kernel: Sequence[int], strides: Sequence[int]
                 ) -> Tuple[Tuple[int, int], ...]:
    """flax/XLA "SAME" padding of each axis: (low, high) with total =
    max((ceil(in / s) - 1) s + k - in, 0) and low = total // 2."""
    pads = []
    for n, k, s in zip(sizes, kernel, strides):
        out = -(-n // s)
        total = max((out - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


class TokenEmbedding(nn.Module):
    """Tubelet embedding: (B, T, H, W, C) -> (B, T', Hp * Wp, D), the
    Conv3d with kernel = stride (pt, ps, ps) computed as one product of the
    non-overlapping patches with the flattened kernel."""

    def __init__(self, d_model: int, spatial_patch_size: int = 16,
                 temporal_patch_size: int = 1, in_channels: int = 3):
        super().__init__()
        k = (temporal_patch_size, spatial_patch_size, spatial_patch_size)
        self.kernel = k
        self.project_to_patch = nn.Conv3d(in_channels, d_model, k, stride=k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, H, W, C = x.shape
        pads = [p for lo_hi in reversed(same_padding((T, H, W), self.kernel, self.kernel))
                for p in lo_hi]
        if any(pads):  # (W, H, T) in F.pad's last-axis-first order, channels last
            x = F.pad(x, [0, 0] + pads)
            T, H, W = x.shape[1:4]
        pt, ph, pw = self.kernel
        Tp, Hp, Wp = T // pt, H // ph, W // pw
        patches = x.reshape(B, Tp, pt, Hp, ph, Wp, pw, C).permute(0, 1, 3, 5, 7, 2, 4, 6)
        patches = patches.reshape(B, Tp, Hp * Wp, C * pt * ph * pw)
        w = self.project_to_patch.weight
        return F.linear(patches, w.reshape(w.shape[0], -1), self.project_to_patch.bias)


class PatchEmbedding(nn.Module):
    """Conv2d patch embedding of a spectrogram: (B, H, W, C) -> (B, Hp * Wp,
    D), with "SAME" padding (the patches overlap when the strides are
    smaller than the kernel)."""

    def __init__(self, d_model: int, patch_size: int = 16,
                 strides: Optional[Tuple[int, int]] = None, in_channels: int = 1):
        super().__init__()
        self.kernel = (patch_size, patch_size)
        self.strides = tuple(strides or self.kernel)
        self.project_to_patch = nn.Conv2d(in_channels, d_model, self.kernel,
                                          stride=self.strides)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        pads = [p for lo_hi in reversed(same_padding(x.shape[2:], self.kernel, self.strides))
                for p in lo_hi]
        return self.project_to_patch(F.pad(x, pads)).flatten(2).transpose(1, 2)


VIVIT_MODES = ("spatio temporal attention", "factorised encoder",
               "factorised self attention", "factorised dot product attention")


class VivitEncoder(nn.Module):
    """ViViT's encoder over a (B, T, P, D) token grid, in one of
    ``VIVIT_MODES``. The two attention modes with class tokens add the
    positional embedding before every layer, as the JAX package does."""

    def __init__(self, model_name: str, d_model: int, depth: int, temporal_depth: int,
                 num_heads: int):
        super().__init__()
        if model_name not in VIVIT_MODES:
            raise ValueError(f"unknown vivit mode {model_name!r}")
        self.model_name = model_name
        if model_name == "spatio temporal attention":
            self.cls = nn.Parameter(torch.zeros(1, 1, d_model))
            self.encoder = nn.ModuleList(EncoderBlock(d_model, num_heads)
                                         for _ in range(depth))
        elif model_name == "factorised encoder":
            self.spatial_token = nn.Parameter(torch.zeros(1, 1, d_model))
            self.temporal_token = nn.Parameter(torch.zeros(1, 1, d_model))
            self.spatial_encoder = nn.ModuleList(EncoderBlock(d_model, num_heads)
                                                 for _ in range(depth))
            self.temporal_encoder = nn.ModuleList(EncoderBlock(d_model, num_heads)
                                                  for _ in range(temporal_depth))
        else:
            block = (FactorisedSelfAttentionBlock if model_name == "factorised self attention"
                     else FactorisedDotProductAttentionBlock)
            self.encoder = nn.ModuleList(block(d_model, num_heads) for _ in range(depth))

    def forward(self, x: torch.Tensor, pos_embedding: torch.Tensor,
                spatial_pos_embedding: torch.Tensor) -> torch.Tensor:
        B, T, P, D = x.shape

        def add(z, e):
            return z + e[:, :z.shape[1]]

        if self.model_name == "spatio temporal attention":
            x = torch.cat([self.cls.expand(B, 1, D), x.reshape(B, T * P, D)], dim=1)
            for layer in self.encoder:
                x = layer(add(x, pos_embedding))
            return x  # (B, T*P+1, D)
        if self.model_name == "factorised encoder":
            x = torch.cat([self.spatial_token.expand(B * T, 1, D), x.reshape(B * T, P, D)],
                          dim=1)
            for layer in self.spatial_encoder:
                x = layer(add(x, spatial_pos_embedding))
            x = x.reshape(B, T, P + 1, D)[:, :, 0]  # each frame's spatial class token
            x = torch.cat([self.temporal_token.expand(B, 1, D), x], dim=1)
            for layer in self.temporal_encoder:
                x = layer(add(x, pos_embedding))
            return x  # (B, T+1, D)
        for layer in self.encoder:
            x = layer(x)
        return x


class VideoVisionTransformer(nn.Module):
    """ViViT over normalised frames (B, T, H, W, C): per-frame features
    (B, T', D) in "factorised encoder" (class token dropped), the token
    sequence (B, T' P, D) in "spatio temporal attention", and the
    patch-pooled grid (B, T', D) in the factorised attention modes."""

    def __init__(self, model_name: str = "factorised encoder", d_model: int = 768,
                 depth: int = 12, temporal_depth: int = 4, num_heads: int = 12,
                 spatial_patch_size: int = 16, temporal_patch_size: int = 1,
                 max_tokens: int = 4096):
        super().__init__()
        self.model_name = model_name
        self.token_embeddings_layer = TokenEmbedding(d_model, spatial_patch_size,
                                                     temporal_patch_size)
        self.pos_embedding = nn.Parameter(torch.empty(1, max_tokens, d_model))
        self.spatial_pos_embedding = nn.Parameter(torch.empty(1, max_tokens, d_model))
        nn.init.trunc_normal_(self.pos_embedding, std=0.02)
        nn.init.trunc_normal_(self.spatial_pos_embedding, std=0.02)
        self.encoder = VivitEncoder(model_name, d_model, depth, temporal_depth, num_heads)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        out = self.encoder(self.token_embeddings_layer(frames), self.pos_embedding,
                           self.spatial_pos_embedding)
        if self.model_name in ("factorised encoder", "spatio temporal attention"):
            return out[:, 1:]
        return out.mean(dim=2)


class AudioSpectrogramTransformer(nn.Module):
    """AST over log-mel spectrograms (B, n_frames, n_mels) -> (B, P + 2, D):
    the class and distillation tokens, then the patches, after a final
    LayerNorm."""

    def __init__(self, d_model: int = 768, depth: int = 12, num_heads: int = 12,
                 patch_size: int = 16, frequency_stride: int = 10, time_stride: int = 10,
                 max_tokens: int = 4096):
        super().__init__()
        self.patch_embedding = PatchEmbedding(d_model, patch_size,
                                              (frequency_stride, time_stride))
        self.cls = nn.Parameter(torch.zeros(1, 1, d_model))
        self.distill_token = nn.Parameter(torch.zeros(1, 1, d_model))
        self.pos_embedding = nn.Parameter(torch.empty(1, max_tokens, d_model))
        nn.init.trunc_normal_(self.pos_embedding, std=0.02)
        self.encoder = nn.ModuleList(EncoderBlock(d_model, num_heads) for _ in range(depth))
        self.norm = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, spectrogram: torch.Tensor) -> torch.Tensor:
        x = self.patch_embedding(spectrogram[..., None])
        B, _, D = x.shape
        x = torch.cat([self.cls.expand(B, 1, D), self.distill_token.expand(B, 1, D), x], dim=1)
        x = x + self.pos_embedding[:, :x.shape[1]]
        for layer in self.encoder:
            x = layer(x)
        return self.norm(x)
