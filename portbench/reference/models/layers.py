"""Attention and MLP building blocks; counterpart of the JAX ``models/layers.py``.

Dropout sits where the JAX modules put it and is active in training mode
only (``module.train()``); serving runs in eval mode. LayerNorm epsilons
follow the JAX package: 1e-6 in the caption decoder layers and the
MaskPredictor (flax's default), not torch's 1e-5.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import batch_shard
from ..utils.precision import linear_promoted

NEG_MASK = -1e20  # masked_fill value, applied before the scale

_DROPOUT_GENERATOR = contextvars.ContextVar("dropout_generator", default=None)


@contextlib.contextmanager
def dropout_generator(gen: Optional[torch.Generator]):
    """Draw every ``Dropout`` mask inside the block from ``gen`` (the
    trainer's generator, seeded per step) instead of torch's global one."""
    token = _DROPOUT_GENERATOR.set(gen)
    try:
        yield gen
    finally:
        _DROPOUT_GENERATOR.reset(token)


class Linear(nn.Linear):
    """``nn.Linear`` rounded as flax's Dense rounds it: outside f32 the
    product is rounded to the compute dtype before the bias is added, so a
    bf16 layer rounds twice, after the dot and after the sum (one fused
    ``addmm`` would round once). In f32 it is ``nn.Linear`` as it is."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.float32 or self.bias is None:
            return F.linear(x, self.weight, self.bias)
        return F.linear(x, self.weight) + self.bias


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU. In f32 ``F.gelu``; in bf16 with jax.nn.gelu's
    rounding, each step in the input's dtype: 0.5 x * erfc(-x sqrt(1/2)),
    erfc in f32 rounded to the dtype (``F.gelu`` would round once)."""
    if x.dtype == torch.float32:
        return F.gelu(x)
    sqrt_half = torch.tensor(0.5 ** 0.5, dtype=torch.float32).to(x.dtype)
    e = torch.special.erfc((-x * sqrt_half).float()).to(x.dtype)
    return (0.5 * x) * e


class Dropout(nn.Module):
    """Inverted dropout, as flax's: in training mode each element is kept
    with probability 1 - p and scaled by 1 / (1 - p); identity in eval mode
    or at p = 0. Masks come from the generator of ``dropout_generator``.

    Under ``parallel.mesh.data_parallel`` the mask is drawn for the global
    batch (dim 0 times the data ranks) and the rank keeps its block of
    rows, so a rank's mask is its rows of the one-process mask and every
    rank's generator stays in step. Every site's dim 0 is batch-major: B,
    or the caption rows N = B * G (G events of a video in a row), and the
    folded bias column of the crop, (B, H, G * Tq, 1).

    ``feature_split`` (offset, full width), set by ``parallel.tp`` on the
    hidden dropout of a tensor-parallel feed-forward block: ``x`` holds the
    features ``offset:offset + x.shape[-1]`` of ``full width``, and the mask
    is drawn for the full width and sliced alike."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = float(p)
        self.feature_split = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        shape = list(x.shape)
        shard = batch_shard()
        if shard is not None:
            shape[0] *= shard[1]
        if self.feature_split is not None:
            shape[-1] = self.feature_split[1]
        u = torch.rand(shape, generator=_DROPOUT_GENERATOR.get(), device=x.device)
        if shard is not None:
            n = x.shape[0]
            u = u[shard[0] * n:(shard[0] + 1) * n]
        if self.feature_split is not None:
            u = u.narrow(-1, self.feature_split[0], x.shape[-1])
        keep = u >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros((), dtype=x.dtype,
                                                                 device=x.device))

    def extra_repr(self) -> str:
        return f"p={self.p}"


class CrossAttention(nn.Module):
    """Multi-head attention with the order logits = q @ k^T;
    masked_fill(-1e20); * head_dim**-0.5; softmax; dropout. Projection and
    the attend step are separate so the KV-cached decode can reuse
    projections."""

    def __init__(self, d_model: int, num_heads: int, qkv_bias: bool = True,
                 attention_dropout: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.num_heads = num_heads
        self.q_linear = Linear(d_model, d_model, bias=qkv_bias)
        self.k_linear = Linear(d_model, d_model, bias=qkv_bias)
        self.v_linear = Linear(d_model, d_model, bias=qkv_bias)
        self.projection_layer = Linear(d_model, d_model)
        self.attn_drop = Dropout(attention_dropout)

    def project_q(self, q):
        return self.q_linear(q)

    def project_kv(self, k, v):
        return self.k_linear(k), self.v_linear(v)

    def attend(
        self,
        qp: torch.Tensor,  # (N, Tq, D) projected; N = B * groups
        kp: torch.Tensor,  # (B, Tk, D) projected
        vp: torch.Tensor,  # (B, Tk, D) projected
        key_padding_mask: Optional[torch.Tensor] = None,  # (N, Tk) True=masked
        groups: int = 1,
        zeroed_mask: Optional[torch.Tensor] = None,  # (N, Tk), shared-KV only
        attn_mask: Optional[torch.Tensor] = None,  # (.., Tq, Tk) True=masked
    ) -> torch.Tensor:
        """``groups`` > 1: ``groups`` consecutive query rows share one k/v row
        (shared-KV attention over the per-video memory).

        ``zeroed_mask`` marks positions whose k/v inputs are zero in the
        materialized-crop semantics but may still be attendable. They all
        share k/v equal to the projection biases, so their columns collapse
        into one bias column with logit q . k_bias * scale + log(m) and value
        v_bias, under a shared max and denominator. In training mode the
        folded column takes one dropout draw, as in the JAX package.

        ``attn_mask`` (the causal mask of the teacher-forced pass, broadcast
        to (B, H, Tq, Tk)) is taken on the plain path only."""
        N, Tq, _ = qp.shape
        B, Tk = kp.shape[0], kp.shape[1]
        H = self.num_heads
        Dh = self.d_model // H
        scale = Dh ** -0.5

        qh = qp.reshape(B, groups * Tq, H, Dh).transpose(1, 2)
        kh = kp.reshape(B, Tk, H, Dh).transpose(1, 2)
        vh = vp.reshape(B, Tk, H, Dh).transpose(1, 2)
        # the dot runs in the k/v dtype (a bf16 KV cache is read as bf16),
        # accumulates in f32, and its logits are upcast after it
        logits = torch.matmul(qh.to(kh.dtype), kh.transpose(-1, -2)).float()  # (B,H,gTq,Tk)
        if attn_mask is not None:
            if groups != 1 or zeroed_mask is not None:
                raise ValueError("attn_mask is not taken on the shared-KV path")
            logits = logits.masked_fill(attn_mask, NEG_MASK)

        if groups == 1 and zeroed_mask is None:
            if key_padding_mask is not None:
                logits = logits.masked_fill(key_padding_mask[:, None, None, :], NEG_MASK)
            attn = self.attn_drop(torch.softmax(logits * scale, dim=-1))
            out = torch.matmul(attn.to(vh.dtype), vh).to(qp.dtype)
            out = out.transpose(1, 2).reshape(N, Tq, self.d_model)
            return self.projection_layer(out)

        pad = key_padding_mask
        if pad is None:
            pad = torch.zeros((N, Tk), dtype=torch.bool, device=qp.device)
        shared_block = pad | zeroed_mask if zeroed_mask is not None else pad
        mask5 = shared_block.reshape(B, 1, groups, 1, Tk)
        logits5 = logits.reshape(B, H, groups, Tq, Tk).masked_fill(mask5, NEG_MASK)
        scaled = logits5.reshape(B, H, groups * Tq, Tk) * scale

        if zeroed_mask is not None:
            zeros_in = kp.new_zeros((1, 1, self.d_model))
            kb = self.k_linear(zeros_in).reshape(H, Dh).to(kh.dtype)
            vb = self.v_linear(zeros_in).reshape(H, Dh).to(vh.dtype)
            l_bias = torch.einsum("bhqd,hd->bhq", qh.to(kh.dtype), kb).float() * scale
            m = (~pad & zeroed_mask).sum(dim=1).float()  # (N,)
            log_m = torch.where(m > 0, torch.log(m.clamp(min=1.0)),
                                torch.full_like(m, NEG_MASK))
            log_m5 = log_m.reshape(B, 1, groups, 1).expand(B, H, groups, Tq)
            bias_logit = l_bias + log_m5.reshape(B, H, groups * Tq)
            # the shift passes no gradient, as the JAX package's stop_gradient
            m_max = torch.maximum(scaled.amax(dim=-1), bias_logit).detach()
            e_main = torch.exp(scaled - m_max[..., None])
            e_bias = torch.exp(bias_logit - m_max)
            denom = e_main.sum(dim=-1) + e_bias
            attn = self.attn_drop(e_main / denom[..., None])
            attn_bias = self.attn_drop((e_bias / denom)[..., None])[..., 0]
            # an f32 sum: the bias column's term is f32 (attn_bias) times v_bias
            out = torch.matmul(attn.to(vh.dtype), vh) \
                + attn_bias[..., None] * vb[None, :, None, :].float()
        else:
            attn = self.attn_drop(torch.softmax(scaled, dim=-1))
            out = torch.matmul(attn.to(vh.dtype), vh)
        out = out.to(qp.dtype).transpose(1, 2).reshape(N, Tq, self.d_model)
        return self.projection_layer(out)

    def forward(self, q, k, v, key_padding_mask=None, attn_mask=None):
        qp = self.project_q(q)
        kp, vp = self.project_kv(k, v)
        return self.attend(qp, kp, vp, key_padding_mask, attn_mask=attn_mask)


class MLP(nn.Module):
    """Two-layer MLP with exact GELU and a dropout after each layer."""

    tp_ffn = ("fully_connected_1", "drop_1", "fully_connected_2")  # parallel.tp's pairing

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 dropout_1: float = 0.0, dropout_2: float = 0.0):
        super().__init__()
        self.fully_connected_1 = Linear(in_dim, hidden_dim)
        self.fully_connected_2 = Linear(hidden_dim, out_dim)
        self.drop_1 = Dropout(dropout_1)
        self.drop_2 = Dropout(dropout_2)

    def forward(self, x):
        x = self.drop_1(gelu(self.fully_connected_1(x)))
        return self.drop_2(self.fully_connected_2(x))


class FFN(nn.Module):
    """n-layer ReLU feed-forward head. ``final_zero_init`` zeroes the last
    layer's weight, as the segment heads of the JAX package are initialised."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, num_layers: int,
                 final_zero_init: bool = False):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        self.layers = nn.ModuleList(
            Linear(dims[i], dims[i + 1]) for i in range(num_layers)
        )
        if final_zero_init:
            nn.init.zeros_(self.layers[-1].weight)

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class ContextMaskModel(nn.Module):
    """Three-layer ReLU MLP predicting per-token memory mask logits."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.layer_1 = Linear(in_dim, in_dim // 2)
        self.layer_2 = Linear(in_dim // 2, in_dim // 2)
        self.layer_3 = Linear(in_dim // 2, out_dim)

    def forward(self, x):
        # an f32 input (the f32 segments beside bf16 query features) is
        # computed in f32 whatever the layers' dtype, as flax's Dense
        x = F.relu(linear_promoted(self.layer_1, x))
        x = F.relu(linear_promoted(self.layer_2, x))
        return linear_promoted(self.layer_3, x)


class MaskPredictor(nn.Module):
    """Sparse-DETR saliency net: LN -> Dense -> GELU, split local/global
    halves, global mean-pooled and broadcast back, then a three-Dense GELU
    tower to one logit. (B, S, D) -> (B, S)."""

    def __init__(self, in_dim: int, h_dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(in_dim, eps=1e-6)
        self.dense_in = Linear(in_dim, h_dim)
        self.dense_1 = Linear(h_dim, h_dim // 2)
        self.dense_2 = Linear(h_dim // 2, h_dim // 4)
        self.dense_out = Linear(h_dim // 4, 1)

    def forward(self, x):
        z = gelu(self.dense_in(self.norm(x)))
        z_local, z_global = z.chunk(2, dim=-1)
        z_global = z_global.mean(dim=1, keepdim=True).expand_as(z_local)
        z = torch.cat([z_local, z_global], dim=-1)
        z = gelu(self.dense_1(z))
        z = gelu(self.dense_2(z))
        return self.dense_out(z)[..., 0]


PRE_NORM_DECODE = (
    "the caption decoder's KV-cached decode (greedy, beam, fused and the continuous "
    "server's) is post-norm only, as the JAX package's is; dvc.caption.pre_norm=True "
    "trains and evaluates teacher-forced (eval.val_mode=teacher_forcing)")


def refuse_pre_norm(module) -> None:
    """Raise ``ValueError`` when ``module`` (a caption layer or decoder) is
    pre-norm: the incremental decode has post-norm math only (JAX asserts
    ``not self.pre_norm`` there)."""
    if getattr(module, "pre_norm", False):
        raise ValueError(PRE_NORM_DECODE)


class UnimodalCaptionDecoderLayer(nn.Module):
    """Caption decoder block: self-attention, cross-attention, MLP, each a
    residual branch. Post-norm (each LayerNorm after its residual sum) or,
    with ``pre_norm``, pre-norm (each LayerNorm on its branch's input), with
    the same parameters."""

    def __init__(self, d_model: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, attention_dropout: float = 0.0,
                 projection_dropout: float = 0.0, mlp_dropout_1: float = 0.0,
                 mlp_dropout_2: float = 0.0, pre_norm: bool = False):
        super().__init__()
        self.pre_norm = pre_norm
        self.self_attention = CrossAttention(d_model, num_heads, qkv_bias, attention_dropout)
        self.cross_attention = CrossAttention(d_model, num_heads, qkv_bias, attention_dropout)
        self.layer_norm_1 = nn.LayerNorm(d_model, eps=1e-6)
        self.layer_norm_2 = nn.LayerNorm(d_model, eps=1e-6)
        self.layer_norm_3 = nn.LayerNorm(d_model, eps=1e-6)
        self.drop_1 = Dropout(projection_dropout)
        self.drop_2 = Dropout(projection_dropout)
        self.mlp = MLP(d_model, int(d_model * mlp_ratio), d_model,
                       mlp_dropout_1, mlp_dropout_2)

    def forward(
        self,
        target: torch.Tensor,  # (N, Tc, D)
        memory: torch.Tensor,  # (N, S, D), or (B, S, D) with groups = N // B
        tgt_mask=None,             # (.., Tc, Tc) True=masked (causal)
        tgt_padding_mask=None,     # (N, Tc) True=pad
        memory_padding_mask=None,  # (N, S) True=masked
        groups: int = 1,
        zeroed_mask=None,
    ) -> torch.Tensor:
        """Teacher-forced pass of the block over a whole caption."""

        def sa(x):
            return self.drop_1(self.self_attention(x, x, x, key_padding_mask=tgt_padding_mask,
                                                   attn_mask=tgt_mask))

        def ca(x):
            return self.drop_2(self.cross_attention.attend(
                self.cross_attention.project_q(x), *self.project_memory_kv(memory),
                key_padding_mask=memory_padding_mask, groups=groups, zeroed_mask=zeroed_mask))

        x = target
        if self.pre_norm:
            x = x + sa(self.layer_norm_1(x))
            x = x + ca(self.layer_norm_2(x))
            return x + self.mlp(self.layer_norm_3(x))
        x = self.layer_norm_1(x + sa(x))
        x = self.layer_norm_2(x + ca(x))
        return self.layer_norm_3(x + self.mlp(x))

    def project_memory_kv(self, memory):
        """Cross-attention k/v of the memory, computed once per decode."""
        return self.cross_attention.project_kv(memory, memory)

    def incremental_pair(
        self,
        x: torch.Tensor,        # (N, 2, D): [commit at step, predict at step+1]
        step,                   # position being committed (row 0): int or (N,)
        k_cache: torch.Tensor,  # (N, Tc, D), updated in place
        v_cache: torch.Tensor,
        valid_len,              # attendable prefix length after the commit: int or (N,)
        mem_k: torch.Tensor,
        mem_v: torch.Tensor,
        memory_padding_mask,
        groups: int = 1,
        zeroed_mask=None,
    ):
        """One layer pass for two positions: row 0 writes its projected k/v
        into the cache at ``step`` and attends keys [0, valid_len), which
        include itself; row 1 attends the same prefix. ``step`` and
        ``valid_len`` are ints (the whole batch in step) or (N,) tensors (a
        position per row: the continuous server's slots). The caches are
        written in place (the JAX version returns updated copies). Post-norm
        only: a pre-norm layer raises ``ValueError``."""
        refuse_pre_norm(self)
        N = x.shape[0]
        Tc = k_cache.shape[1]
        kx, vx = self.self_attention.project_kv(x[:, :1], x[:, :1])
        positions = torch.arange(Tc, device=x.device)
        if isinstance(step, torch.Tensor):
            rows = torch.arange(N, device=x.device)
            k_cache[rows, step] = kx[:, 0]
            v_cache[rows, step] = vx[:, 0]
            key_mask = positions[None, :] >= valid_len[:, None]
        else:
            k_cache[:, step] = kx[:, 0]
            v_cache[:, step] = vx[:, 0]
            key_mask = (positions >= valid_len)[None].expand(N, Tc)
        sa = self.self_attention.attend(
            self.self_attention.project_q(x), k_cache, v_cache,
            key_padding_mask=key_mask,
        )
        x = self.layer_norm_1(x + sa)
        ca = self.cross_attention.attend(
            self.cross_attention.project_q(x), mem_k, mem_v,
            key_padding_mask=memory_padding_mask,
            groups=groups, zeroed_mask=zeroed_mask,
        )
        x = self.layer_norm_2(x + ca)
        x = self.layer_norm_3(x + self.mlp(x))
        return x, k_cache, v_cache
