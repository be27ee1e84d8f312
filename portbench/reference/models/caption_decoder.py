"""Per-event caption decoder: the teacher-forced pass of training and
evaluation, the KV-cached greedy decode of serving (whole, or in chunks at
per-video cursors for the continuous server) and the beam search of
evaluation; counterpart of the JAX ``models/caption_decoder.py``. The greedy
decode runs as plain ops, one ``decode_pair`` per token (``decode_impl``
"xla"), or through the fused decode step, one kernel launch per token
(``decode_impl`` "fused", ``ops/fused_decode.py``). Every decode is
post-norm only: with ``pre_norm`` each raises before it launches anything
(JAX's plain decode asserts the same; its fused decode has no such check
and would run a pre-norm model with post-norm math)."""

from __future__ import annotations

import torch
from torch import nn

from .embeddings import VocabularyEmbedder, caption_positional_encoding
from .layers import Dropout, Linear, UnimodalCaptionDecoderLayer


def make_causal_mask(seq_len: int, device=None) -> torch.Tensor:
    """(seq_len, seq_len) True above the diagonal (masked)."""
    return ~torch.ones((seq_len, seq_len), dtype=torch.bool, device=device).tril()


class UnimodalCaptionDecoder(nn.Module):
    def __init__(self, vocab_size: int, d_model: int = 512, depth: int = 6,
                 num_heads: int = 8, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 positional_embedding_dropout: float = 0.0, attention_dropout: float = 0.0,
                 projection_dropout: float = 0.0, mlp_dropout_1: float = 0.0,
                 mlp_dropout_2: float = 0.0, embedding_matrix=None, pre_norm: bool = False,
                 return_intermediate: bool = True):
        super().__init__()
        self.depth = depth
        self.num_heads = num_heads
        self.pre_norm = pre_norm
        self.return_intermediate = return_intermediate
        self.target_embedding = VocabularyEmbedder(vocab_size, d_model, embedding_matrix)
        self.register_buffer("pos_table", caption_positional_encoding(d_model),
                             persistent=False)
        self.pos_dropout = Dropout(positional_embedding_dropout)
        self.decoder = nn.ModuleList(
            UnimodalCaptionDecoderLayer(d_model, num_heads, mlp_ratio, qkv_bias,
                                        attention_dropout, projection_dropout,
                                        mlp_dropout_1, mlp_dropout_2, pre_norm)
            for _ in range(depth))
        self.head = Linear(d_model, vocab_size)

    def forward(self, tgt, memory, tgt_mask=None, tgt_padding_mask=None,
                memory_padding_mask=None, groups: int = 1, zeroed_mask=None,
                log_probs: bool = False):
        """Teacher-forced pass: tgt (N, Tc) token ids, memory (B, S, D) with
        groups = N // B -> the (depth, N, Tc, V) stack of every layer (of the
        last one alone, (1, N, Tc, V), without ``return_intermediate``): raw
        logits (training: the criterion folds the log-softmax into its
        loss), or with ``log_probs`` f32 log-probabilities (evaluation), as
        the JAX ``__call__`` returns them unless ``return_logits``."""
        x = self.target_embedding(tgt)
        # the f32 sine table in the embedding's dtype, so a bf16 trunk stays bf16
        x = self.pos_dropout(x + self.pos_table[:, :tgt.shape[1]].to(x.dtype))
        if tgt_mask is not None and tgt_mask.dim() == 2:
            tgt_mask = tgt_mask[None, None]
        intermediate = []
        for layer in self.decoder:
            x = layer(x, memory, tgt_mask, tgt_padding_mask, memory_padding_mask,
                      groups=groups, zeroed_mask=zeroed_mask)
            if self.return_intermediate:
                intermediate.append(x)
        logits = self.head(torch.stack(intermediate) if self.return_intermediate else x[None])
        return torch.log_softmax(logits.float(), dim=-1) if log_probs else logits

