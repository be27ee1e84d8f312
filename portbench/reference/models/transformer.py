"""Deformable proposal transformer, with Sparse-DETR encoder sparsification
(rho > 0, the sparse family) or without it (rho = 0, the dense family);
counterpart of the JAX ``models/transformer.py``, with the dropouts of its
layers active in training mode.

The sparse token budget is static, K = int(rho * S) + 1, as in the JAX
package; per-sample counts gate the scatter-back. Top-K selection sorts the
saliency with a stable descending sort, so ties keep the lower index first as
``jax.lax.top_k`` does (``torch.topk`` on CUDA promises no order on ties).
With rho = 0 every token is a query and the encoder's output is the layer's;
there is no saliency, and the saliency net (``enc_mask_predictor``,
``enc_output``, ``enc_output_norm``), which flax creates only when it is
called, is not created either.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import global_min
from .layers import CrossAttention, Dropout, Linear, MaskPredictor
from .msda_module import MSDeformAttn


def get_valid_ratios(masks) -> torch.Tensor:
    """(B, L): fraction of non-pad tokens per level."""
    return torch.stack(
        [(~m).sum(dim=1).float() / m.shape[1] for m in masks], dim=1)


def get_encoder_reference_points(temporal_shapes, valid_ratios) -> torch.Tensor:
    """(B, S, L, 1) normalized per-level reference points."""
    refs = []
    for lvl, T in enumerate(temporal_shapes):
        T = int(T)
        ref = torch.linspace(0.5, T - 0.5, T, dtype=torch.float32,
                             device=valid_ratios.device)[None]
        refs.append(ref / (valid_ratios[:, None, lvl] * T))
    reference_points = torch.cat(refs, dim=1)  # (B, S)
    reference_points = reference_points[:, :, None] * valid_ratios[:, None]
    return reference_points[..., None]


def gen_encoder_output_proposals(temporal_shapes, memory_padding_mask):
    """Grid (center, width) proposal bases per token and their validity.

    Keeps the reference's scrambled 1-D pairing (the JAX ``scrambled=True``
    default): a flat concat of (grid, wh) viewed as pairs. The validity it
    yields gates the saliency net's input, so it shapes the top-rho tokens.
    Returns (proposals_unact (B, S, 2) with +inf where invalid, valid (B, S)).
    """
    B = memory_padding_mask.shape[0]
    dev = memory_padding_mask.device
    proposals = []
    cur = 0
    for lvl, T in enumerate(temporal_shapes):
        T = int(T)
        mask_l = memory_padding_mask[:, cur:cur + T]
        valid_L = (~mask_l).sum(dim=1).float()
        grid = torch.arange(T, dtype=torch.float32, device=dev)[None]
        grid = (grid + 0.5) / valid_L[:, None]  # (B, T)
        wh = torch.full_like(grid, 0.05 * (2.0 ** lvl))
        flat = torch.cat([grid.expand(B, T), wh.expand(B, T)], dim=1)  # (B, 2T)
        proposals.append(flat.reshape(B, T, 2))
        cur += T
    output_proposals = torch.cat(proposals, dim=1)
    valid = ((output_proposals > 0.01) & (output_proposals < 0.99)).all(dim=-1)
    unact = torch.log(output_proposals / (1 - output_proposals))
    unact = unact.masked_fill(memory_padding_mask[..., None], float("inf"))
    unact = unact.masked_fill(~valid[..., None], float("inf"))
    return unact, valid


def predict_event_num(counter: nn.Module, query_features: torch.Tensor) -> torch.Tensor:
    """Max-pool over queries, then the count head: (..., Q, D) -> (..., C)."""
    return counter(query_features.amax(dim=-2))


class DeformableTransformerEncoderLayer(nn.Module):
    """MSDA self-attention (sparse queries over the dense memory) + FFN."""

    tp_ffn = ("linear1", "dropout2", "linear2")  # parallel.tp's pairing

    def __init__(self, d_model, d_ffn, n_levels, n_heads, n_points, dropout=0.0):
        super().__init__()
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.dropout1 = Dropout(dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = Linear(d_model, d_ffn)
        self.dropout2 = Dropout(dropout)
        self.linear2 = Linear(d_ffn, d_model)
        self.dropout3 = Dropout(dropout)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, src, pos, reference_points, temporal_shapes,
                padding_mask=None, tgt=None):
        """Returns (output, sampling_locations, attention_weights)."""
        q_in = src if tgt is None else tgt
        q = q_in + pos if pos is not None else q_in
        out, loc, attn = self.self_attn(q, reference_points, src, temporal_shapes,
                                        padding_mask)
        x = self.norm1(q_in + self.dropout1(out))
        h = self.linear2(self.dropout2(F.relu(self.linear1(x))))
        return self.norm2(x + self.dropout3(h)), loc, attn


class DeformableTransformerDecoderLayer(nn.Module):
    """Self-attention over queries + MSDA cross-attention + FFN."""

    tp_ffn = ("linear1", "dropout3", "linear2")  # parallel.tp's pairing

    def __init__(self, d_model, d_ffn, n_levels, n_heads, n_points, dropout=0.0):
        super().__init__()
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.dropout1 = Dropout(dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.self_attn = CrossAttention(d_model, n_heads, qkv_bias=True,
                                        attention_dropout=dropout)
        self.dropout2 = Dropout(dropout)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = Linear(d_model, d_ffn)
        self.dropout3 = Dropout(dropout)
        self.linear2 = Linear(d_ffn, d_model)
        self.dropout4 = Dropout(dropout)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt, query_pos, reference_points, src, temporal_shapes,
                src_padding_mask=None):
        """Returns (output, sampling_locations, attention_weights)."""
        q = tgt + query_pos
        tgt = self.norm2(tgt + self.dropout2(self.self_attn(q, q, tgt)))
        ca, loc, attn = self.cross_attn(tgt + query_pos, reference_points, src,
                                        temporal_shapes, src_padding_mask)
        tgt = self.norm1(tgt + self.dropout1(ca))
        h = self.linear2(self.dropout3(F.relu(self.linear1(tgt))))
        return self.norm3(tgt + self.dropout4(h)), loc, attn


class SparseDeformableTransformer(nn.Module):
    """``with_query_head`` False leaves out ``reference_points_head``, which
    the multimodal family's per-modality preparation never calls (so flax
    never creates it there)."""

    def __init__(self, d_model=512, num_heads=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 num_feature_levels=4, dec_n_points=4, enc_n_points=4, rho=0.5,
                 with_query_head: bool = True):
        super().__init__()
        self.rho = rho
        self.level_embed = nn.Parameter(torch.randn(num_feature_levels, d_model))
        self.enc_layers = nn.ModuleList(
            DeformableTransformerEncoderLayer(
                d_model, dim_feedforward, num_feature_levels, num_heads, enc_n_points,
                dropout)
            for _ in range(num_encoder_layers))
        self.dec_layers = nn.ModuleList(
            DeformableTransformerDecoderLayer(
                d_model, dim_feedforward, num_feature_levels, num_heads, dec_n_points,
                dropout)
            for _ in range(num_decoder_layers))
        if rho:
            self.enc_mask_predictor = MaskPredictor(d_model, d_model)
            self.enc_output = Linear(d_model, d_model)
            self.enc_output_norm = nn.LayerNorm(d_model, eps=1e-5)
        if with_query_head:
            self.reference_points_head = Linear(d_model, 1)

    def prepare_encoder_inputs(self, srcs, masks, poses):
        """Flatten levels, add level embeds, and (sparse) select the top-K
        tokens by saliency. Returns a dict of src_flatten (B,S,D),
        mask_flatten (B,S), lvl_pos_flatten (B,S,D), valid_ratios (B,L),
        temporal_shapes and, when rho > 0, proposals (B,S,2) (the grid
        proposal bases, +inf where invalid), saliency (B,S) (the mask
        prediction), topk (B,K) and sparse_token_nums (B,); with rho = 0
        those four are None."""
        temporal_shapes = tuple(int(s.shape[1]) for s in srcs)
        src_flatten = torch.cat(srcs, dim=1)
        mask_flatten = torch.cat(masks, dim=1)
        lvl_pos_flatten = torch.cat(
            [pos + self.level_embed[lvl][None, None] for lvl, pos in enumerate(poses)],
            dim=1)
        valid_ratios = get_valid_ratios(masks)
        out = {
            "src_flatten": src_flatten,
            "mask_flatten": mask_flatten,
            "lvl_pos_flatten": lvl_pos_flatten,
            "valid_ratios": valid_ratios,
            "temporal_shapes": temporal_shapes,
            "proposals": None,
            "saliency": None,
            "topk": None,
            "sparse_token_nums": None,
        }
        if not self.rho:
            return out

        proposals_unact, _ = gen_encoder_output_proposals(temporal_shapes, mask_flatten)
        valid_token_nums = (~mask_flatten).sum(dim=1)
        S = src_flatten.shape[1]
        K = min(int(S * self.rho) + 1, S)
        sparse_token_nums = (valid_token_nums.float() * self.rho).to(torch.int32) + 1
        memory = src_flatten + lvl_pos_flatten
        proposal_valid = torch.isfinite(proposals_unact).all(dim=-1)
        zeroed = mask_flatten | ~proposal_valid
        memory = memory.masked_fill(zeroed[..., None], 0.0)
        memory = self.enc_output_norm(self.enc_output(memory))
        saliency = self.enc_mask_predictor(memory)  # (B, S)
        # the zeroed tokens of a video share one input row, so one saliency;
        # take it from the first of them, so that their ties are exact on
        # every device (a GEMM on the card may round equal rows apart) and
        # the stable sort breaks them by index. The value and the gradient
        # are those of the rows it replaces.
        first = zeroed.int().argmax(dim=1, keepdim=True)
        saliency = torch.where(zeroed, saliency.gather(1, first), saliency)
        # pad area takes the global minimum over the batch (over every data
        # rank's rows under parallel.mesh.data_parallel)
        saliency = torch.where(mask_flatten, global_min(saliency), saliency)
        topk = torch.sort(saliency, dim=1, descending=True, stable=True).indices[:, :K]
        out.update(proposals=proposals_unact, saliency=saliency, topk=topk,
                   sparse_token_nums=sparse_token_nums)
        return out

    def forward_encoder(self, enc_inputs):
        """Encoder stack. Sparse: the top-K tokens attend the dense memory
        and are scattered back into it after every layer. Dense: every token
        attends, and the memory is the layer's output. Returns (memory
        (B,S,D), sampling_locations and attention_weights (B,layers,Q,H,L,P)
        with Q = K or S, and, sparse only (else None), the sparse tokens
        after every layer but the last (layers-1,B,K,D) and their proposal
        bases (B,K,2))."""
        output = enc_inputs["src_flatten"]
        mask_flatten = enc_inputs["mask_flatten"]
        temporal_shapes = enc_inputs["temporal_shapes"]
        topk = enc_inputs["topk"]
        reference_points = get_encoder_reference_points(
            temporal_shapes, enc_inputs["valid_ratios"])
        if topk is None:
            locs, attns = [], []
            for layer in self.enc_layers:
                output, loc, attn = layer(output, enc_inputs["lvl_pos_flatten"],
                                          reference_points, temporal_shapes, mask_flatten)
                locs.append(loc)
                attns.append(attn)
            return output, torch.stack(locs, dim=1), torch.stack(attns, dim=1), None, None

        B, K = topk.shape
        rows = torch.arange(B, device=topk.device)[:, None].expand(B, K)
        ref_q = reference_points[rows, topk]  # (B, K, L, 1)
        tgt = output[rows, topk]
        pos_q = enc_inputs["lvl_pos_flatten"][rows, topk]
        keep = (torch.arange(K, device=topk.device)[None, :]
                < enc_inputs["sparse_token_nums"][:, None])
        locs, attns, inter = [], [], []
        for layer in self.enc_layers:
            tgt, loc, attn = layer(output, pos_q, ref_q, temporal_shapes, mask_flatten,
                                   tgt=tgt)
            vals = torch.where(keep[..., None], tgt, output[rows, topk])
            output = output.index_put((rows, topk), vals)
            locs.append(loc)
            attns.append(attn)
            inter.append(tgt)
        return (output, torch.stack(locs, dim=1), torch.stack(attns, dim=1),
                torch.stack(inter[:-1]) if len(inter) > 1 else None,
                enc_inputs["proposals"][rows, topk])

    def prepare_decoder_input_query(self, batch_size: int, query_embed: torch.Tensor):
        """Split the learned query embedding into (pos, tgt) and initialise
        the reference points with Linear + sigmoid. Returns
        (reference_points (B,Q,1), tgt (B,Q,D), query_pos (B,Q,D))."""
        query_pos, tgt = query_embed.chunk(2, dim=1)
        query_pos = query_pos[None].expand(batch_size, -1, -1)
        tgt = tgt[None].expand(batch_size, -1, -1)
        reference_points = torch.sigmoid(self.reference_points_head(query_pos).float())
        return reference_points, tgt, query_pos

    def forward_decoder(self, tgt, reference_points, memory, temporal_shapes,
                        valid_ratios, query_pos, mask_flatten):
        """Returns (intermediate (layers,B,Q,D), inter_references (layers,B,Q,1),
        sampling_locations and attention_weights (B,layers,Q,H,L,P)). Without
        segment refinement the reference points stay fixed."""
        output = tgt
        intermediate, inter_refs, locs, attns = [], [], [], []
        ref_input = reference_points[:, :, None, :] * valid_ratios[:, None, :, None]
        for layer in self.dec_layers:
            output, loc, attn = layer(output, query_pos, ref_input, memory,
                                      temporal_shapes, mask_flatten)
            intermediate.append(output)
            inter_refs.append(reference_points)
            locs.append(loc)
            attns.append(attn)
        return (torch.stack(intermediate), torch.stack(inter_refs),
                torch.stack(locs, dim=1), torch.stack(attns, dim=1))
