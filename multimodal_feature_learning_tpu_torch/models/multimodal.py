"""The video + audio family; counterpart of the JAX ``models/multimodal.py``.

* ``CrossModalEncoderLayer``: deformable self-attention within each
  modality, then deformable cross-modal attention (video queries sample the
  audio memory and audio queries the video memory, each with its own
  reference points), and one FFN shared by both streams.
* ``MultimodalProposalNet``: a base-encoder pyramid per modality, per
  modality top-rho token selection with scatter-back (rho = 0: every token a
  query), the cross-modal encoder, a decoder whose layers cross-attend both
  memories and join them through a concat bridge, and the segment and count
  heads. The mask-prediction keys of its outputs are the video stream's.
* ``MultimodalCaptionDecoder``: self-attention, vanilla cross-attention into
  each modality's cropped memory, a concat bridge and an MLP per layer; its
  KV-cached greedy decode and beam search.
* ``MultimodalDVC``: the family, sparse or dense, with the optional
  ``BiModalEncoder`` fusion ahead of the proposal stack and a context-mask
  model per modality. Unlike the unimodal families it materialises each
  event's crop of both memories, as the JAX package does.
* ``RawMultimodalDVC``: the same over raw frames and log-mel spectrograms,
  through the ViViT and AST backbones (``use_raw_videos``).

JAX's ``MultimodalDVC`` never reads ``compute_dtype``: it computes in f32
whatever the setting, and so does this one.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..config import check_decode_options
from ..device import resolve_device, set_f32_numerics
from ..ops.msda import check_msda_backend
from ..ops.segment_ops import denormalize_segments, inverse_sigmoid
from ..data.video_transforms import normalize
from .backbones import AudioSpectrogramTransformer, BiModalEncoder, VideoVisionTransformer
from .base_encoder import BaseEncoder, pyramid_shapes
from .caption_decoder import beam_loop, greedy_loop, make_causal_mask
from .dvc import crop_segments, match_layers
from .embeddings import VocabularyEmbedder, caption_positional_encoding
from .layers import FFN, MLP, ContextMaskModel, CrossAttention, Dropout, Linear, gelu
from .msda_module import MSDeformAttn
from .transformer import (SparseDeformableTransformer, get_encoder_reference_points,
                          predict_event_num)


class CrossModalEncoderLayer(nn.Module):
    """Deformable self-attention per modality + deformable cross-modal
    attention + the FFN, which both streams share."""

    tp_ffn = ("linear1", "dropout2", "linear2")  # parallel.tp's pairing

    def __init__(self, d_model, d_ffn, n_levels, n_heads, n_points, dropout=0.0):
        super().__init__()
        self.self_attn_video = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.self_attn_audio = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.cross_attn_v2a = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.cross_attn_a2v = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.dropout1 = Dropout(dropout)
        self.norm_v = nn.LayerNorm(d_model, eps=1e-5)
        self.norm_a = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = Linear(d_model, d_ffn)
        self.dropout2 = Dropout(dropout)
        self.linear2 = Linear(d_ffn, d_model)
        self.dropout3 = Dropout(dropout)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def _ffn(self, x):
        h = self.linear2(self.dropout2(F.relu(self.linear1(x))))
        return self.norm2(x + self.dropout3(h))

    def forward(self, video_src, audio_src, video_q, audio_q, video_pos, audio_pos,
                video_ref, audio_ref, video_shapes, audio_shapes, video_mask, audio_mask):
        """video_src (B, Sv, D) and audio_src (B, Sa, D) are the dense
        memories; video_q / audio_q the query tokens (None: the memory
        itself), with their pos embeds and reference points (B, Q, L, 1).
        Returns (audio_attended_visual, visual_attended_audio, v_loc, v_attn,
        a_loc, a_attn) for the query tokens."""
        vq = video_src if video_q is None else video_q
        aq = audio_src if audio_q is None else audio_q
        v2, _, _ = self.self_attn_video(vq + video_pos, video_ref, video_src, video_shapes,
                                        video_mask)
        vq = self.norm_v(vq + self.dropout1(v2))
        a2, _, _ = self.self_attn_audio(aq + audio_pos, audio_ref, audio_src, audio_shapes,
                                        audio_mask)
        aq = self.norm_a(aq + self.dropout1(a2))
        # each modality's queries sample the other memory, at their own
        # reference points (scaled by their own valid ratios)
        aav, v_loc, v_attn = self.cross_attn_v2a(vq, video_ref, audio_src, audio_shapes,
                                                 audio_mask)
        vaa, a_loc, a_attn = self.cross_attn_a2v(aq, audio_ref, video_src, video_shapes,
                                                 video_mask)
        return self._ffn(aav), self._ffn(vaa), v_loc, v_attn, a_loc, a_attn


class MultimodalDecoderLayer(nn.Module):
    """Query self-attention + a deformable cross-attention into each memory +
    the concat bridge LN(2D) -> Linear -> dropout -> ReLU + FFN."""

    tp_ffn = ("linear1", "dropout3", "linear2")  # parallel.tp's pairing

    def __init__(self, d_model, d_ffn, n_levels, n_heads, n_points, dropout=0.0):
        super().__init__()
        self.self_attn = CrossAttention(d_model, n_heads, qkv_bias=True,
                                        attention_dropout=dropout)
        self.dropout2 = Dropout(dropout)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.cross_attn_video = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.cross_attn_audio = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.dropout1 = Dropout(dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm4 = nn.LayerNorm(2 * d_model, eps=1e-5)
        self.linear3 = Linear(2 * d_model, d_model)
        self.dropout5 = Dropout(dropout)
        self.linear1 = Linear(d_model, d_ffn)
        self.dropout3 = Dropout(dropout)
        self.linear2 = Linear(d_ffn, d_model)
        self.dropout4 = Dropout(dropout)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt, query_pos, video_ref, audio_ref, video_src, audio_src,
                video_shapes, audio_shapes, video_mask, audio_mask):
        """Returns (output, v_loc, v_attn, a_loc, a_attn)."""
        q = tgt + query_pos
        tgt = self.norm2(tgt + self.dropout2(self.self_attn(q, q, tgt)))
        q2 = tgt + query_pos
        tv, v_loc, v_attn = self.cross_attn_video(q2, video_ref, video_src, video_shapes,
                                                  video_mask)
        tv = self.norm1(tgt + self.dropout1(tv))
        ta, a_loc, a_attn = self.cross_attn_audio(q2, audio_ref, audio_src, audio_shapes,
                                                  audio_mask)
        ta = self.norm1(tgt + self.dropout1(ta))
        x = F.relu(self.dropout5(self.linear3(self.norm4(torch.cat([tv, ta], dim=-1)))))
        h = self.linear2(self.dropout3(F.relu(self.linear1(x))))
        return self.norm3(x + self.dropout4(h)), v_loc, v_attn, a_loc, a_attn


def _select(enc_inputs):
    """The query side of one modality: its top-K tokens (sparse) or all of
    them (dense, ``q`` None), with their pos embeds, reference points and the
    scatter-back bookkeeping."""
    refs = get_encoder_reference_points(enc_inputs["temporal_shapes"],
                                        enc_inputs["valid_ratios"])
    topk = enc_inputs["topk"]
    if topk is None:
        return {"q": None, "pos": enc_inputs["lvl_pos_flatten"], "ref": refs, "topk": None}
    B, K = topk.shape
    rows = torch.arange(B, device=topk.device)[:, None].expand(B, K)
    keep = (torch.arange(K, device=topk.device)[None, :]
            < enc_inputs["sparse_token_nums"][:, None])
    return {"q": enc_inputs["src_flatten"][rows, topk],
            "pos": enc_inputs["lvl_pos_flatten"][rows, topk], "ref": refs[rows, topk],
            "rows": rows, "topk": topk, "keep": keep}


def _scatter_back(output, q_new, sel):
    """(memory, queries) after a layer: the first sparse_token_nums[b] query
    tokens written back into the memory (sparse); dense, both are q_new."""
    if sel["topk"] is None:
        return q_new, q_new
    rows, topk = sel["rows"], sel["topk"]
    vals = torch.where(sel["keep"][..., None], q_new, output[rows, topk])
    return output.index_put((rows, topk), vals), q_new


class MultimodalProposalNet(nn.Module):
    """Two base-encoder pyramids -> cross-modal (sparse) encoder ->
    multimodal decoder -> segment/count heads. ``video_prep`` and
    ``audio_prep`` are transformers without layers that only prepare each
    modality's tokens (and select them when rho > 0)."""

    def __init__(self, d_model=512, feature_dim=512, num_queries=20, num_feature_levels=4,
                 num_heads=8, enc_layers=6, dec_layers=6, ff_dim=2048, dropout=0.1,
                 enc_n_points=4, dec_n_points=4, rho=0.5, max_eseq_length=10):
        super().__init__()
        self.video_base_encoder = BaseEncoder(num_feature_levels, d_model, feature_dim)
        self.audio_base_encoder = BaseEncoder(num_feature_levels, d_model, feature_dim)
        kw = dict(d_model=d_model, num_heads=num_heads, num_encoder_layers=0,
                  num_decoder_layers=0, dim_feedforward=ff_dim, dropout=dropout,
                  num_feature_levels=num_feature_levels, rho=rho, with_query_head=False)
        self.video_prep = SparseDeformableTransformer(**kw)
        self.audio_prep = SparseDeformableTransformer(**kw)
        self.enc_layers_mod = nn.ModuleList(
            CrossModalEncoderLayer(d_model, ff_dim, num_feature_levels, num_heads,
                                   enc_n_points, dropout)
            for _ in range(enc_layers))
        self.dec_layers_mod = nn.ModuleList(
            MultimodalDecoderLayer(d_model, ff_dim, num_feature_levels, num_heads,
                                   dec_n_points, dropout)
            for _ in range(dec_layers))
        self.query_embedding = nn.Parameter(torch.randn(num_queries, 2 * d_model))
        self.reference_points_head = Linear(d_model, 1)
        self.segment_embedding_decoder = FFN(d_model, d_model, 2, 3, final_zero_init=True)
        self.count_head_decoder = Linear(d_model, max_eseq_length + 1)

    def forward(self, video, video_mask, audio, audio_mask, durations) -> Dict:
        """video (B, Tv, F), audio (B, Ta, F), masks True=pad, durations (B,)
        -> every output the matcher, the crops, the caption decoder and the
        criterion read."""
        B = video.shape[0]
        v_in = self.video_prep.prepare_encoder_inputs(
            *self.video_base_encoder(video, video_mask, durations))
        a_in = self.audio_prep.prepare_encoder_inputs(
            *self.audio_base_encoder(audio, audio_mask, durations))
        v_shapes, a_shapes = v_in["temporal_shapes"], a_in["temporal_shapes"]
        v_sel, a_sel = _select(v_in), _select(a_in)

        video_out, audio_out = v_in["src_flatten"], a_in["src_flatten"]
        vq, aq = v_sel["q"], a_sel["q"]
        for layer in self.enc_layers_mod:
            aav, vaa, *_ = layer(video_out, audio_out, vq, aq, v_sel["pos"], a_sel["pos"],
                                 v_sel["ref"], a_sel["ref"], v_shapes, a_shapes,
                                 v_in["mask_flatten"], a_in["mask_flatten"])
            video_out, vq = _scatter_back(video_out, aav, v_sel)
            audio_out, aq = _scatter_back(audio_out, vaa, a_sel)

        query_pos, tgt = self.query_embedding.chunk(2, dim=1)
        query_pos = query_pos[None].expand(B, -1, -1)
        output = tgt[None].expand(B, -1, -1)
        reference_points = torch.sigmoid(self.reference_points_head(query_pos))  # (B, Q, 1)
        v_ref = reference_points[:, :, None, :] * v_in["valid_ratios"][:, None, :, None]
        a_ref = reference_points[:, :, None, :] * a_in["valid_ratios"][:, None, :, None]
        inter, v_locs, v_attns, a_locs, a_attns = [], [], [], [], []
        for layer in self.dec_layers_mod:
            output, v_loc, v_attn, a_loc, a_attn = layer(
                output, query_pos, v_ref, a_ref, video_out, audio_out, v_shapes, a_shapes,
                v_in["mask_flatten"], a_in["mask_flatten"])
            inter.append(output)
            v_locs.append(v_loc)
            v_attns.append(v_attn)
            a_locs.append(a_loc)
            a_attns.append(a_attn)

        query_features = torch.stack(inter)  # (layers, B, Q, D)
        outputs_count = predict_event_num(self.count_head_decoder, query_features)
        # without refinement every layer's reference is the initial one
        outputs_segment = torch.sigmoid(self.segment_embedding_decoder(query_features)
                                        + inverse_sigmoid(reference_points)[None])
        starts = [0]
        for t in v_shapes[:-1]:
            starts.append(starts[-1] + int(t))
        out = {
            "pred_segments": outputs_segment[-1],
            "pred_count": outputs_count[-1],
            "outputs_segment_all": outputs_segment,
            "outputs_count_all": outputs_count,
            "video_memory": video_out,
            "audio_memory": audio_out,
            "query_features": query_features,
            "video_temporal_shapes": v_shapes,
            "audio_temporal_shapes": a_shapes,
            # the mask-prediction keys are the video stream's
            "temporal_shapes": v_shapes,
            "level_start_index": tuple(starts),
            "sampling_locations_dec": torch.stack(v_locs, dim=1),
            "attn_weights_dec": torch.stack(v_attns, dim=1),
            "audio_sampling_locations_dec": torch.stack(a_locs, dim=1),
            "audio_attn_weights_dec": torch.stack(a_attns, dim=1),
            "mask_flatten": v_in["mask_flatten"],
        }
        if v_in["topk"] is not None:
            out["backbone_mask_prediction"] = v_in["saliency"]
            out["backbone_topk_proposals"] = v_in["topk"]
            out["sparse_token_nums"] = v_in["sparse_token_nums"]
        return out


class MultimodalCaptionDecoderLayer(nn.Module):
    """Post-norm block: self-attention, a vanilla cross-attention into each
    modality's memory, the concat bridge Linear(2D -> D) -> dropout -> LN ->
    GELU, and the MLP."""

    def __init__(self, d_model: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, attention_dropout: float = 0.0,
                 projection_dropout: float = 0.0, bridge_dropout: float = 0.0,
                 mlp_dropout_1: float = 0.0, mlp_dropout_2: float = 0.0):
        super().__init__()
        self.self_attention = CrossAttention(d_model, num_heads, qkv_bias, attention_dropout)
        self.video_cross_attention = CrossAttention(d_model, num_heads, qkv_bias,
                                                    attention_dropout)
        self.audio_cross_attention = CrossAttention(d_model, num_heads, qkv_bias,
                                                    attention_dropout)
        self.drop_1 = Dropout(projection_dropout)
        self.drop_2 = Dropout(projection_dropout)
        self.drop_3 = Dropout(projection_dropout)
        self.linear_layer = Linear(2 * d_model, d_model)
        self.bridge_drop = Dropout(bridge_dropout)
        self.layer_norm_1 = nn.LayerNorm(d_model, eps=1e-6)
        self.layer_norm_2 = nn.LayerNorm(d_model, eps=1e-6)
        self.layer_norm_3 = nn.LayerNorm(d_model, eps=1e-6)
        self.layer_norm_4 = nn.LayerNorm(d_model, eps=1e-6)
        self.mlp = MLP(d_model, int(d_model * mlp_ratio), d_model, mlp_dropout_1,
                       mlp_dropout_2)

    def _after_cross(self, x, cav, caa):
        """The two cross-attention residuals, the bridge and the MLP."""
        vid_x = self.layer_norm_2(x + self.drop_2(cav))
        aud_x = self.layer_norm_2(x + self.drop_3(caa))
        x = self.linear_layer(torch.cat([vid_x, aud_x], dim=-1))
        x = gelu(self.layer_norm_3(self.bridge_drop(x)))
        return self.layer_norm_4(x + self.mlp(x))

    def forward(self, target, video_memory, audio_memory, tgt_mask=None,
                tgt_padding_mask=None, video_memory_padding_mask=None,
                audio_memory_padding_mask=None):
        """Teacher-forced pass over a whole caption: target (N, Tc, D),
        memories (N, S, D), masks True=masked."""
        sa = self.self_attention(target, target, target, key_padding_mask=tgt_padding_mask,
                                 attn_mask=tgt_mask)
        x = self.layer_norm_1(target + self.drop_1(sa))
        cav = self.video_cross_attention(x, video_memory, video_memory,
                                         key_padding_mask=video_memory_padding_mask)
        caa = self.audio_cross_attention(x, audio_memory, audio_memory,
                                         key_padding_mask=audio_memory_padding_mask)
        return self._after_cross(x, cav, caa)

    def project_memory_kv(self, video_memory, audio_memory):
        """The two cross-attentions' k/v of the memories, once per decode."""
        return (self.video_cross_attention.project_kv(video_memory, video_memory),
                self.audio_cross_attention.project_kv(audio_memory, audio_memory))

    def incremental_pair(self, x, step: int, k_cache, v_cache, valid_len: int, vid_kv,
                         aud_kv, video_memory_padding_mask, audio_memory_padding_mask):
        """One layer pass for two positions (x (N, 2, D)): row 0 writes its
        k/v into the caches at ``step`` and both rows attend keys
        [0, valid_len), as ``UnimodalCaptionDecoderLayer.incremental_pair``.
        The caches are written in place."""
        N, Tc = x.shape[0], k_cache.shape[1]
        kx, vx = self.self_attention.project_kv(x[:, :1], x[:, :1])
        k_cache[:, step] = kx[:, 0]
        v_cache[:, step] = vx[:, 0]
        key_mask = (torch.arange(Tc, device=x.device) >= valid_len)[None].expand(N, Tc)
        sa = self.self_attention.attend(self.self_attention.project_q(x), k_cache, v_cache,
                                        key_padding_mask=key_mask)
        x = self.layer_norm_1(x + sa)
        cav = self.video_cross_attention.attend(
            self.video_cross_attention.project_q(x), *vid_kv,
            key_padding_mask=video_memory_padding_mask)
        caa = self.audio_cross_attention.attend(
            self.audio_cross_attention.project_q(x), *aud_kv,
            key_padding_mask=audio_memory_padding_mask)
        return self._after_cross(x, cav, caa)


class MultimodalCaptionDecoder(nn.Module):
    def __init__(self, vocab_size: int, d_model: int = 512, depth: int = 6,
                 num_heads: int = 8, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 positional_embedding_dropout: float = 0.0, attention_dropout: float = 0.0,
                 projection_dropout: float = 0.0, bridge_dropout: float = 0.0,
                 mlp_dropout_1: float = 0.0, mlp_dropout_2: float = 0.0, embedding_matrix=None,
                 return_intermediate: bool = True):
        super().__init__()
        self.depth = depth
        self.return_intermediate = return_intermediate
        self.target_embedding = VocabularyEmbedder(vocab_size, d_model, embedding_matrix)
        self.register_buffer("pos_table", caption_positional_encoding(d_model),
                             persistent=False)
        self.pos_dropout = Dropout(positional_embedding_dropout)
        self.decoder = nn.ModuleList(
            MultimodalCaptionDecoderLayer(d_model, num_heads, mlp_ratio, qkv_bias,
                                          attention_dropout, projection_dropout,
                                          bridge_dropout, mlp_dropout_1, mlp_dropout_2)
            for _ in range(depth))
        self.head = Linear(d_model, vocab_size)

    def forward(self, tgt, video_memory, audio_memory, tgt_mask=None, tgt_padding_mask=None,
                video_memory_padding_mask=None, audio_memory_padding_mask=None,
                log_probs: bool = False):
        """Teacher-forced pass: tgt (N, Tc) -> the (depth, N, Tc, V) stack of
        raw logits (of the last layer alone, (1, N, Tc, V), without
        ``return_intermediate``), or with ``log_probs`` f32 log-probabilities."""
        x = self.pos_dropout(self.target_embedding(tgt) + self.pos_table[:, :tgt.shape[1]])
        if tgt_mask is not None and tgt_mask.dim() == 2:
            tgt_mask = tgt_mask[None, None]
        intermediate = []
        for layer in self.decoder:
            x = layer(x, video_memory, audio_memory, tgt_mask, tgt_padding_mask,
                      video_memory_padding_mask, audio_memory_padding_mask)
            if self.return_intermediate:
                intermediate.append(x)
        logits = self.head(torch.stack(intermediate) if self.return_intermediate else x[None])
        return torch.log_softmax(logits.float(), dim=-1) if log_probs else logits

    def embed_at(self, tokens: torch.Tensor, pos: int) -> torch.Tensor:
        """(N,) tokens at position ``pos`` -> (N, 1, D) with the sine table."""
        return self.target_embedding(tokens[:, None]) + self.pos_table[:, pos:pos + 1]

    def precompute_memory_kv(self, video_memory, audio_memory):
        """Per layer ((video k, v), (audio k, v))."""
        return [layer.project_memory_kv(video_memory, audio_memory) for layer in self.decoder]

    def decode_pair(self, prev_tokens, pad_tokens, step: int, k_caches, v_caches, mem_kv,
                    video_mask, audio_mask):
        """Commit ``prev_tokens`` at ``step`` and predict position step+1 in
        one pass through every layer; f32 logits. The caches (depth, N, Tc,
        D) are updated in place."""
        x = torch.cat([self.embed_at(prev_tokens, step),
                       self.embed_at(pad_tokens, step + 1)], dim=1)
        for li, layer in enumerate(self.decoder):
            vid_kv, aud_kv = mem_kv[li]
            x = layer.incremental_pair(x, step, k_caches[li], v_caches[li], step + 1,
                                       vid_kv, aud_kv, video_mask, audio_mask)
        return self.head(x[:, 1, :]).float()


def multimodal_greedy_decode(module: MultimodalCaptionDecoder, video_memory, video_mask,
                             audio_memory, audio_mask, seq_len: int, bos_idx: int,
                             eos_idx: int, pad_idx: int, faster_eval: bool = False):
    """KV-cached greedy decode over both memories (N, S, D), with the rules
    of ``caption_decoder.greedy_loop``. Returns (N, seq_len + 1) int64 token
    ids including <bos>."""
    N, _, D = video_memory.shape
    mem_kv = module.precompute_memory_kv(video_memory, audio_memory)
    pad_tok = torch.full((N,), pad_idx, dtype=torch.long, device=video_memory.device)
    k_caches = video_memory.new_zeros((module.depth, N, seq_len, D))
    v_caches = video_memory.new_zeros((module.depth, N, seq_len, D))

    def step_logits(prev_tokens, t):
        return module.decode_pair(prev_tokens, pad_tok, t - 1, k_caches, v_caches, mem_kv,
                                  video_mask, audio_mask)

    return greedy_loop(step_logits, N, seq_len, bos_idx, eos_idx, pad_idx,
                       video_memory.device, faster_eval)


def multimodal_beam_search_decode(module: MultimodalCaptionDecoder, video_memory, video_mask,
                                  audio_memory, audio_mask, seq_len: int, bos_idx: int,
                                  eos_idx: int, pad_idx: int, beam_size: int = 4,
                                  length_penalty: float = 0.0):
    """Batched beam search over both memories (N, S, D), with the rules of
    ``caption_decoder.beam_loop``; the memories' k/v are projected once and
    repeated per beam. Returns (N, seq_len + 1) int64 captions of the best
    beam."""
    N, K = video_memory.shape[0], beam_size
    mem_kv = [tuple(tuple(t.repeat_interleave(K, dim=0) for t in kv) for kv in layer_kv)
              for layer_kv in module.precompute_memory_kv(video_memory, audio_memory)]
    vmask = video_mask.repeat_interleave(K, dim=0)
    amask = audio_mask.repeat_interleave(K, dim=0)
    pad_tok = torch.full((N * K,), pad_idx, dtype=torch.long, device=video_memory.device)

    def step_logits(prev_tokens, t, k_caches, v_caches):
        return module.decode_pair(prev_tokens, pad_tok, t - 1, k_caches, v_caches, mem_kv,
                                  vmask, amask)

    return beam_loop(step_logits, N, K, seq_len, video_memory, module.depth, bos_idx, eos_idx,
                     pad_idx, length_penalty)


class MultimodalDVC(nn.Module):
    """The video + audio family on precomputed features: sparse
    (``dvc.use_sparse_detr``) or dense (``dvc.use_deformable_detr``), with
    the BiModalEncoder fusion when ``dvc.use_bimodal_encoder``. The module
    tree mirrors the JAX params tree (``bimodal``, ``proposal``, ``caption``,
    ``video_context_mask``, ``audio_context_mask``)."""

    def __init__(self, cfg, vocab_size: int, pad_idx: int = 1, bos_idx: int = 2,
                 eos_idx: int = 3, feature_dim: int = 0, embedding_matrix=None):
        """``feature_dim``: the width of the features the proposal stack
        reads (0: ``dvc.detr.feature_dim``); ``embedding_matrix``: GloVe's
        (vocab, dim) for the caption decoder's embedding, or None."""
        super().__init__()
        dvc, det = cfg.dvc, cfg.dvc.detr
        anet = cfg.dataset.activity_net
        self.pad_idx, self.bos_idx, self.eos_idx = pad_idx, bos_idx, eos_idx
        self.num_queries = dvc.num_queries
        self.aux_loss = dvc.aux_loss
        self.cost_segment = float(dvc.matcher.cost_segment)
        self.cost_giou = float(dvc.matcher.cost_giou)
        self.max_gt = anet.max_gt_target_segments
        self.seq_len = anet.max_caption_len_all
        self.video_rescale_len = det.video_rescale_len
        self.audio_rescale_len = anet.audio_rescale_len
        self.num_feature_levels = det.num_feature_levels
        self.use_differentiable_mask = cfg.use_differentiable_mask
        if dvc.use_bimodal_encoder:
            self.bimodal = BiModalEncoder(det.feature_dim, dvc.bimodal_depth, det.num_heads)
        self.proposal = MultimodalProposalNet(
            d_model=dvc.d_model, feature_dim=feature_dim or det.feature_dim,
            num_queries=dvc.num_queries,
            num_feature_levels=det.num_feature_levels, num_heads=det.num_heads,
            enc_layers=det.enc_layers, dec_layers=det.dec_layers,
            ff_dim=det.transformer_ff_dim, dropout=det.transformer_dropout_prob,
            enc_n_points=det.enc_n_points, dec_n_points=det.dec_n_points,
            rho=det.rho if dvc.use_sparse_detr else 0.0,
            max_eseq_length=dvc.max_eseq_length)
        check_msda_backend(cfg.msda_backend)  # every name runs K1 / K2 (ops/msda.py)
        cap = dvc.caption
        # JAX's multimodal caption layers have no pre-norm form: cap.pre_norm
        # is ignored here, as it is there
        self.caption = MultimodalCaptionDecoder(
            vocab_size, cap.d_model, cap.depth, cap.num_heads, float(cap.mlp_ratio),
            cap.qkv_bias, cap.positional_embedding_dropout, cap.attention_dropout,
            cap.projection_dropout, cap.bridge_dropout, cap.mlp_dropout_1, cap.mlp_dropout_2,
            embedding_matrix, return_intermediate=cap.return_intermediate)
        if self.use_differentiable_mask:
            shapes = (det.video_rescale_len, anet.audio_rescale_len)
            n_video, n_audio = (sum(pyramid_shapes(t, det.num_feature_levels)) for t in shapes)
            self.video_context_mask = ContextMaskModel(dvc.d_model + 2, n_video)
            self.audio_context_mask = ContextMaskModel(dvc.d_model + 2, n_audio)

    def _propose_and_match(self, batch):
        """The proposal forward (after the BiModalEncoder when there is
        one), then the Hungarian matching of the final and, with the
        auxiliary loss, every auxiliary decoder layer. Returns (out, indices
        (B,G), indices_aux (layers-1,B,G) or None)."""
        video, audio = batch["video_tensor"], batch["audio_tensor"]
        if hasattr(self, "bimodal"):
            video, audio = self.bimodal(video, audio)
        out = self.proposal(video, batch["video_mask"], audio, batch["audio_mask"],
                            batch["durations"])
        return (out, *match_layers(self, out["outputs_segment_all"], batch, self.aux_loss))

    def _prepare_caption_inputs(self, out, durations, indices):
        """Each event's crop of both memories and, when configured, the
        context masks. Returns, per modality, (crop (N,S,D), crop mask
        (N,S), caption pad mask (N,S), context-mask logits (N,S) or None)."""
        B, G = indices.shape
        N = B * G
        rows = torch.arange(B, device=indices.device)[:, None]
        denorm = denormalize_segments(out["pred_segments"][rows, indices], durations[:, None])
        crops = []
        for name, rescale_len in (("video", self.video_rescale_len),
                                  ("audio", self.audio_rescale_len)):
            crop, mask = crop_segments(out[f"{name}_memory"], denorm, durations, rescale_len,
                                       self.num_feature_levels)
            crops.append([crop.reshape(N, -1, crop.shape[-1]), mask.reshape(N, -1)])
        if self.use_differentiable_mask:
            qf = out["query_features"][-1][rows, indices].reshape(N, -1)
            cm_in = torch.cat([denorm.reshape(N, 2), qf], dim=1)
            for entry, model in zip(crops, (self.video_context_mask, self.audio_context_mask)):
                logits = model(cm_in)
                entry += [torch.sigmoid(logits) > 0.5, logits]
        else:
            for entry in crops:
                entry += [entry[1], None]
        return crops

    def _aux_outputs(self, out):
        return [{"pred_segments": out["outputs_segment_all"][i],
                 "pred_count": out["outputs_count_all"][i]}
                for i in range(out["outputs_segment_all"].shape[0] - 1)]

    def _caption_pass(self, batch, video, audio, log_probs: bool):
        tgt = batch["cap_tokens"].reshape(-1, self.seq_len)[:, :-1].long()
        return self.caption(tgt, video[0], audio[0],
                            make_causal_mask(self.seq_len - 1, tgt.device),
                            tgt == self.pad_idx, video[2], audio[2], log_probs=log_probs)

    def forward_train(self, batch):
        """Training forward over a batch dict of tensors (the audio keys
        included). Returns (out, indices, indices_aux, memory_mask (video
        crop mask (N,Sv), audio crop mask (N,Sa)) as f32), as JAX's."""
        out, indices, indices_aux = self._propose_and_match(batch)
        video, audio = self._prepare_caption_inputs(out, batch["durations"], indices)
        if video[3] is not None:
            out["video_pred_memory_mask"], out["audio_pred_memory_mask"] = video[3], audio[3]
        logits = self._caption_pass(batch, video, audio, log_probs=False)
        out["pred_captions"] = logits[-1]
        out["caption_head"] = "logits"
        if self.aux_loss:
            out["aux_outputs"] = self._aux_outputs(out)
            out["pred_captions_all"] = logits
        return out, indices, indices_aux, (video[1].float(), audio[1].float())

    @torch.no_grad()
    def forward_eval(self, batch, val_mode: str = "one_by_one", faster_eval: bool = False,
                     beam_size: int = 0, length_penalty: float = 0.0):
        """Evaluation forward, as JAX's: the matching, the teacher-forced
        log-probabilities (``pred_captions``, and with the auxiliary loss
        ``aux_outputs`` and ``aux_outputs_caption``), and the captions of
        ``val_mode``: "one_by_one" the greedy decode (with ``faster_eval``),
        "beam" the beam search (``beam_size``, 4 when 0), "teacher_forcing"
        the last layer's argmax. There is no "serve" mode. Returns (out,
        captions, indices, indices_aux, (video, audio) crop masks)."""
        check_decode_options(val_mode=val_mode)
        if val_mode == "serve":
            raise ValueError("the multimodal family has no 'serve' val_mode; use one_by_one, "
                             "teacher_forcing or beam")
        out, indices, indices_aux = self._propose_and_match(batch)
        video, audio = self._prepare_caption_inputs(out, batch["durations"], indices)
        if video[3] is not None:
            out["video_pred_memory_mask"], out["audio_pred_memory_mask"] = video[3], audio[3]
        log_probs = self._caption_pass(batch, video, audio, log_probs=True)
        decode_args = (video[0], video[2], audio[0], audio[2], self.seq_len, self.bos_idx,
                       self.eos_idx, self.pad_idx)
        if val_mode == "one_by_one":
            captions = multimodal_greedy_decode(self.caption, *decode_args,
                                                faster_eval=faster_eval)
        elif val_mode == "beam":
            captions = multimodal_beam_search_decode(
                self.caption, *decode_args, beam_size=beam_size or 4,
                length_penalty=length_penalty)
        else:
            captions = log_probs[-1].argmax(dim=-1)
        out["pred_captions"] = log_probs[-1]
        if self.aux_loss:
            out["aux_outputs"] = self._aux_outputs(out)
            out["aux_outputs_caption"] = [{"pred_captions": log_probs[i]}
                                          for i in range(log_probs.shape[0] - 1)]
        return out, captions, indices, indices_aux, (video[1].float(), audio[1].float())


class RawMultimodalDVC(MultimodalDVC):
    """The full raw pipeline (BASELINE config #5): uint8 frames, normalised
    on the model's device, through ViViT (``video_backbone``) and log-mel
    spectrograms through AST (``audio_backbone``); their features, with
    all-false masks, replace the batch's video and audio tensors ahead of
    the multimodal stack. The backbones emit d_model-wide features, so the
    proposal stack reads d_model. As in JAX, the pyramids follow the
    backbones' token counts, while the crop windows and the context masks
    follow ``video_rescale_len`` / ``audio_rescale_len``: a configuration
    should make them equal."""

    def __init__(self, cfg, vocab_size: int, pad_idx: int = 1, bos_idx: int = 2,
                 eos_idx: int = 3, embedding_matrix=None):
        super().__init__(cfg, vocab_size, pad_idx, bos_idx, eos_idx,
                         feature_dim=cfg.dvc.d_model, embedding_matrix=embedding_matrix)
        viv, ast = cfg.dvc.vivit, cfg.dvc.ast
        self.video_backbone = VideoVisionTransformer(
            model_name=viv.model_name, d_model=cfg.dvc.d_model, depth=viv.depth,
            temporal_depth=viv.temporal_depth, num_heads=viv.num_heads,
            spatial_patch_size=viv.spatial_patch_size,
            temporal_patch_size=viv.temporal_patch_size)
        self.audio_backbone = AudioSpectrogramTransformer(
            d_model=cfg.dvc.d_model, depth=ast.depth, num_heads=ast.num_heads,
            patch_size=ast.patch_size, frequency_stride=ast.frequency_stride,
            time_stride=ast.time_stride)

    def backbone_features(self, batch):
        """(ViViT features (B, T', D), AST features (B, P + 2, D)) of the
        batch's frames (uint8 are normalised here) and spectrograms."""
        frames = batch["video_tensor"]
        if frames.dtype == torch.uint8:
            frames = normalize(frames)
        return self.video_backbone(frames), self.audio_backbone(batch["audio_tensor"])

    def _propose_and_match(self, batch):
        vfeat, afeat = self.backbone_features(batch)
        feat_batch = dict(batch)
        feat_batch["video_tensor"], feat_batch["audio_tensor"] = vfeat, afeat
        feat_batch["video_mask"] = torch.zeros(vfeat.shape[:2], dtype=torch.bool,
                                               device=vfeat.device)
        feat_batch["audio_mask"] = torch.zeros(afeat.shape[:2], dtype=torch.bool,
                                               device=afeat.device)
        return super()._propose_and_match(feat_batch)


def build_multimodal_model(cfg, vocab_size: int, pad_idx: int = 1, bos_idx: int = 2,
                           eos_idx: int = 3, device="cuda", seed: int = 0,
                           embedding_matrix=None) -> MultimodalDVC:
    """The multimodal model in eval mode on ``device``, its weights drawn
    from ``seed`` (the caption embedding from ``embedding_matrix`` when one
    is given): ``RawMultimodalDVC`` with ``use_raw_videos``, else
    ``MultimodalDVC``."""
    cls = RawMultimodalDVC if cfg.use_raw_videos else MultimodalDVC
    dev = resolve_device(device)
    set_f32_numerics(dev)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = cls(cfg, vocab_size, pad_idx, bos_idx, eos_idx, embedding_matrix=embedding_matrix)
    return model.to(dev).eval()
