"""The regular (non-deformable) family; counterpart of the JAX
``models/regular_dvc.py``.

A vanilla query decoder (self-attention, cross-attention into the frame
memory, MLP; post-norm) straight over single-scale frame features, optionally
fed by its own ViViT over raw frames (``use_raw_videos``), then class,
segment and count heads, the Hungarian matching (K6 on the card), each
matched event's materialised crop of the memory and the caption decoder,
as the other families. JAX's ``RegularDVC`` takes no ``decode_impl`` and no
``compute_dtype``: its decode is the plain-op greedy decode or beam search
and it computes in f32, and so does this one.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..config import check_decode_options
from ..data.video_transforms import normalize
from ..device import resolve_device, set_f32_numerics
from ..ops.segment_ops import denormalize_segments
from .backbones import VideoVisionTransformer
from .caption_decoder import (UnimodalCaptionDecoder, beam_search_decode, greedy_decode,
                              make_causal_mask)
from .dvc import crop_segments, match_layers
from .layers import FFN, MLP, ContextMaskModel, CrossAttention, Dropout, Linear
from .transformer import predict_event_num


class RegularDecoderLayer(nn.Module):
    """Post-norm decoder block: x = LN(tgt + self-attention), LN(x +
    cross-attention into the memory), LN(x + MLP); dropout after each
    attention's softmax and on each attention's output."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.self_attention = CrossAttention(d_model, num_heads, attention_dropout=dropout)
        self.cross_attention = CrossAttention(d_model, num_heads, attention_dropout=dropout)
        self.drop1 = Dropout(dropout)
        self.drop2 = Dropout(dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-6)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-6)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-6)
        self.mlp = MLP(d_model, 4 * d_model, d_model)

    def forward(self, tgt, memory, memory_padding_mask=None):
        x = self.norm1(tgt + self.drop1(self.self_attention(tgt, tgt, tgt)))
        ca = self.cross_attention(x, memory, memory, key_padding_mask=memory_padding_mask)
        x = self.norm2(x + self.drop2(ca))
        return self.norm3(x + self.mlp(x))


class RegularProposalNet(nn.Module):
    """[ViViT ->] input projection -> ``depth`` decoder layers over learned
    queries -> class (softmaxed), segment and count heads."""

    def __init__(self, d_model: int = 512, feature_dim: int = 512, num_queries: int = 20,
                 depth: int = 6, num_heads: int = 8, max_eseq_length: int = 10,
                 num_classes: int = 200, dropout: float = 0.1, use_vivit: bool = False,
                 vivit_mode: str = "factorised encoder", vivit_depth: int = 4,
                 vivit_temporal_depth: int = 2):
        super().__init__()
        if use_vivit:
            self.backbone = VideoVisionTransformer(
                model_name=vivit_mode, d_model=d_model, depth=vivit_depth,
                temporal_depth=vivit_temporal_depth, num_heads=num_heads)
        self.input_proj = Linear(d_model if use_vivit else feature_dim, d_model)
        self.query_embedding = nn.Parameter(torch.randn(num_queries, d_model))
        self.decoder = nn.ModuleList(RegularDecoderLayer(d_model, num_heads, dropout)
                                     for _ in range(depth))
        self.class_embedding = Linear(d_model, num_classes + 1)
        self.segment_embedding = FFN(d_model, d_model, 2, 3, final_zero_init=True)
        self.count_head = Linear(d_model, max_eseq_length + 1)

    def forward(self, video, video_mask) -> Dict:
        """video: features (B, T, F), or raw frames (B, T, H, W, C) (uint8
        are normalised here) with the ViViT; video_mask (B, T) True=pad."""
        if hasattr(self, "backbone"):
            if video.dtype == torch.uint8:
                video = normalize(video)
            video = self.backbone(video)
        memory = self.input_proj(video)
        tgt = self.query_embedding[None].expand(memory.shape[0], -1, -1)
        inter = []
        for layer in self.decoder:
            tgt = layer(tgt, memory, video_mask)
            inter.append(tgt)
        query_features = torch.stack(inter)  # (depth, B, Q, D)
        outputs_segment = torch.sigmoid(self.segment_embedding(query_features))
        outputs_count = predict_event_num(self.count_head, query_features)
        return {
            "pred_logits": torch.softmax(self.class_embedding(query_features[-1]), dim=-1),
            "pred_segments": outputs_segment[-1],
            "pred_count": outputs_count[-1],
            "outputs_segment_all": outputs_segment,
            "outputs_count_all": outputs_count,
            "memory": memory,
            "query_features": query_features,
        }


class RegularDVC(nn.Module):
    """The regular family (both ``dvc.use_sparse_detr`` and
    ``dvc.use_deformable_detr`` off), over features or, with
    ``use_raw_videos``, raw frames. The module tree mirrors the JAX params
    tree (``proposal``, ``caption``, ``context_mask``)."""

    def __init__(self, cfg, vocab_size: int, pad_idx: int = 1, bos_idx: int = 2,
                 eos_idx: int = 3, embedding_matrix=None):
        super().__init__()
        dvc = cfg.dvc
        anet = cfg.dataset.activity_net
        self.pad_idx, self.bos_idx, self.eos_idx = pad_idx, bos_idx, eos_idx
        self.num_queries = dvc.num_queries
        self.aux_loss = dvc.aux_loss
        self.cost_segment = float(dvc.matcher.cost_segment)
        self.cost_giou = float(dvc.matcher.cost_giou)
        self.max_gt = anet.max_gt_target_segments
        self.seq_len = anet.max_caption_len_all
        self.video_rescale_len = anet.video_rescale_len
        self.use_differentiable_mask = cfg.use_differentiable_mask
        self.proposal = RegularProposalNet(
            d_model=dvc.d_model, feature_dim=dvc.detr.feature_dim,
            num_queries=dvc.num_queries, depth=dvc.decoder.depth,
            num_heads=dvc.detr.num_heads, max_eseq_length=dvc.max_eseq_length,
            num_classes=dvc.num_classes, use_vivit=bool(cfg.use_raw_videos))
        cap = dvc.caption
        # no dropout in the caption decoder: JAX's RegularDVC passes none
        self.caption = UnimodalCaptionDecoder(vocab_size, cap.d_model, cap.depth,
                                              cap.num_heads, float(cap.mlp_ratio), cap.qkv_bias,
                                              embedding_matrix=embedding_matrix)
        if self.use_differentiable_mask:
            self.context_mask = ContextMaskModel(dvc.d_model + 2, anet.video_rescale_len)

    def _propose_and_match(self, batch):
        """Proposals and the matching of the final (and, with the auxiliary
        loss, every auxiliary) decoder layer: (out, indices (B, G),
        indices_aux (layers-1, B, G) or None)."""
        out = self.proposal(batch["video_tensor"], batch["video_mask"])
        return (out, *match_layers(self, out["outputs_segment_all"], batch, self.aux_loss))

    def _common(self, batch):
        """``_propose_and_match``, then each matched event's memory crop and
        its caption mask. Returns (out, indices, indices_aux, crops (N, T,
        D), crop_mask (N, T), caption mask (N, T))."""
        out, indices, indices_aux = self._propose_and_match(batch)
        B, G = indices.shape
        N = B * G
        rows = torch.arange(B, device=indices.device)[:, None]
        durations = batch["durations"]
        denorm = denormalize_segments(out["pred_segments"][rows, indices], durations[:, None])
        crop, crop_mask = crop_segments(out["memory"], denorm, durations,
                                        self.video_rescale_len, 1)
        crop, crop_mask = crop.reshape(N, -1, crop.shape[-1]), crop_mask.reshape(N, -1)
        cap_mask = crop_mask
        if self.use_differentiable_mask:
            qf = out["query_features"][-1][rows, indices].reshape(N, -1)
            logits = self.context_mask(torch.cat([denorm.reshape(N, 2), qf], dim=1))
            out["pred_memory_mask"] = logits
            cap_mask = torch.sigmoid(logits) > 0.5
        return out, indices, indices_aux, crop, crop_mask, cap_mask

    def _caption_pass(self, batch, crop, cap_mask, log_probs: bool):
        tgt = batch["cap_tokens"].reshape(-1, self.seq_len)[:, :-1].long()
        return self.caption(tgt, crop, make_causal_mask(self.seq_len - 1, tgt.device),
                            tgt == self.pad_idx, cap_mask, log_probs=log_probs)

    def _aux_outputs(self, out):
        return [{"pred_segments": out["outputs_segment_all"][i],
                 "pred_count": out["outputs_count_all"][i]}
                for i in range(out["outputs_segment_all"].shape[0] - 1)]

    def forward_train(self, batch):
        """Training forward over a batch dict of tensors. Returns (out,
        indices, indices_aux, crop mask (N, T) as f32), as JAX's."""
        out, indices, indices_aux, crop, crop_mask, cap_mask = self._common(batch)
        logits = self._caption_pass(batch, crop, cap_mask, log_probs=False)
        out["pred_captions"] = logits[-1]
        out["caption_head"] = "logits"
        if self.aux_loss:
            out["aux_outputs"] = self._aux_outputs(out)
            out["pred_captions_all"] = logits
        return out, indices, indices_aux, crop_mask.float()

    @torch.no_grad()
    def forward_eval(self, batch, val_mode: str = "one_by_one", faster_eval: bool = False,
                     beam_size: int = 0, length_penalty: float = 0.0):
        """Evaluation forward, as JAX's: "one_by_one" the greedy decode,
        "beam" the beam search (``beam_size``, 4 when 0), "teacher_forcing"
        the argmax of the last layer's teacher-forced log-probabilities,
        which are ``pred_captions`` in every mode. There is no "serve"
        mode. Returns (out, captions, indices, indices_aux, crop mask)."""
        check_decode_options(val_mode=val_mode)
        if val_mode == "serve":
            raise ValueError("the regular family has no 'serve' val_mode; use one_by_one, "
                             "teacher_forcing or beam")
        out, indices, indices_aux, crop, crop_mask, cap_mask = self._common(batch)
        log_probs = self._caption_pass(batch, crop, cap_mask, log_probs=True)
        decode_args = (crop, cap_mask, self.seq_len, self.bos_idx, self.eos_idx, self.pad_idx)
        if val_mode == "beam":
            captions = beam_search_decode(self.caption, *decode_args, beam_size=beam_size or 4,
                                          length_penalty=length_penalty)
        elif val_mode == "one_by_one":
            captions = greedy_decode(self.caption, *decode_args, faster_eval=faster_eval)
        else:
            captions = log_probs[-1].argmax(dim=-1)
        out["pred_captions"] = log_probs[-1]
        if self.aux_loss:
            out["aux_outputs"] = self._aux_outputs(out)
            out["aux_outputs_caption"] = [{"pred_captions": log_probs[i]}
                                          for i in range(log_probs.shape[0] - 1)]
        return out, captions, indices, indices_aux, crop_mask.float()


def build_regular_model(cfg, vocab_size: int, pad_idx: int = 1, bos_idx: int = 2,
                        eos_idx: int = 3, device="cuda", seed: int = 0,
                        embedding_matrix=None) -> RegularDVC:
    """The regular family in eval mode on ``device``, its weights drawn
    from ``seed`` (the caption embedding from ``embedding_matrix`` when one
    is given)."""
    dev = resolve_device(device)
    set_f32_numerics(dev)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = RegularDVC(cfg, vocab_size, pad_idx, bos_idx, eos_idx, embedding_matrix)
    return model.to(dev).eval()
