"""UnimodalDVC: GT-free serving, training and evaluation; counterpart of the
JAX ``models/dvc.py`` (``ProposalNet``, ``forward_serve``, ``_serve_prepare``,
``_propose_and_match``, ``forward_train``, ``forward_eval``, and the
continuous server's ``forward_serve_prefill``, ``forward_serve_decode_chunk``
and ``merge_serve_slots``).

Base encoder -> deformable transformer (sparse, rho > 0, or dense, rho = 0
with a class head) -> segment and count heads.
Serving: top-G proposals ranked by stability (or, with the dense family's
class head, ``rank="class"``: 1 - p(no-object)), k* from the count head ->
per-event crop mask (and the differentiable context mask when configured)
-> KV-cached greedy caption decode over the shared per-video memory.
Training: Hungarian matching of the final and auxiliary decoder layers to
the ground truth (on the model's device: K6 on the card) -> crop mask of
the matched queries -> teacher-forced caption pass; ``models/criterion.py`` takes it from there.
Evaluation: the same matching, then the greedy decode, the beam search or
the teacher-forced pass's argmax as the captions, and the teacher-forced
log-probabilities for the losses.

The module tree mirrors the JAX params tree (``proposal``, ``caption``,
``context_mask``), so ``utils.weights`` maps flax parameters onto the
state_dict one to one.
"""

from __future__ import annotations

import functools
import math
from typing import Dict

import torch
from torch import nn

from ..config import check_decode_options
from ..device import resolve_device, set_f32_numerics
from ..ops.hungarian import batched_hungarian_torch
from ..ops.segment_ops import denormalize_segments, inverse_sigmoid
from ..utils.precision import cast_floating, params_in, resolve_dtype
from .base_encoder import BaseEncoder, pyramid_shapes
from .caption_decoder import (
    UnimodalCaptionDecoder, beam_search_decode, greedy_decode, greedy_decode_chunk,
    make_causal_mask,
)
from .layers import FFN, ContextMaskModel, Linear
from .matcher import match_cost
from .transformer import SparseDeformableTransformer, predict_event_num


def level_windows(video_rescale_len: int, num_levels: int):
    """Per-level [lower, upper) windows in the flattened token axis, with the
    reference's formula quirks: the level-3 upper bound is
    floor(vrl * 15 / 8), one short of the true level end."""
    wins = []
    for n in range(num_levels):
        lower = math.floor(video_rescale_len * ((2 ** n - 1) / 2 ** (n - 1)))
        upper = math.floor(video_rescale_len * ((2 ** (n + 1) - 1) / 2 ** n))
        wins.append((lower, upper))
    return wins


def crop_segment_mask(denorm_segments, durations, video_rescale_len: int,
                      num_levels: int, num_tokens: int = 0) -> torch.Tensor:
    """Per-event crop mask: True outside the event's token window at every
    pyramid level. denorm_segments (B, G, 2) seconds, durations (B,) ->
    (B, G, S)."""
    B, G = denorm_segments.shape[:2]
    dur = durations[:, None]
    windows = level_windows(video_rescale_len, num_levels)
    S = num_tokens or windows[-1][1]
    toks = torch.arange(S, device=denorm_segments.device)[None, None]
    inside = torch.zeros((B, G, S), dtype=torch.bool, device=denorm_segments.device)
    for lower, upper in windows:
        diff = upper - lower
        start = torch.round(lower + diff * denorm_segments[..., 0] / dur) \
            .clamp(lower, upper - 1).to(torch.int32)
        end = torch.round(lower + diff * denorm_segments[..., 1] / dur) \
            .clamp(lower, upper - 1).to(torch.int32)
        inside |= (toks >= start[..., None]) & (toks < end[..., None])
    return ~inside


def crop_segments(memory, denorm_segments, durations, video_rescale_len: int,
                  num_levels: int):
    """Per-event memory crop: the memory (B, S, D) copied for each event and
    zeroed outside its token window at every pyramid level. Returns (cropped
    (B, G, S, D), pad_mask (B, G, S) True=outside). The unimodal families
    share the per-video memory instead (``crop_segment_mask`` and grouped
    cross-attention); the multimodal family materialises the crop."""
    pad_mask = crop_segment_mask(denorm_segments, durations, video_rescale_len, num_levels,
                                 num_tokens=memory.shape[1])
    cropped = memory[:, None].masked_fill(pad_mask[..., None], 0.0)
    return cropped, pad_mask


def check_family(cfg) -> None:
    """Raise on a config that ``UnimodalDVC`` (the sparse and the dense
    families on video features) does not take: the regular family (both
    family flags off), raw frames (``use_raw_videos``) and two input
    modalities. Those are built by ``models.build_model_and_criterion``;
    the serving and inference entry points build ``UnimodalDVC`` only, as
    JAX's ``serve.py`` and ``inference.py`` do."""
    dvc = cfg.dvc
    where = ("it is built by models.build_model_and_criterion and evaluated with "
             "`python -m multimodal_feature_learning_tpu_torch.main --mode eval`")
    if not (dvc.use_sparse_detr or dvc.use_deformable_detr):
        raise ValueError("UnimodalDVC is the sparse or the dense family, but "
                         "dvc.use_sparse_detr and dvc.use_deformable_detr are both off (the "
                         f"regular family, models/regular_dvc.py); {where}")
    if cfg.use_raw_videos:
        raise ValueError("UnimodalDVC takes video features, but use_raw_videos is on; raw "
                         "frames go through the regular or the raw multimodal family: "
                         f"{where}")
    if len(dvc.input_modalities) != 1:
        raise ValueError(
            f"UnimodalDVC takes the video features alone, but dvc.input_modalities is "
            f"{list(dvc.input_modalities)}; the multimodal family: {where}")


def match_layers(model, seg_all, batch, with_aux: bool):
    """Hungarian matching of the final decoder layer's segments and, with
    ``with_aux``, of every auxiliary layer's to the ground truth, all
    layers' problems in one solve on the model's device (K6 on the card,
    no host synchronisation; ``model`` gives num_queries, max_gt and the
    cost weights). seg_all (layers, B, Q, 2) -> (indices (B, G),
    indices_aux (layers-1, B, G) or None)."""
    seg_all = seg_all.detach()
    n_layers = seg_all.shape[0] if with_aux else 1
    gt, gt_mask = batch["gt_segments"], batch["gt_mask"]
    flat = seg_all[-n_layers:].roll(1, dims=0)  # final layer first, then aux
    cost = match_cost(flat.reshape(-1, model.num_queries, 2), gt.float().repeat(n_layers, 1, 1),
                      model.cost_segment, model.cost_giou)
    idx = batched_hungarian_torch(cost, gt_mask.bool().repeat(n_layers, 1))
    idx = idx.reshape(n_layers, -1, model.max_gt)
    return idx[0], (idx[1:] if with_aux else None)


def in_compute_dtype(method):
    """Run a forward of ``UnimodalDVC`` over its float params cast to the
    model's ``compute_dtype`` (JAX ``_cast_params``): a bf16 copy of each f32
    master, made by a differentiable cast, so gradients reach the masters
    in f32; with f32 compute, or params already in the compute dtype, the
    params are used as they are."""

    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        with params_in(self, self.compute_dtype):
            return method(self, *args, **kwargs)

    return wrapper


class ProposalNet(nn.Module):
    """Base encoder + deformable transformer + segment/count heads, and the
    dense family's class head (``with_class_head``; ``num_classes`` + 1
    logits, the last one "no object")."""

    def __init__(self, d_model=512, feature_dim=512, num_queries=20,
                 num_feature_levels=4, num_heads=8, enc_layers=6, dec_layers=6,
                 ff_dim=2048, dropout=0.1, enc_n_points=4, dec_n_points=4, rho=0.5,
                 use_enc_aux_loss=True, max_eseq_length=10, with_class_head=False,
                 num_classes=200):
        super().__init__()
        self.use_enc_aux_loss = use_enc_aux_loss
        self.base_encoder = BaseEncoder(num_feature_levels, d_model, feature_dim)
        self.transformer = SparseDeformableTransformer(
            d_model=d_model, num_heads=num_heads, num_encoder_layers=enc_layers,
            num_decoder_layers=dec_layers, dim_feedforward=ff_dim, dropout=dropout,
            num_feature_levels=num_feature_levels, dec_n_points=dec_n_points,
            enc_n_points=enc_n_points, rho=rho)
        self.query_embedding = nn.Parameter(torch.randn(num_queries, 2 * d_model))
        self.segment_embedding_decoder = FFN(d_model, d_model, 2, 3, final_zero_init=True)
        self.count_head_decoder = Linear(d_model, max_eseq_length + 1)
        if use_enc_aux_loss:
            # heads of the encoder's auxiliary loss: trained, carried with the
            # weights, and not read on the serving path
            self.segment_embedding_encoder = FFN(d_model, d_model, 2, 3,
                                                 final_zero_init=True)
            self.count_head_encoder = Linear(d_model, max_eseq_length + 1)
        if with_class_head:
            # read by rank="class" only: no loss reaches it, as in JAX
            self.class_embedding = Linear(d_model, num_classes + 1)

    def forward(self, video, video_mask, durations,
                with_enc_aux: bool = False) -> Dict[str, torch.Tensor]:
        """Every output the matcher, the crop, the caption decoder and the
        criterion read. ``with_enc_aux`` adds the encoder's auxiliary
        segment and count heads (``aux_outputs_enc``), which only the
        training losses read."""
        B = video.shape[0]
        tr = self.transformer
        srcs, masks, poses = self.base_encoder(video, video_mask, durations)
        enc = tr.prepare_encoder_inputs(srcs, masks, poses)
        temporal_shapes = enc["temporal_shapes"]
        memory, loc_enc, attn_enc, enc_inter, enc_bases = tr.forward_encoder(enc)
        init_ref, tgt, query_pos = tr.prepare_decoder_input_query(B, self.query_embedding)
        query_features, inter_refs, loc_dec, attn_dec = tr.forward_decoder(
            tgt, init_ref, memory, temporal_shapes, enc["valid_ratios"],
            query_pos, enc["mask_flatten"])
        outputs_segment = self.segment_embedding_decoder(query_features).float()
        outputs_count = predict_event_num(self.count_head_decoder, query_features).float()
        # reference-point offsetting: ref[0] = init, ref[i] = inter[i-1]
        reference = torch.cat([init_ref[None], inter_refs[:-1]], dim=0).float()
        outputs_segment = torch.sigmoid(outputs_segment + inverse_sigmoid(reference))
        starts = [0]
        for t in temporal_shapes[:-1]:
            starts.append(starts[-1] + int(t))
        out = {
            "pred_segments": outputs_segment[-1],
            "pred_count": outputs_count[-1],
            "sampling_locations_enc": loc_enc,
            "attn_weights_enc": attn_enc,
            "sampling_locations_dec": loc_dec,
            "attn_weights_dec": attn_dec,
            "temporal_shapes": temporal_shapes,
            "level_start_index": tuple(starts),
            "memory": memory,
            "query_features": query_features,
            "mask_flatten": enc["mask_flatten"],
            "outputs_segment_all": outputs_segment,  # (layers, B, Q, 2)
            "outputs_count_all": outputs_count,      # (layers, B, C)
        }
        if hasattr(self, "class_embedding"):
            out["outputs_class_all"] = torch.softmax(
                self.class_embedding(query_features).float(), dim=-1)
            out["pred_logits"] = out["outputs_class_all"][-1]
        if enc["topk"] is not None:
            out["backbone_topk_proposals"] = enc["topk"]
            out["backbone_mask_prediction"] = enc["saliency"]
            out["sparse_token_nums"] = enc["sparse_token_nums"]
        if with_enc_aux and self.use_enc_aux_loss and enc_inter is not None:
            counts = predict_event_num(self.count_head_encoder, enc_inter).float()
            offsets = self.segment_embedding_encoder(enc_inter).float()
            coords = torch.sigmoid(enc_bases[None] + offsets)  # (layers-1, B, K, 2)
            out["aux_outputs_enc"] = [
                {"pred_segments": coords[i], "pred_count": counts[i]}
                for i in range(coords.shape[0])]
        return out


class UnimodalDVC(nn.Module):
    """The sparse (``dvc.use_sparse_detr``) and the dense
    (``dvc.use_deformable_detr``) families on video features: ``forward_serve``
    maps features to events and captions, ``forward_train`` and
    ``forward_eval`` add the matching to the ground truth."""

    def __init__(self, cfg, vocab_size: int, pad_idx: int = 1, bos_idx: int = 2,
                 eos_idx: int = 3, embedding_matrix=None):
        super().__init__()
        dvc, det = cfg.dvc, cfg.dvc.detr
        anet = cfg.dataset.activity_net
        # mixed precision, as the JAX package: the float params and the
        # features are cast to compute_dtype at the start of every forward
        # (``in_compute_dtype``); the outputs the matcher and the criterion
        # read come back in f32, the memory and the query features stay in
        # compute_dtype; with bf16 the decode keeps its K/V in bf16
        self.compute_dtype = resolve_dtype(cfg.compute_dtype)
        self.kv_dtype = torch.bfloat16 if self.compute_dtype == torch.bfloat16 else None
        check_family(cfg)
        check_decode_options(decode_impl=cfg.decode_impl, decode_kv=cfg.decode_kv,
                             decode_fused_grid=cfg.decode_fused_grid)
        self.decode_impl = cfg.decode_impl
        self.decode_kv = cfg.decode_kv
        self.decode_fused_grid = cfg.decode_fused_grid
        self.pad_idx, self.bos_idx, self.eos_idx = pad_idx, bos_idx, eos_idx
        self.num_queries = dvc.num_queries
        self.aux_loss = dvc.aux_loss
        self.cost_segment = float(dvc.matcher.cost_segment)
        self.cost_giou = float(dvc.matcher.cost_giou)
        self.max_gt = anet.max_gt_target_segments
        self.seq_len = anet.max_caption_len_all
        self.video_rescale_len = det.video_rescale_len
        self.num_feature_levels = det.num_feature_levels
        self.use_differentiable_mask = cfg.use_differentiable_mask
        self.num_tokens = sum(pyramid_shapes(det.video_rescale_len,
                                             det.num_feature_levels))

        self.proposal = ProposalNet(
            d_model=dvc.d_model, feature_dim=det.feature_dim,
            num_queries=dvc.num_queries, num_feature_levels=det.num_feature_levels,
            num_heads=det.num_heads, enc_layers=det.enc_layers,
            dec_layers=det.dec_layers, ff_dim=det.transformer_ff_dim,
            dropout=det.transformer_dropout_prob,
            enc_n_points=det.enc_n_points, dec_n_points=det.dec_n_points,
            rho=det.rho if dvc.use_sparse_detr else 0.0,
            use_enc_aux_loss=det.use_enc_aux_loss and dvc.use_sparse_detr,
            max_eseq_length=dvc.max_eseq_length,
            with_class_head=bool(dvc.use_deformable_detr), num_classes=dvc.num_classes)
        cap = dvc.caption
        self.caption = UnimodalCaptionDecoder(
            vocab_size, cap.d_model, cap.depth, cap.num_heads,
            float(cap.mlp_ratio), cap.qkv_bias, cap.positional_embedding_dropout,
            cap.attention_dropout, cap.projection_dropout, cap.mlp_dropout_1,
            cap.mlp_dropout_2, embedding_matrix)
        if self.use_differentiable_mask:
            self.context_mask = ContextMaskModel(dvc.d_model + 2, self.num_tokens)

    def _propose(self, video, video_mask, durations, with_enc_aux: bool = False):
        """The proposal forward on the features in the compute dtype. Its
        outputs come back in f32 for the matcher and the criterion, except
        ``memory`` and ``query_features``, which feed the caption decoder and
        the context mask in the compute dtype (JAX ``_propose_and_match``)."""
        out = self.proposal(video.to(self.compute_dtype), video_mask, durations,
                            with_enc_aux=with_enc_aux)
        if self.compute_dtype == torch.float32:
            return out
        keep = ("memory", "query_features")
        return {k: v if k in keep else cast_floating(v, torch.float32) for k, v in out.items()}

    def _prepare_caption_inputs(self, out, durations, indices):
        """Per-event crop mask and, when configured, the differentiable
        context mask. Returns (memory (B,S,D), crop_mask (N,S),
        caption_pad_mask (N,S), context-mask logits (N,S) or None)."""
        B, G = indices.shape
        rows = torch.arange(B, device=indices.device)[:, None]
        denorm = denormalize_segments(out["pred_segments"][rows, indices],
                                      durations[:, None])  # (B, G, 2)
        memory = out["memory"]
        crop_mask = crop_segment_mask(
            denorm, durations, self.video_rescale_len, self.num_feature_levels,
            num_tokens=memory.shape[1]).reshape(B * G, -1)
        caption_pad_mask = crop_mask
        logits = None
        if self.use_differentiable_mask:
            qf_sel = out["query_features"][-1][rows, indices].reshape(B * G, -1)
            logits = self.context_mask(torch.cat([denorm.reshape(B * G, 2), qf_sel], dim=1))
            caption_pad_mask = torch.sigmoid(logits) > 0.5
        return memory, crop_mask, caption_pad_mask, logits

    @in_compute_dtype
    def _propose_and_match(self, batch, with_aux: bool = True):
        """Proposal forward, then the Hungarian matching of the final
        decoder layer and, with ``with_aux``, of every auxiliary layer to the
        ground truth. Returns (out, indices (B,G), indices_aux (layers-1,B,G)
        or None). Without ``with_aux`` the encoder's auxiliary heads are not
        run either, since their losses reuse the auxiliary matchings."""
        out = self._propose(batch["video_tensor"], batch["video_mask"], batch["durations"],
                            with_enc_aux=with_aux)
        return (out, *match_layers(self, out["outputs_segment_all"], batch,
                                   with_aux and self.aux_loss))

    @in_compute_dtype
    def forward_train(self, batch):
        """Training forward over a batch dict of tensors on the model's
        device (``data.anet.collate_fixed``'s arrays). Dropout is active when
        the model is in training mode. Returns (out, indices, indices_aux,
        memory_mask_float (N,S)), as the JAX package's ``forward_train``."""
        out, indices, indices_aux = self._propose_and_match(batch)
        memory, crop_mask, caption_pad_mask, pred_memory_mask = \
            self._prepare_caption_inputs(out, batch["durations"], indices)
        if pred_memory_mask is not None:
            out["pred_memory_mask"] = pred_memory_mask
        tgt = batch["cap_tokens"].reshape(-1, self.seq_len)[:, :-1].long()
        logits = self.caption(
            tgt, memory, make_causal_mask(self.seq_len - 1, tgt.device),
            tgt == self.pad_idx, caption_pad_mask, groups=self.max_gt,
            zeroed_mask=crop_mask if self.use_differentiable_mask else None)
        out["pred_captions"] = logits[-1]
        out["caption_head"] = "logits"
        if self.aux_loss:
            out["aux_outputs"] = self._aux_outputs(out)
            out["pred_captions_all"] = logits
        return out, indices, indices_aux, crop_mask.float()

    def _aux_outputs(self, out):
        return [{"pred_segments": out["outputs_segment_all"][i],
                 "pred_count": out["outputs_count_all"][i]}
                for i in range(out["outputs_segment_all"].shape[0] - 1)]

    @torch.no_grad()
    @in_compute_dtype
    def forward_eval(self, batch, val_mode: str = "one_by_one", faster_eval: bool = False,
                     beam_size: int = 0, length_penalty: float = 0.0):
        """Evaluation forward over a batch dict of tensors on the model's
        device, with the ground truth (matching needs it). Returns (out,
        captions, indices (B,G), indices_aux or None, memory_mask_float
        (N,S)), as the JAX package's ``forward_eval``.

        ``val_mode`` "one_by_one" and "serve" take the greedy decode (as
        ``decode_impl``, ``decode_kv`` and ``decode_fused_grid`` say, with
        ``faster_eval``), "beam" the beam search (``beam_size``, 4 when 0,
        and ``length_penalty``): captions (N, Lc+1). "teacher_forcing" takes
        the argmax of the last layer's teacher-forced log-probabilities:
        captions (N, Lc-1). Outside "serve" the teacher-forced pass adds
        ``pred_captions`` (f32 log-probs, N, Lc-1, V) and, with the
        auxiliary loss, ``aux_outputs`` and ``aux_outputs_caption``; "serve"
        matches the final decoder layer only and runs no teacher-forced
        pass."""
        check_decode_options(val_mode=val_mode)
        serving = val_mode == "serve"
        out, indices, indices_aux = self._propose_and_match(batch, with_aux=not serving)
        memory, crop_mask, caption_pad_mask, pred_memory_mask = \
            self._prepare_caption_inputs(out, batch["durations"], indices)
        if pred_memory_mask is not None:
            out["pred_memory_mask"] = pred_memory_mask
        zeroed = crop_mask if self.use_differentiable_mask else None
        decode_args = (memory, caption_pad_mask, self.seq_len, self.bos_idx, self.eos_idx,
                       self.pad_idx)
        if val_mode == "beam":
            captions = beam_search_decode(
                self.caption, *decode_args, beam_size=beam_size or 4,
                length_penalty=length_penalty, groups=self.max_gt, zeroed_mask=zeroed)
        elif val_mode != "teacher_forcing":
            captions = greedy_decode(
                self.caption, *decode_args, faster_eval=faster_eval, groups=self.max_gt,
                zeroed_mask=zeroed, decode_impl=self.decode_impl, kv_mode=self.decode_kv,
                fused_grid=self.decode_fused_grid, kv_dtype=self.kv_dtype)
        if serving:
            return out, captions, indices, indices_aux, crop_mask.float()

        tgt = batch["cap_tokens"].reshape(-1, self.seq_len)[:, :-1].long()
        log_probs = self.caption(
            tgt, memory, make_causal_mask(self.seq_len - 1, tgt.device),
            tgt == self.pad_idx, caption_pad_mask, groups=self.max_gt,
            zeroed_mask=zeroed, log_probs=True)
        if val_mode == "teacher_forcing":
            captions = log_probs[-1].argmax(dim=-1)
        out["pred_captions"] = log_probs[-1]
        if self.aux_loss:
            out["aux_outputs"] = self._aux_outputs(out)
            out["aux_outputs_caption"] = [{"pred_captions": log_probs[i]}
                                          for i in range(log_probs.shape[0] - 1)]
        return out, captions, indices, indices_aux, crop_mask.float()

    @in_compute_dtype
    def _serve_prepare(self, video_tensor, video_mask, durations, rank: str = "stability"):
        """Propose, rank, select the top G, crop the memory. ``rank`` "class"
        ranks by the class head's foreground probability, 1 - p(no-object),
        where there is one (the dense family); the sparse family has none,
        so it ranks by stability, as JAX falls back."""
        check_decode_options(rank=rank)
        out = self._propose(video_tensor, video_mask, durations)
        G = self.max_gt
        seg_all = out["outputs_segment_all"]
        if rank == "class" and "pred_logits" in out:
            scores = 1.0 - out["pred_logits"][..., -1]  # (B, Q)
        elif seg_all.shape[0] < 2:
            # one decoder layer has no drift to rank by: uniform scores
            scores = seg_all.new_zeros(seg_all.shape[1:3])
        else:
            scores = -(seg_all[1:] - seg_all[:-1]).abs().mean(dim=(0, 3))  # (B, Q)
        # stable sort: ties keep the lower index first, as lax.top_k does
        order = torch.sort(scores, dim=1, descending=True, stable=True)
        top_scores, indices = order.values[:, :G], order.indices[:, :G]

        k = out["pred_count"].argmax(dim=-1).clamp(1, G)
        valid = torch.arange(G, device=k.device)[None, :] < k[:, None]
        memory, crop_mask, caption_pad_mask, _ = self._prepare_caption_inputs(
            out, durations, indices)
        rows = torch.arange(indices.shape[0], device=indices.device)[:, None]
        segments = denormalize_segments(out["pred_segments"][rows, indices],
                                        durations[:, None])
        return {
            "memory": memory,
            "caption_pad_mask": caption_pad_mask,
            "zeroed": crop_mask if self.use_differentiable_mask else None,
            "segments": segments,
            "k": k,
            "scores": top_scores,
            "valid": valid,
        }

    @torch.no_grad()
    @in_compute_dtype
    def forward_serve(self, video_tensor, video_mask, durations, faster_eval: bool = False,
                      rank: str = "stability") -> Dict[str, torch.Tensor]:
        """GT-free serving forward. video_tensor (B, T, feature_dim),
        video_mask (B, T) True=pad, durations (B,) seconds. Returns segments
        (B, G, 2) seconds, captions (B, G, Lc+1) token ids including <bos>,
        k (B,) predicted event counts, scores (B, G), valid (B, G). The decode
        runs as ``decode_impl``, ``decode_kv`` and ``decode_fused_grid`` of
        the config say (attributes of the model, which a caller may change)."""
        prep = self._serve_prepare(video_tensor, video_mask, durations, rank)
        captions = greedy_decode(
            self.caption, prep["memory"], prep["caption_pad_mask"],
            self.seq_len, self.bos_idx, self.eos_idx, self.pad_idx,
            faster_eval=faster_eval, groups=self.max_gt, zeroed_mask=prep["zeroed"],
            decode_impl=self.decode_impl, kv_mode=self.decode_kv,
            fused_grid=self.decode_fused_grid, kv_dtype=self.kv_dtype)
        B = durations.shape[0]
        return {
            "segments": prep["segments"],
            "captions": captions.reshape(B, self.max_gt, -1),
            "k": prep["k"],
            "scores": prep["scores"],
            "valid": prep["valid"],
        }


    # -- the continuous server's pieces (serve.py ContinuousDVCServer) --------

    @torch.no_grad()
    @in_compute_dtype
    def forward_serve_prefill(self, video_tensor, video_mask, durations,
                              rank: str = "stability"):
        """The front half of ``forward_serve`` for the continuous server:
        propose, select and crop, project every layer's cross-attention K/V
        of the memory, and start each slot's decode at position 1 after
        <bos>. Returns (ctx, state): ctx holds mem_kv, caption_pad_mask,
        zeroed, segments, k, scores and valid; state holds captions
        (N, Lc), done (N,), t (B,) and the zeroed k/v caches
        (depth, N, Lc, D), which ``forward_serve_decode_chunk`` advances."""
        prep = self._serve_prepare(video_tensor, video_mask, durations, rank)
        memory = prep["memory"]
        B, N = durations.shape[0], durations.shape[0] * self.max_gt
        dev = memory.device
        captions = torch.full((N, self.seq_len), self.pad_idx, dtype=torch.long, device=dev)
        captions[:, 0] = self.bos_idx
        cache_shape = (self.caption.depth, N, self.seq_len, memory.shape[-1])
        ctx = {"mem_kv": self.caption.precompute_memory_kv(memory, self.kv_dtype),
               **{k: prep[k] for k in ("caption_pad_mask", "zeroed", "segments", "k",
                                       "scores", "valid")}}
        state = {
            "captions": captions,
            "done": torch.zeros((N,), dtype=torch.bool, device=dev),
            "t": torch.ones((B,), dtype=torch.long, device=dev),
            "k_caches": memory.new_zeros(cache_shape),
            "v_caches": memory.new_zeros(cache_shape),
        }
        return ctx, state

    @torch.no_grad()
    @in_compute_dtype
    def forward_serve_decode_chunk(self, ctx, state, active_vid, chunk: int):
        """Advance every active slot's greedy decode by up to ``chunk``
        tokens at its own cursor (``greedy_decode_chunk``), updating
        ``state`` in place; returns it."""
        greedy_decode_chunk(
            self.caption, state["captions"], state["done"], state["t"], state["k_caches"],
            state["v_caches"], ctx["mem_kv"], ctx["caption_pad_mask"], self.seq_len,
            self.eos_idx, self.pad_idx, self.max_gt, ctx["zeroed"], active_vid, chunk)
        return state

    @staticmethod
    @torch.no_grad()
    def merge_serve_slots(ctx, state, new_ctx, new_state, replace, groups: int):
        """The slots where ``replace`` (B,) is True taken from (new_ctx,
        new_state), the others from (ctx, state): a ``torch.where`` per
        leaf, whose leading dim is B, N = B * groups, or (depth, N, ...) for
        the caches. Returns new tensors; the inputs are left as they were,
        so a failed admit leaves the resident pool intact."""
        B = replace.shape[0]
        rrow = replace.repeat_interleave(groups)

        def mb(o, n):  # leading dim B
            return torch.where(replace.view((B,) + (1,) * (o.dim() - 1)), n, o)

        def mrow(o, n):  # leading dim N
            return torch.where(rrow.view((rrow.shape[0],) + (1,) * (o.dim() - 1)), n, o)

        def mcache(o, n):  # (depth, N, ...)
            return torch.where(rrow.view((1, rrow.shape[0]) + (1,) * (o.dim() - 2)), n, o)

        merged_ctx = {
            "mem_kv": [(mb(k, nk), mb(v, nv))
                       for (k, v), (nk, nv) in zip(ctx["mem_kv"], new_ctx["mem_kv"])],
            "caption_pad_mask": mrow(ctx["caption_pad_mask"], new_ctx["caption_pad_mask"]),
            "zeroed": (None if ctx["zeroed"] is None
                       else mrow(ctx["zeroed"], new_ctx["zeroed"])),
            **{k: mb(ctx[k], new_ctx[k]) for k in ("segments", "k", "scores", "valid")},
        }
        merged_state = {
            "captions": mrow(state["captions"], new_state["captions"]),
            "done": mrow(state["done"], new_state["done"]),
            "t": mb(state["t"], new_state["t"]),
            "k_caches": mcache(state["k_caches"], new_state["k_caches"]),
            "v_caches": mcache(state["v_caches"], new_state["v_caches"]),
        }
        return merged_ctx, merged_state


def build_model(cfg, vocab_size: int, pad_idx: int = 1, bos_idx: int = 2,
                eos_idx: int = 3, device="cuda", seed: int = 0,
                embedding_matrix=None) -> UnimodalDVC:
    """The model in eval mode on ``device``, its weights drawn from ``seed``
    (load trained weights with ``utils.weights``), the caption embedding
    from ``embedding_matrix`` (GloVe's, ``models/load_weights.py``) when one
    is given; ``model.train()`` turns dropout on for training."""
    dev = resolve_device(device)
    set_f32_numerics(dev)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = UnimodalDVC(cfg, vocab_size, pad_idx, bos_idx, eos_idx, embedding_matrix)
    return model.to(dev).eval()
