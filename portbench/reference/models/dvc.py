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
from ..ops.hungarian import batched_hungarian_torch
from ..ops.msda import check_msda_backend
from ..ops.segment_ops import denormalize_segments, inverse_sigmoid
from ..utils.precision import cast_floating, params_in, resolve_dtype
from .base_encoder import BaseEncoder, pyramid_shapes
from .caption_decoder import UnimodalCaptionDecoder, make_causal_mask
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
        check_msda_backend(cfg.msda_backend)  # every name runs K1 / K2 (ops/msda.py)
        cap = dvc.caption
        self.caption = UnimodalCaptionDecoder(
            vocab_size, cap.d_model, cap.depth, cap.num_heads,
            float(cap.mlp_ratio), cap.qkv_bias, cap.positional_embedding_dropout,
            cap.attention_dropout, cap.projection_dropout, cap.mlp_dropout_1,
            cap.mlp_dropout_2, embedding_matrix, pre_norm=cap.pre_norm,
            return_intermediate=cap.return_intermediate)
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


    # -- the continuous server's pieces (serve.py ContinuousDVCServer) --------

