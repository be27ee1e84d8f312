"""Set criterion: every DVC loss over fixed-shape padded batches; counterpart
of the JAX ``models/criterion.py`` (``SetCriterion``, ``build_weight_dict``).

Losses: ``labels`` (event-count cross-entropy with a Gaussian neighbourhood
mask), ``segments`` (L1 + gIoU of the matched pairs over ``num_segments``),
``captions`` (label-smoothed KL; in training straight from the logits: the
log-softmax is folded into closed-form reductions, so no V-sized
log-probability tensor is kept for the backward pass; in evaluation from the
log-probabilities of the teacher-forced pass), ``contexts`` (masked BCE of
the context-mask logits), ``mask_prediction`` (multilabel soft margin of the saliency
against the top-K tokens of the decoder attention map) and ``corr`` (a
diagnostic without gradient: the share of the decoder's attention mass on
the tokens the encoder kept, averaged over the valid videos). The auxiliary
decoder layers and the encoder's auxiliary heads repeat ``labels`` and
``segments``; the encoder's reuse the decoder's auxiliary matchings, as the
reference does. Each caption layer but the last adds ``loss_caption_{i}``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.dam import attn_map_to_flat_grid, compute_corr, idx_to_flat_grid
from ..ops.segment_ops import generalized_box_iou, segment_cl_to_xy

# Event-count prior rates over ActivityNet train; a dataset statistics table
# the counter loss weighting needs.
COUNTER_CLASS_RATE = [
    0.00000000e00, 0.00000000e00, 1.93425917e-01, 4.12129084e-01,
    1.88929963e-01, 7.81296833e-02, 5.09541413e-02, 3.12718553e-02,
    1.84833650e-02, 8.39244680e-03, 6.59406534e-03, 4.49595364e-03,
    2.19802178e-03, 1.79838146e-03, 5.99460486e-04, 4.99550405e-04,
    4.99550405e-04, 1.99820162e-04, 2.99730243e-04, 3.99640324e-04,
    2.99730243e-04, 0.00000000e00, 1.99820162e-04, 0.00000000e00,
    0.00000000e00, 0.00000000e00, 9.99100809e-05, 9.99100809e-05,
]


def _bce_with_logits(x, y, weight=None):
    """Elementwise binary cross-entropy with logits."""
    loss = x.clamp(min=0) - x * y + torch.log1p(torch.exp(-x.abs()))
    return loss if weight is None else loss * weight


def _masked_row_mean(per_row, row_valid):
    """Mean over the batch axis restricted to valid rows (None: all)."""
    if row_valid is None:
        return per_row.mean()
    n = row_valid.sum().to(per_row.dtype).clamp(min=1.0)
    return torch.where(row_valid, per_row, torch.zeros_like(per_row)).sum() / n


def cross_entropy_with_gaussian_mask(inputs, targets, weight, lloss_gau_mask: int = 1,
                                     lloss_beta: float = 1.0, row_valid=None):
    """Counter loss: BCE per count class, weighted by 1 - the class prior,
    with the wrong classes near the true count scaled down by a Gaussian
    (sigma 2)."""
    C = targets.shape[1]
    mu = torch.arange(C, dtype=torch.float32, device=inputs.device)
    mask_dict = torch.exp(-((mu[:, None] - mu[None, :]) ** 2) / 8.0)
    mask = mask_dict[targets.argmax(dim=1)]
    loss = _bce_with_logits(inputs, targets, weight=1.0 - weight)
    if lloss_gau_mask:
        coef = targets + ((1.0 - mask) ** lloss_beta) * (1.0 - targets)
    else:
        coef = torch.ones_like(targets)
    return _masked_row_mean((loss * coef).mean(dim=1), row_valid)


def _smoothing_entropy(V: int, smoothing: float) -> torch.Tensor:
    """sum_v dist_v * log(dist_v) of the smoothed target distribution: V - 2
    cells of sm / (V - 2) and the target cell of 1 - sm, in f32."""
    u = smoothing / (V - 2)
    return (V - 2) * u * torch.log(torch.tensor(u, dtype=torch.float32)) \
        + (1.0 - smoothing) * torch.log(torch.tensor(1.0 - smoothing, dtype=torch.float32))


def label_smoothing_kl(log_pred, target, pad_idx: int, smoothing: float):
    """The caption loss from (N, S, V) log-probabilities: the sum over the
    positions whose target is not <pad> of KL(dist || pred), dist as in
    ``label_smoothing_kl_logits_stack``, in closed form."""
    V = log_pred.shape[-1]
    u = smoothing / (V - 2)
    target = target.long()
    lp_tgt = log_pred.gather(-1, target[..., None])[..., 0]
    cross = u * (log_pred.sum(-1) - log_pred[..., pad_idx] - lp_tgt) \
        + (1.0 - smoothing) * lp_tgt
    per = _smoothing_entropy(V, smoothing).to(log_pred.device) - cross
    return torch.where(target != pad_idx, per, torch.zeros_like(per)).sum()


def label_smoothing_kl_logits_stack(stack, target, pad_idx: int, smoothing: float):
    """Per-depth caption losses over the (D, N, S, V) stack of raw logits ->
    (D,). Sum over the positions whose target is not <pad> of KL(dist ||
    softmax), dist = sm / (V - 2) everywhere, 1 - sm at the target, 0 at
    <pad>. The cross term sum_v dist_v * log_softmax_v is taken as
    u * sum(x) + (1 - sm - u) * x[target] - u * x[pad] - (sum of dist) * lse,
    which keeps only the logits for the backward pass."""
    V = stack.shape[-1]
    sm = smoothing
    u = sm / (V - 2)
    x = stack.float()
    tgt = target.long()[None].expand(x.shape[:-1])
    lse = torch.logsumexp(x, dim=-1)
    x_tgt = x.gather(-1, tgt[..., None])[..., 0]
    wsum = u * x.sum(-1) + ((1.0 - sm) - u) * x_tgt - u * x[..., pad_idx]
    cross = wsum - (u * (V - 2) + (1.0 - sm)) * lse
    ent = _smoothing_entropy(V, sm)
    per = torch.where(tgt != pad_idx, ent.to(x.device) - cross, torch.zeros_like(cross))
    return per.sum(dim=(1, 2))


def multilabel_soft_margin_loss(x, y, row_valid=None):
    """``F.multilabel_soft_margin_loss`` (mean), restricted to valid rows."""
    loss = -(y * F.logsigmoid(x) + (1 - y) * F.logsigmoid(-x))
    return _masked_row_mean(loss.mean(dim=-1), row_valid)


class SetCriterion:
    """Loss container without parameters."""

    def __init__(self, losses, pad_idx: int, smoothing: float = 0.5,
                 lloss_gau_mask: int = 1, lloss_beta: float = 1.0):
        self.losses = list(losses)
        self.pad_idx = pad_idx
        self.smoothing = smoothing
        self.lloss_gau_mask = lloss_gau_mask
        self.lloss_beta = lloss_beta

    def loss_labels(self, outputs, targets, indices, num_segments, num_tokens):
        pred_count = outputs["pred_count"]  # (B, C)
        max_length = pred_count.shape[1] - 1
        counter_target = targets["gt_mask"].sum(dim=1).clamp(max=max_length)
        onehot = F.one_hot(counter_target.long(), pred_count.shape[1]).to(pred_count.dtype)
        weight = torch.tensor(COUNTER_CLASS_RATE[:max_length + 1], dtype=torch.float32,
                              device=pred_count.device)
        loss = cross_entropy_with_gaussian_mask(
            pred_count, onehot, weight, self.lloss_gau_mask, self.lloss_beta,
            row_valid=targets.get("batch_valid"))
        return {"loss_counter": loss}

    def loss_segments(self, outputs, targets, indices, num_segments, num_tokens):
        pred = outputs["pred_segments"]  # (B, Q or K, 2)
        gt = targets["gt_segments"]      # (B, G, 2)
        mask = targets["gt_mask"]        # (B, G)
        rows = torch.arange(mask.shape[0], device=pred.device)[:, None]
        src = pred[rows, indices]        # (B, G, 2)
        zero = torch.zeros((), dtype=src.dtype, device=src.device)
        l1 = (src - gt).abs().sum(-1)
        loss_bbox = torch.where(mask, l1, zero).sum() / num_segments
        giou = generalized_box_iou(segment_cl_to_xy(src)[..., None, :],
                                   segment_cl_to_xy(gt)[..., None, :])[..., 0, 0]
        loss_giou = torch.where(mask, 1.0 - giou, zero).sum() / num_segments
        return {"loss_bbox": loss_bbox, "loss_giou": loss_giou}

    def loss_captions(self, outputs, targets, indices, num_segments, num_tokens):
        # raw logits where ``caption_head`` says so (training), else f32
        # log-probabilities (evaluation)
        pred = outputs["pred_captions"]  # (N, Lc-1, V)
        cap = targets["cap_tokens"].reshape(pred.shape[0], -1)
        if outputs.get("caption_head") == "logits":
            loss = label_smoothing_kl_logits_stack(pred[None], cap[:, 1:], self.pad_idx,
                                                   self.smoothing)[0]
        else:
            loss = label_smoothing_kl(pred, cap[:, 1:], self.pad_idx, self.smoothing)
        return {"loss_caption": loss / num_tokens}

    def loss_contexts(self, outputs, targets, indices, num_segments, num_tokens,
                      memory_mask):
        pred = outputs["pred_memory_mask"]  # (N, S) logits
        row_valid = targets["gt_mask"].reshape(-1)
        loss = _bce_with_logits(pred, memory_mask)
        loss = torch.where(row_valid[:, None], loss, torch.zeros_like(loss))
        denom = (row_valid.sum() * pred.shape[1]).clamp(min=1)
        return {"loss_context": loss.sum() / denom}

    def loss_mask_prediction(self, outputs, targets, indices, num_segments, num_tokens):
        mask_prediction = outputs["backbone_mask_prediction"]  # (B, S)
        with torch.no_grad():
            flat_grid = attn_map_to_flat_grid(
                outputs["temporal_shapes"], outputs["level_start_index"],
                outputs["sampling_locations_dec"], outputs["attn_weights_dec"],
            ).sum(dim=(1, 2))  # (B, S)
            if outputs.get("mask_flatten") is not None:
                flat_grid = torch.where(outputs["mask_flatten"],
                                        flat_grid.amin(dim=1, keepdim=True) - 1, flat_grid)
            K = outputs["backbone_topk_proposals"].shape[1]
            # stable descending sort: ties keep the lower index first, as
            # lax.top_k does
            topk_idx = torch.sort(flat_grid, dim=1, descending=True, stable=True).indices[:, :K]
            keep = (torch.arange(K, device=flat_grid.device)[None]
                    < outputs["sparse_token_nums"][:, None])
            B, S = mask_prediction.shape
            # the first sparse_token_nums[b] tokens get 1; the other slots
            # scatter-max 0 into the last token, as the reference does
            target = torch.zeros((B, S), dtype=mask_prediction.dtype,
                                 device=mask_prediction.device)
            target = target.scatter_reduce(
                1, torch.where(keep, topk_idx, torch.full_like(topk_idx, S - 1)),
                keep.to(target.dtype), reduce="amax")
        return {"loss_mask_prediction": multilabel_soft_margin_loss(
            mask_prediction, target, row_valid=targets.get("batch_valid"))}

    @torch.no_grad()
    def corr(self, outputs, targets, indices, num_segments, num_tokens):
        if outputs.get("backbone_topk_proposals") is None:
            return {}
        shapes = outputs["temporal_shapes"]
        S = int(sum(int(t) for t in shapes))
        flat_topk = idx_to_flat_grid(S, outputs["backbone_topk_proposals"])
        flat_map = attn_map_to_flat_grid(
            shapes, outputs["level_start_index"],
            outputs["sampling_locations_dec"], outputs["attn_weights_dec"],
        ).sum(dim=(1, 2))
        corr = compute_corr(flat_topk, flat_map, shapes)
        return {"loss_corr": _masked_row_mean(corr[0], targets.get("batch_valid"))}

    def get_loss(self, loss, outputs, targets, indices, num_segments, num_tokens,
                 memory_mask=None):
        if loss == "labels":
            return self.loss_labels(outputs, targets, indices, num_segments, num_tokens)
        if loss == "segments":
            return self.loss_segments(outputs, targets, indices, num_segments, num_tokens)
        if loss == "captions":
            return self.loss_captions(outputs, targets, indices, num_segments, num_tokens)
        if loss == "contexts":
            return self.loss_contexts(outputs, targets, indices, num_segments, num_tokens,
                                      memory_mask)
        if loss == "mask_prediction":
            return self.loss_mask_prediction(outputs, targets, indices, num_segments,
                                             num_tokens)
        if loss == "corr":
            return self.corr(outputs, targets, indices, num_segments, num_tokens)
        raise ValueError(f"unknown loss {loss!r}")

    def __call__(self, outputs: Dict, targets: Dict, indices: torch.Tensor,
                 indices_aux: Optional[torch.Tensor],
                 memory_mask: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
        num_segments = targets["gt_mask"].sum().float().clamp(min=1.0)
        cap = targets["cap_tokens"].reshape(-1, targets["cap_tokens"].shape[-1])
        num_tokens = (cap[:, 1:] != self.pad_idx).sum().float().clamp(min=1.0)
        stacked_captions = outputs.get("pred_captions_all")

        losses: Dict[str, torch.Tensor] = {}
        for loss in self.losses:
            if loss == "captions" and stacked_captions is not None:
                per_depth = label_smoothing_kl_logits_stack(
                    stacked_captions, cap[:, 1:], self.pad_idx, self.smoothing) / num_tokens
                losses["loss_caption"] = per_depth[-1]
                for i in range(stacked_captions.shape[0] - 1):
                    losses[f"loss_caption_{i}"] = per_depth[i]
                continue
            losses.update(self.get_loss(loss, outputs, targets, indices, num_segments,
                                        num_tokens, memory_mask))

        per_layer = ("labels", "segments")
        for i, aux in enumerate(outputs.get("aux_outputs", [])):
            for loss in self.losses:
                if loss in per_layer:
                    l_dict = self.get_loss(loss, aux, targets, indices_aux[i],
                                           num_segments, num_tokens)
                    losses.update({f"{k}_{i}": v for k, v in l_dict.items()})
        if "captions" in self.losses:
            for i, aux in enumerate(outputs.get("aux_outputs_caption", [])):
                l_dict = self.loss_captions(aux, targets, None, num_segments, num_tokens)
                losses.update({f"{k}_{i}": v for k, v in l_dict.items()})
        # the encoder's auxiliary outputs reuse the decoder's aux matchings
        for i, aux in enumerate(outputs.get("aux_outputs_enc", [])):
            for loss in self.losses:
                if loss in per_layer:
                    l_dict = self.get_loss(loss, aux, targets, indices_aux[i],
                                           num_segments, num_tokens)
                    losses.update({f"{k}_enc_{i}": v for k, v in l_dict.items()})
        return losses


def build_weight_dict(cfg) -> Dict[str, float]:
    """Loss name -> coefficient, with the aux, caption and encoder-aux
    suffixes."""
    dvc = cfg.dvc
    weight_dict = {
        "loss_ce": dvc.cls_loss_coef,
        "loss_counter": dvc.counter_loss_coef,
        "loss_bbox": dvc.bbox_loss_coef,
        "loss_giou": dvc.giou_loss_coef,
        "loss_self_iou": dvc.self_iou_loss_coef,
        "loss_caption": dvc.caption_loss_coef,
        "loss_context": dvc.context_loss_coef,
        "loss_mask_prediction": dvc.mask_prediction_coef,
        "loss_corr": dvc.corr_coef,
    }
    if dvc.aux_loss:
        aux = {}
        for i in range(dvc.detr.dec_layers - 1):
            aux.update({f"{k}_{i}": v for k, v in weight_dict.items() if k != "loss_caption"})
        for i in range(dvc.caption.depth - 1):
            aux[f"loss_caption_{i}"] = weight_dict["loss_caption"]
        weight_dict.update(aux)
    if dvc.use_sparse_detr and dvc.detr.use_enc_aux_loss:
        base = {k: v for k, v in weight_dict.items()
                if "_enc_" not in k and not k[-1].isdigit()}
        for i in range(dvc.detr.enc_layers - 1):
            weight_dict.update({f"{k}_enc_{i}": v for k, v in base.items()})
    return weight_dict


def build_criterion(cfg, pad_idx: int):
    """(SetCriterion over ``cfg.dvc.losses``, weight_dict)."""
    weight_dict = build_weight_dict(cfg)
    criterion = SetCriterion(
        losses=list(cfg.dvc.losses), pad_idx=pad_idx, smoothing=cfg.dvc.smoothing,
        lloss_gau_mask=cfg.dvc.lloss_gau_mask, lloss_beta=cfg.dvc.lloss_beta)
    return criterion, weight_dict
