"""The plain reference's drivers: its model of a configuration with the
same weights the program got, its serving outputs (every query's segment
and score, the count head, the memory) and teacher-forced caption logits,
and its first training steps. ``precision`` sets the numerics the
reference computes in: "f32" (TF32 off, as the configurations state) or
"tf32", the control's."""

from __future__ import annotations

import contextlib
import os
from typing import Dict, List

import numpy as np
import torch

from .config import load_config
from .models.caption_decoder import make_causal_mask
from .models.criterion import build_criterion
from .models.dvc import UnimodalDVC, crop_segment_mask
from .models.layers import dropout_generator
from .models.multimodal import MultimodalDVC
from .ops.segment_ops import denormalize_segments
from .utils.weights import load_flax_params, load_npz

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _apply(cfg, tree: dict):
    for key, value in tree.items():
        if isinstance(value, dict):
            _apply(getattr(cfg, key), value)
        else:
            setattr(cfg, key, list(value) if isinstance(value, list) else value)
    return cfg


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10 explicit mantissa bits (to nearest,
    ties away from zero, as the tensor cores' conversion does)."""
    if t.dtype != torch.float32:
        return t
    bits = t.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    # the gradient passes as through the identity
    return t + (rounded - t).detach() if t.requires_grad else rounded


class _TF32Products(torch.overrides.TorchFunctionMode):
    """On the CPU, which has no TF32: the operands of every matrix product
    and convolution rounded to TF32 before an f32 product."""

    PRODUCTS = {torch.nn.functional.linear, torch.matmul, torch.bmm, torch.mm,
                torch.einsum, torch.nn.functional.conv1d, torch.Tensor.__matmul__,
                torch.baddbmm, torch.addmm}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.PRODUCTS:
            if func is torch.einsum:
                args = (args[0],) + tuple(round_tf32(a) if isinstance(a, torch.Tensor) else a
                                          for a in args[1:])
            else:
                args = tuple(round_tf32(a) if isinstance(a, torch.Tensor) else a
                             for a in args)
        return func(*args, **kwargs)


@contextlib.contextmanager
def precision(mode: str, device):
    """The reference's numerics in the block: "f32" (TF32 off) or "tf32"
    (on the card the tensor cores' TF32 for every f32 product and
    convolution; on the CPU the same rounding of the operands)."""
    if mode not in ("f32", "tf32"):
        raise ValueError(f"precision must be 'f32' or 'tf32', got {mode!r}")
    tf32 = mode == "tf32"
    if torch.device(device).type == "cuda":
        old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    elif tf32:
        with _TF32Products():
            yield
    else:
        yield


def build(spec: dict, device, seed: int):
    """(cfg, model) of the configuration file ``spec`` on ``device`` in eval
    mode, with the weights the program was given: the snapshot read from its
    file, or the seeded draw of ``portbench.weights``."""
    from ..weights import fill_seeded

    cfg = _apply(load_config(), spec["config"])
    cls = MultimodalDVC if len(cfg.dvc.input_modalities) == 2 else UnimodalDVC
    with torch.device(device):
        model = cls(cfg, spec["vocab_size"])
    model = model.to(device).eval()
    if spec["weights"]["kind"] == "snapshot":
        load_flax_params(model, load_npz(os.path.join(ROOT, spec["weights"]["path"])))
    else:
        fill_seeded(model, seed)
    return cfg, model


def nearest_resize(x: np.ndarray, new_size: int) -> np.ndarray:
    idx = (np.arange(new_size) * x.shape[0]) // new_size
    return x[idx]


@torch.no_grad()
def serve_outputs(model, requests, device) -> Dict[str, torch.Tensor]:
    """The proposal half of serving for ``requests`` [(features (T, D),
    duration)], one batch: every query's segment (B, Q, 2) in seconds and
    stability score (B, Q), the top-G order (B, G), the count head (B, C),
    the memory (B, S, D) and each top-G event's crop mask (B, G, S)."""
    video = np.stack([nearest_resize(f, model.video_rescale_len) for f, _ in requests])
    video = torch.from_numpy(video).to(device)
    durations = torch.tensor([d for _, d in requests], dtype=torch.float32, device=device)
    mask = torch.zeros(video.shape[:2], dtype=torch.bool, device=device)
    out = model._propose(video, mask, durations)
    seg_all = out["outputs_segment_all"]
    scores = -(seg_all[1:] - seg_all[:-1]).abs().mean(dim=(0, 3))  # (B, Q)
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :model.max_gt]
    segments = denormalize_segments(out["pred_segments"], durations[:, None])  # (B, Q, 2)
    rows = torch.arange(len(requests), device=device)[:, None]
    crop = crop_segment_mask(segments[rows, order], durations, model.video_rescale_len,
                             model.num_feature_levels, num_tokens=out["memory"].shape[1])
    return {"segments": segments, "scores": scores, "order": order,
            "count": out["pred_count"].float(), "memory": out["memory"], "crop": crop,
            "durations": durations}


@torch.no_grad()
def caption_logits(model, memory, crop, tokens) -> torch.Tensor:
    """The logits (B, G, Lc - 1, V) at which the greedy decode chose each
    served token, teacher forced: memory (B, S, D), crop (B, G, S) True =
    outside the event, tokens (B, G, Lc + 1) served captions (<bos> first).
    The port's decode predicts position p from a <pad> at p that attends
    the tokens before it and not itself (``decode_pair``), so position p is
    read from a pass over the tokens before p and a <pad>, with that <pad>
    masked as a key."""
    B, G = tokens.shape[:2]
    Lc = model.seq_len
    rows = tokens.reshape(B * G, -1).long()
    pad = torch.full((B * G, 1), model.pad_idx, dtype=torch.long, device=rows.device)
    out = []
    for p in range(1, Lc):
        tgt = torch.cat([rows[:, :p], pad], dim=1)
        own = torch.zeros(tgt.shape, dtype=torch.bool, device=tgt.device)
        own[:, p] = True
        logits = model.caption(tgt, memory, make_causal_mask(p + 1, tgt.device), own,
                               crop.reshape(B * G, -1), groups=G)
        out.append(logits[-1, :, p].float())
    return torch.stack(out, dim=1).reshape(B, G, Lc - 1, -1)


def step_seed(seed: int, step: int) -> int:
    """The dropout seed of ``step`` (the port's ``engine/train.py``)."""
    return (int(seed) * 0x9E3779B97F4A7C15 + int(step) * 0xBF58476D1CE4E5B9 + 1) % (1 << 63)


def train_steps(cfg, model, batches: List[Dict[str, np.ndarray]], seed: int, device,
                half_batch: bool = False):
    """The training steps of the port's trainer over ``batches`` from step
    0, as plain PyTorch: forward, the criterion's weighted sum, backward,
    the global-norm clip to optax's formula, AdamW (beta 0.9 / 0.999, eps
    1e-8, weight decay on every parameter) at the configured rate, dropout
    masks from a generator on the device seeded as the port seeds it. With
    ``half_batch`` (a fault, for the comparison's own check) each step sees
    the first half of its rows alone. Returns (losses, {name: first moment
    after step 1}, {name: parameter after the last step}, the FLOPs of the
    first step's forward and backward as ``FlopCounterMode`` counts them,
    and the first step's loss terms)."""
    from torch.utils.flop_counter import FlopCounterMode

    criterion, weight_dict = build_criterion(cfg, pad_idx=1)
    params = [p for p in model.parameters() if p.requires_grad]
    names = {p: n for n, p in model.named_parameters()}
    adamw = torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=cfg.weight_decay)
    gen = torch.Generator(device=device)
    losses, moments = [], None
    model.train()
    for step, batch in enumerate(batches):
        rows = slice(0, len(batch["durations"]) // 2) if half_batch else slice(None)
        tb = {k: torch.from_numpy(np.ascontiguousarray(v[rows])).to(device)
              for k, v in batch.items()}
        for p in params:
            p.grad = None
        counter = FlopCounterMode(display=False)
        with counter if step == 0 else contextlib.nullcontext():
            with dropout_generator(gen.manual_seed(step_seed(seed, step))):
                out, indices, indices_aux, memory_mask = model.forward_train(tb)
                terms = criterion(out, tb, indices, indices_aux, memory_mask)
                total = sum(terms[k] * weight_dict[k] for k in terms if k in weight_dict)
            total.backward()
        if step == 0:
            flops = counter.get_total_flops()
            first_terms = {k: float(v.detach()) for k, v in terms.items()}
        with torch.no_grad():
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            norm = torch.nn.utils.get_total_norm([p.grad for p in params])
            torch._foreach_mul_([p.grad for p in params],
                                (cfg.clip_max_norm / norm).clamp(max=1.0))
            adamw.step()
        losses.append(float(total.detach()))
        if step == 0:
            moments = {names[p]: adamw.state[p]["exp_avg"].clone() for p in params}
    model.eval()
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return losses, moments, params, flops, first_terms
