"""The serving forward against its proposal half, and the greedy decode's
cost per token and per caption layer, on the card: counterpart of the JAX
repository's ``tools/profile_decode.py``.

    python3 -m multimodal_feature_learning_tpu_torch.tools.profile_decode

At B=16, f32, the flagship's widths with random weights (seed 0; timing
only) and the configured ``decode_impl``:

1. ``forward_serve`` at caption length 20 and depth 6, and the proposal
   half alone (``_serve_prepare``: proposals, ranking, crop masks); their
   difference is the decode;
2. ``forward_serve`` at caption length 8: the per-token slope is the
   difference over the difference of decode steps run (12 when every
   caption runs to the end);
3. the same at caption depth 3: the per-layer share of a token's cost, and
   what is left for the embedding, the vocabulary head and the step's host
   work.

Host clock around a synchronize, best of ``reps`` runs of the mean of ``n``
calls. The decode ends early once every caption has emitted <eos>, so each
variant's decode steps are reported beside its time.
"""

from __future__ import annotations

import argparse
import copy
from typing import Dict, Sequence

import numpy as np
import torch

from ..config import apply_overrides, load_config
from ..device import resolve_device
from ..models.dvc import build_model
from .timing import device_label, host_ms

VOCAB_SIZE = 6563  # the flagship vocabulary (snapshots/conv_e79.npz)


def decode_steps_run(captions: torch.Tensor, eos_idx: int, seq_len: int) -> int:
    """Steps the greedy decode ran to produce ``captions`` (N, Lc+1): until
    the last caption's first <eos>, at most seq_len - 1."""
    is_eos = captions[:, 1:-1] == eos_idx
    first_eos = torch.where(is_eos.any(1), is_eos.float().argmax(1) + 1,
                            torch.full_like(is_eos[:, 0], seq_len - 1, dtype=torch.long))
    return int(first_eos.max())


def serve_inputs(cfg, batch: int, dev):
    """Random features (numpy seed 0), no padding, 60 s durations."""
    T = cfg.dataset.activity_net.video_rescale_len
    video = np.random.default_rng(0).normal(size=(batch, T, cfg.dvc.detr.feature_dim))
    return (torch.from_numpy(video.astype(np.float32)).to(dev),
            torch.zeros((batch, T), dtype=torch.bool, device=dev),
            torch.full((batch,), 60.0, device=dev))


def run(device="cuda", cfg=None, vocab_size: int = VOCAB_SIZE, batch: int = 16,
        lcs: Sequence[int] = (20, 8), depths: Sequence[int] = (6, 3), n: int = 20,
        reps: int = 2, decode_impl: str = None) -> Dict:
    """The rows of the JAX tool, named after ``lcs`` and ``depths``, and the
    decode steps each variant ran."""
    dev = resolve_device(device)
    cfg0 = copy.deepcopy(cfg or load_config())
    if decode_impl is not None:
        cfg0.decode_impl = decode_impl
    (lc, lc_short), (depth, depth_short) = lcs, depths
    args = serve_inputs(cfg0, batch, dev)
    rows, steps = {}, {}
    for c, d in ((lc, depth), (lc_short, depth), (lc, depth_short), (lc_short, depth_short)):
        cfg = copy.deepcopy(cfg0)
        cfg.dataset.activity_net.max_caption_len_all = c
        cfg.dvc.caption.depth = d
        model = build_model(cfg, vocab_size, device=dev, seed=0)
        serve = lambda: model.forward_serve(*args)  # noqa: E731
        steps[f"Lc{c}_d{d}"] = decode_steps_run(serve()["captions"].reshape(-1, c + 1),
                                                model.eos_idx, c)
        rows[f"serve_Lc{c}_d{d}_ms"] = host_ms(serve, dev, n, reps)
        if (c, d) == (lc, depth):
            with torch.no_grad():
                prep = lambda: model._serve_prepare(*args)  # noqa: E731
                prep()
                rows["proposal_only_ms"] = host_ms(prep, dev, n, reps)
            rows[f"decode_Lc{c}_d{d}_ms"] = rows[f"serve_Lc{c}_d{d}_ms"] - rows["proposal_only_ms"]
        del model

    def per_token(d):
        gap = steps[f"Lc{lc}_d{d}"] - steps[f"Lc{lc_short}_d{d}"]
        dt = rows[f"serve_Lc{lc}_d{d}_ms"] - rows[f"serve_Lc{lc_short}_d{d}_ms"]
        return dt / gap if gap > 0 else None

    # None where a pair of variants ran equally many decode steps
    tok, tok_short = per_token(depth), per_token(depth_short)
    rows[f"ms_per_decode_token_d{depth}"] = tok
    rows[f"ms_per_decode_token_d{depth_short}"] = tok_short
    per_layer = None if None in (tok, tok_short) else (tok - tok_short) / (depth - depth_short)
    rows["ms_per_token_per_layer"] = per_layer
    rows["ms_per_token_depth_independent"] = None if per_layer is None else tok - depth * per_layer
    return {"device": device_label(dev), "batch": batch, "decode_impl": cfg0.decode_impl,
            "decode_steps": steps, "rows": rows}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--decode-impl", default=None, help="xla | fused (default: the config's)")
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--config-overrides", nargs="*", default=[], help="key=value overrides of the config, e.g. dvc.caption.d_model=768 dvc.caption.num_heads=12 dvc.caption.mlp_ratio=2 (the fused decode at other widths: each (D, Dh) is built at its first launch)")
    args = ap.parse_args()
    result = run(args.device, apply_overrides(load_config(), args.config_overrides), n=args.n,
                 decode_impl=args.decode_impl)
    print(f"device: {result['device']}, decode_impl {result['decode_impl']}, "
          f"decode steps {result['decode_steps']}")
    for k, v in result["rows"].items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
