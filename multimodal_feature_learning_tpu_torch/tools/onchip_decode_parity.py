"""Token agreement of the fused decode backends with the plain-op decode, with
trained weights, on the card: counterpart of the JAX repository's
``tools/onchip_decode_parity.py``.

    python3 -m multimodal_feature_learning_tpu_torch.tools.onchip_decode_parity \\
        [--n-videos 128] [--configs fused,fusedb,fusedb_int8]

The flagship model carries ``snapshots/conv_e79.npz`` (through
``utils/weights.py``, strictly; trained without the differentiable context
mask, so built without it) and serves ``n_videos`` synthetic videos
(``data/anet.py::synthetic_batches``, seed 0) in batches of 16 through
``forward_eval(batch, "serve")``, once with the plain-op decode (``xla``)
and once per arm. Per arm, against ``xla``:

- ``event_exact_pct``: caption rows whose whole token sequence is equal;
- ``token_agree_pct``: tokens equal over all caption positions;
- ``events``: caption rows compared;
- ``seg_max_delta``: the largest |pred_segments| difference, which must be
  0.0, since a decode backend may not touch the proposal stack.

The JAX tool reads real ActivityNet annotations, which the repository does
not hold; synthetic videos stand in for them. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time
from pathlib import Path
from typing import Dict, Sequence

from ..config import apply_overrides, load_config, recompute_losses
from ..data.anet import synthetic_batches
from ..device import resolve_device
from ..engine.train import batch_to_device
from ..models.dvc import build_model
from ..utils.weights import load_flax_params, load_npz
from .bench_fused_decode import VOCAB_SIZE, arm_settings
from .timing import device_label, sync

SNAPSHOT = str(Path(__file__).resolve().parents[2] / "snapshots" / "conv_e79.npz")
ARMS = ("fused", "fusedb", "fusedb_int8")


def run(device="cuda", arms: Sequence[str] = ARMS, n_videos: int = 128, batch: int = 16,
        snapshot=SNAPSHOT, cfg=None, vocab_size: int = None) -> Dict:
    """The rows of every arm. ``snapshot`` None builds random weights from
    seed 0 at ``cfg``'s widths and ``vocab_size`` (for tests at small
    widths); otherwise the snapshot must exist and sets the vocabulary."""
    dev = resolve_device(device)
    cfg = copy.deepcopy(cfg or load_config())
    cfg.use_differentiable_mask = False  # the conv checkpoints train this path
    recompute_losses(cfg)
    if snapshot is not None:
        flat = load_npz(snapshot)
        vocab_size = int(flat["BF16||caption||params||head||bias"].shape[0])
        source = f"{os.path.relpath(snapshot)} (epoch {int(flat['__epoch__'])})"
    else:
        source = "random weights (seed 0)"
    model = build_model(cfg, vocab_size, device=dev, seed=0)
    if snapshot is not None:
        load_flax_params(model, flat)
    n_batches = -(-n_videos // batch)
    batches = [batch_to_device(b, dev)
               for b in synthetic_batches(cfg, batch, vocab_size, seed=0, num_batches=n_batches)]

    def serve_all(name):
        model.decode_impl, model.decode_kv, model.decode_fused_grid = arm_settings(name)
        try:
            caps, segs = [], []
            for b in batches:
                out, captions, *_ = model.forward_eval(b, "serve")
                caps.append(captions.cpu())
                segs.append(out["pred_segments"].cpu())
            return caps, segs
        finally:
            model.decode_impl, model.decode_kv, model.decode_fused_grid = "xla", "dense", "video"

    rows = {"checkpoint": source, "dtype": "float32", "n_videos": n_batches * batch,
            "device": device_label(dev)}
    t0 = time.perf_counter()
    base_caps, base_segs = serve_all("xla")
    sync(dev)
    rows["xla_s"] = time.perf_counter() - t0
    for name in arms:
        t0 = time.perf_counter()
        caps, segs = serve_all(name)
        rows[f"{name}_s"] = time.perf_counter() - t0
        n_events = n_exact = n_tok = n_agree = 0
        seg_delta = 0.0
        for c, bc, s, bs in zip(caps, base_caps, segs, base_segs):
            n_events += c.shape[0]
            n_exact += int((c == bc).all(dim=-1).sum())
            n_tok += c.numel()
            n_agree += int((c == bc).sum())
            seg_delta = max(seg_delta, float((s - bs).abs().max()))
        rows[f"{name}_event_exact_pct"] = 100 * n_exact / max(n_events, 1)
        rows[f"{name}_token_agree_pct"] = 100 * n_agree / max(n_tok, 1)
        rows[f"{name}_events"] = n_events
        rows[f"{name}_seg_max_delta"] = seg_delta
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-videos", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--configs", default=",".join(ARMS), help="fused[b][_int8]")
    ap.add_argument("--snapshot", default=SNAPSHOT,
                    help="'' for random weights from seed 0 (at any widths)")
    ap.add_argument("--config-overrides", nargs="*", default=[], help="key=value overrides of the config, e.g. dvc.caption.d_model=768 dvc.caption.num_heads=12 dvc.caption.mlp_ratio=2 (the fused decode at other widths: each (D, Dh) is built at its first launch)")
    args = ap.parse_args()
    print(json.dumps(run(args.device, args.configs.split(","), args.n_videos, args.batch,
                         args.snapshot or None,
                         apply_overrides(load_config(), args.config_overrides), VOCAB_SIZE)))


if __name__ == "__main__":
    main()
