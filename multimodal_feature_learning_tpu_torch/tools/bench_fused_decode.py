"""A/B of the caption-decode backends through ``forward_eval(batch, "serve")``
on the card: counterpart of the JAX repository's
``tools/bench_fused_decode.py``.

    python3 -m multimodal_feature_learning_tpu_torch.tools.bench_fused_decode [--iters 24]

Arms: ``xla`` (the plain-op decode), ``fused`` (the fused decode step, grid
"video"), ``fusedb`` (grid "batch") and ``fusedb_int8`` (grid "batch", int8
memory K/V). One model at the flagship's widths with random weights (seed
0), in ``--dtype`` ("float32", or "bfloat16": the config's
``compute_dtype``, as the JAX tool's bf16 trunk), batches of 16 synthetic videos (``data/anet.py::synthetic_batches``,
seed 0, the flagship vocabulary); the arms differ only in the decode
backend, so the difference between them is the decode's. The arms take
turns within every iteration, since the host's speed moves between calls
and within one. Host clock around a synchronize per forward. Prints one
JSON line with ``<arm>_videos_per_s`` and ``<arm>_step_ms``.
"""

from __future__ import annotations

import argparse
import copy
import json
import time
from typing import Dict, Sequence

from ..config import apply_overrides, load_config
from ..data.anet import synthetic_batches
from ..device import resolve_device
from ..engine.train import batch_to_device
from ..models.dvc import build_model
from .timing import device_label, sync

VOCAB_SIZE = 6563  # the flagship vocabulary (snapshots/conv_e79.npz)
ARMS = ("xla", "fused", "fusedb", "fusedb_int8")
# an arm's (decode_impl, decode_kv, decode_fused_grid); "b" is grid "batch"
ARM_SETTINGS = {
    "xla": ("xla", "dense", "video"),
    "fused": ("fused", "dense", "video"),
    "fusedb": ("fused", "dense", "batch"),
    "fused_int8": ("fused", "int8", "video"),
    "fusedb_int8": ("fused", "int8", "batch"),
}


def arm_settings(name: str):
    """(decode_impl, decode_kv, decode_fused_grid) of an arm."""
    if name not in ARM_SETTINGS:
        raise ValueError(f"unknown arm {name!r}, not one of {tuple(ARM_SETTINGS)}")
    return ARM_SETTINGS[name]


def run(device="cuda", arms: Sequence[str] = ARMS, batch: int = 16, iters: int = 24,
        n_batches: int = 4, dtype: str = "float32", cfg=None,
        vocab_size: int = VOCAB_SIZE) -> Dict:
    """Each arm's videos per second and mean ms per forward over ``iters``
    forwards, after one warm-up forward of every arm."""
    dev = resolve_device(device)
    settings = {name: arm_settings(name) for name in arms}
    cfg = copy.deepcopy(cfg or load_config())
    cfg.compute_dtype = dtype  # build_model raises on a dtype the port does not take
    model = build_model(cfg, vocab_size, device=dev, seed=0)
    batches = [batch_to_device(b, dev)
               for b in synthetic_batches(cfg, batch, vocab_size, seed=0, num_batches=n_batches)]
    elapsed = dict.fromkeys(arms, 0.0)

    def forward(name, b):
        model.decode_impl, model.decode_kv, model.decode_fused_grid = settings[name]
        try:
            return model.forward_eval(b, "serve")
        finally:
            model.decode_impl, model.decode_kv, model.decode_fused_grid = (
                cfg.decode_impl, cfg.decode_kv, cfg.decode_fused_grid)

    for name in arms:
        forward(name, batches[0])
    for i in range(iters):
        b = batches[i % len(batches)]
        for name in arms:
            sync(dev)
            t0 = time.perf_counter()
            forward(name, b)
            sync(dev)
            elapsed[name] += time.perf_counter() - t0
    rows = {"device": device_label(dev), "batch": batch, "iters": iters, "dtype": dtype}
    for name in arms:
        rows[f"{name}_videos_per_s"] = batch * iters / elapsed[name]
        rows[f"{name}_step_ms"] = 1e3 * elapsed[name] / iters
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--configs", default=",".join(ARMS), help="xla | fused[b][_int8]")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--config-overrides", nargs="*", default=[], help="key=value overrides of the config, e.g. dvc.caption.d_model=768 dvc.caption.num_heads=12 dvc.caption.mlp_ratio=2 (the fused decode at other widths: each (D, Dh) is built at its first launch)")
    args = ap.parse_args()
    print(json.dumps(run(args.device, args.configs.split(","), args.batch, args.iters,
                         dtype=args.dtype,
                         cfg=apply_overrides(load_config(), args.config_overrides))))


if __name__ == "__main__":
    main()
