"""Evaluation entry point of the port: annotations and features on disk ->
vocab -> dataset -> prefetching loader -> eval step -> ``evaluate`` ->
submission JSON -> ActivityNet Captions scores. Counterpart of the JAX
package's root ``inference.py`` (and of ``main.py --mode eval``).

    python -m multimodal_feature_learning_tpu_torch.inference \\
        [--weights snapshot.npz] [--synthetic] [--batch-size N] \\
        [--val-mode teacher_forcing|one_by_one|beam] [--device cuda|cpu] \\
        [--config-overrides a.b=value ...]

``--weights`` loads a flat flax snapshot (the ``tools/snapshot_ckpt.py``
format) strictly; without it the weights are drawn from ``cfg.seed``.
``--synthetic`` first writes a small synthetic world (annotations,
``.npy`` features) under ``./synthetic_anet`` and reads it. The
ground truth scored against is the val split's annotation file.
"""

from __future__ import annotations

import argparse
import json
import os
import random
from typing import Optional

import numpy as np

from .config import apply_overrides, load_config, recompute_losses
from .data.anet import SPLIT_FILES, FeatureBackend, build_dataset
from .data.loader import DataLoader
from .data.vocab import Vocab
from .device import resolve_device
from .engine.evaluate import evaluate, make_eval_step
from .evaluation import run_eval
from .models.criterion import build_criterion
from .models.dvc import build_model
from .utils.weights import load_flax_params, load_npz

SYNTHETIC_WORDS = ["a", "man", "is", "playing", "guitar", "the", "dog", "runs",
                   "across", "field", "person", "rides", "bike", "crowd", "cheers"]


def make_synthetic_world(cfg, tmpdir: str = "./synthetic_anet",
                         vocab: Optional[Vocab] = None):
    """Writes a small synthetic world and points ``cfg`` at it: the JAX
    package's ``main.py::make_synthetic_world`` annotations (64 train and 32
    val videos, numpy seed ``cfg.seed``, sentences of 4-8 of 15 words), the
    JAX package's synthetic features of every video as ``features/<key>.npy``
    ((64, feature_dim), seeded by the key's crc32), and, when ``vocab`` is
    given, that vocabulary as the world's vocab file (else the vocab is
    built from the train split on first use). Returns ``cfg``."""
    os.makedirs(tmpdir, exist_ok=True)
    feat_dir = os.path.join(tmpdir, "features")
    os.makedirs(feat_dir, exist_ok=True)
    synthetic = FeatureBackend("", feature_dim=cfg.dvc.detr.feature_dim)
    rng = np.random.default_rng(cfg.seed)
    for split, n in ((SPLIT_FILES["train"], 64), (SPLIT_FILES["val"], 32)):
        ann = {}
        for i in range(n):
            dur = float(rng.uniform(10, 120))
            k = int(rng.integers(1, 5))
            stamps, sents = [], []
            for _ in range(k):
                s = float(rng.uniform(0, dur * 0.7))
                e = float(rng.uniform(s + 1.0, dur))
                stamps.append([s, e])
                sents.append(" ".join(rng.choice(SYNTHETIC_WORDS, size=int(rng.integers(4, 9)))))
            key = f"{split[:2]}_{i:05d}"
            ann[key] = {"duration": dur, "timestamps": stamps, "sentences": sents}
            np.save(os.path.join(feat_dir, key + ".npy"), synthetic.get(key))
        with open(os.path.join(tmpdir, split), "w") as f:
            json.dump(ann, f)
    anet = cfg.dataset.activity_net
    anet.anet_path = tmpdir
    anet.video_features_file = feat_dir
    anet.vocab_file_path = os.path.join(tmpdir, "vocab.pkl")
    if vocab is not None:
        vocab.save(anet.vocab_file_path)
    return cfg


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--weights", default=None,
                   help="flat flax snapshot (.npz) to load strictly")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="write and read a small synthetic world (no data needed)")
    p.add_argument("--val-mode", default="teacher_forcing",
                   choices=["teacher_forcing", "one_by_one", "beam"])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--config-overrides", nargs="*", default=[],
                   help="dotted config overrides, e.g. dvc.d_model=256")
    return p.parse_args(argv)


def main(argv=None):
    """Runs the evaluation; returns (val_stats, submission, scores)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = apply_overrides(load_config(), args.config_overrides)
    if args.synthetic:
        # after the overrides: the features are written at their feature_dim
        cfg = make_synthetic_world(cfg)
    recompute_losses(cfg)
    if args.batch_size is not None:
        cfg.batch_size = args.batch_size

    anet = cfg.dataset.activity_net
    val_ds, vocab = build_dataset("val", cfg)
    if anet.val_subset:
        val_ds.keys = sorted(val_ds.keys)[: anet.val_subset]
    val_loader = DataLoader(
        val_ds, cfg.batch_size, vocab.pad_idx,
        video_rescale_len=anet.video_rescale_len,
        max_gt=anet.max_gt_target_segments,
        max_caption_len=anet.max_caption_len_all,
        shuffle=False, seed=cfg.seed)

    model = build_model(cfg, len(vocab), vocab.pad_idx, vocab.bos_idx, vocab.eos_idx,
                        device=dev, seed=cfg.seed)
    if args.weights:
        load_flax_params(model, load_npz(args.weights))
    criterion, weight_dict = build_criterion(cfg, vocab.pad_idx)
    eval_step = make_eval_step(
        model, criterion, weight_dict, args.val_mode, faster_eval=cfg.eval.faster_eval,
        beam_size=cfg.eval.beam_size, length_penalty=cfg.eval.length_penalty)

    gt_path = os.path.join(anet.anet_path, SPLIT_FILES["val"])
    score_fn = lambda sub: run_eval(cfg.eval, sub, gt_path, rng=random.Random(cfg.seed))  # noqa: E731
    stats, submission, scores = evaluate(eval_step, val_loader, vocab, cfg, epoch=0,
                                         score_fn=score_fn, device=dev)
    print("val stats:", {k: round(float(v), 4) for k, v in stats.items()})
    return stats, submission, scores


if __name__ == "__main__":
    main()
