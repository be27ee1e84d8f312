"""Evaluation entry point of the port: annotations and features on disk ->
vocab -> dataset -> prefetching loader -> eval step -> ``evaluate`` ->
submission JSON -> ActivityNet Captions scores. Counterpart of the JAX
package's root ``inference.py`` (and of ``main.py --mode eval``).

    python -m multimodal_feature_learning_tpu_torch.inference \\
        [--weights snapshot.npz | --resume checkpoint] [--synthetic] [--batch-size N] \\
        [--val-mode teacher_forcing|one_by_one|beam] [--device cuda|cpu] \\
        [--config-overrides a.b=value ...]

``--weights`` loads a flat flax snapshot (the ``tools/snapshot_ckpt.py``
format) strictly, ``--resume`` the model of a checkpoint of the port's
training CLI (``main.py``), and the submission is saved under its epoch;
without either the weights are drawn from ``cfg.seed``.
``--synthetic`` first writes a small synthetic world (annotations,
``.npy`` features) under ``./synthetic_anet`` and reads it. The
ground truth scored against is the val split's annotation file. Under
torchrun each data rank of ``cfg.mesh`` evaluates its strided shard of the
split (``main.py``'s placement on the mesh), and rank 0 alone scores and
writes the merged submission.
"""

from __future__ import annotations

import argparse
import os
import random

import torch.distributed as dist

from .config import apply_overrides, load_config, recompute_losses
from .data.anet import SPLIT_FILES, build_dataset
from .data.loader import DataLoader
from .device import resolve_device
from .engine.evaluate import evaluate, make_eval_step
from .engine.state import load_model_weights
from .evaluation import run_eval
from .main import make_synthetic_world
from .models.criterion import build_criterion
from .models.dvc import build_model
from .parallel.mesh import (DATA, MODEL, axis_rank_size, is_main_process, main_process_first,
                            make_mesh, maybe_initialize_distributed, replicate_params)
from .parallel.tp import shard_params_tp
from .utils.weights import load_flax_params, load_npz


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--weights", default=None,
                   help="flat flax snapshot (.npz) to load strictly")
    p.add_argument("--resume", default=None,
                   help="a checkpoint of the port's training CLI (its model weights)")
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
    owns_group = not dist.is_initialized()
    distributed = maybe_initialize_distributed(args.device)
    dev = resolve_device(args.device)
    cfg = apply_overrides(load_config(), args.config_overrides)
    if args.synthetic:
        # after the overrides: the features are written at their feature_dim
        with main_process_first():
            cfg = make_synthetic_world(cfg, write=is_main_process())
    recompute_losses(cfg)
    if args.batch_size is not None:
        cfg.batch_size = args.batch_size
    mesh = make_mesh(cfg.mesh.num_data, cfg.mesh.num_model,
                     (cfg.mesh.data_axis, cfg.mesh.model_axis))
    data_rank, data_world = axis_rank_size(mesh, DATA)

    anet = cfg.dataset.activity_net
    with main_process_first():  # the vocab is written once
        val_ds, vocab = build_dataset("val", cfg)
    if anet.val_subset:
        val_ds.keys = sorted(val_ds.keys)[: anet.val_subset]
    val_loader = DataLoader(
        val_ds, cfg.batch_size, vocab.pad_idx,
        video_rescale_len=anet.video_rescale_len,
        max_gt=anet.max_gt_target_segments,
        max_caption_len=anet.max_caption_len_all,
        shuffle=False, seed=cfg.seed, rank=data_rank, world=data_world)

    model = build_model(cfg, len(vocab), vocab.pad_idx, vocab.bos_idx, vocab.eos_idx,
                        device=dev, seed=cfg.seed)
    epoch = 0
    if args.resume:
        epoch = load_model_weights(args.resume, model)
    elif args.weights:
        load_flax_params(model, load_npz(args.weights))
    replicate_params(model, mesh)
    if mesh is not None and cfg.mesh.num_model > 1:
        shard_params_tp(model, mesh, MODEL)
        model.shard_tokens_axis(mesh, MODEL)
    criterion, weight_dict = build_criterion(cfg, vocab.pad_idx)
    eval_step = make_eval_step(
        model, criterion, weight_dict, args.val_mode, faster_eval=cfg.eval.faster_eval,
        beam_size=cfg.eval.beam_size, length_penalty=cfg.eval.length_penalty, mesh=mesh)

    gt_path = os.path.join(anet.anet_path, SPLIT_FILES["val"])
    score_fn = lambda sub: run_eval(cfg.eval, sub, gt_path, rng=random.Random(cfg.seed))  # noqa: E731
    stats, submission, scores = evaluate(eval_step, val_loader, vocab, cfg, epoch=epoch,
                                         score_fn=score_fn, device=dev, mesh=mesh)
    print("val stats:", {k: round(float(v), 4) for k, v in stats.items()})
    if owns_group and distributed:
        dist.destroy_process_group()
    return stats, submission, scores


if __name__ == "__main__":
    main()
