"""Training and evaluation CLI of the port; counterpart of the JAX
repository's root ``main.py``.

    python -m multimodal_feature_learning_tpu_torch.main [--mode train|eval] \\
        [--epochs N] [--batch-size N] [--output-dir DIR] [--resume CHECKPOINT] \\
        [--weights snapshot.npz | --from-reference-checkpoint ref.pth \\
        [--trust-checkpoint]] [--synthetic] [--device cuda|cpu] \\
        [--config-overrides a.b=value ...]

In JAX's order: overrides, then the losses they imply; the train and val
datasets (``train_subset`` / ``val_subset`` keep the first sorted keys) and
their loaders (with the audio features when ``dvc.input_modalities`` has
two entries; with ``use_raw_videos`` the raw datasets, decoded frames and
log-mel spectrograms through ``data.raw_anet.collate_raw``); the model of
the config's family and its criterion (``models.build_model_and_criterion``;
``--weights``: a flat flax snapshot, loaded strictly;
``--from-reference-checkpoint``: a reference SAGA-DVC ``.pth`` of the
flagship family, ``utils/ref_bridge.py``, refused beside ``--weights``;
else weights drawn from ``cfg.seed``), and the train
state, its LR schedule counting the train loader's batches
(``steps_per_dispatch`` > 1: that many steps a dispatch, as JAX's
``make_train_multistep``); ``--resume``
restores a checkpoint and goes on at its epoch + 1. Each epoch trains, writes
the rolling ``<output_dir>/checkpoint``, keeps ``checkpoint{epoch:04d}`` on
``checkpoint_rate`` or ``lr_drop`` epochs, evaluates and scores on
``eval_rate`` epochs and the last, and appends JSON lines to
``train_log.txt`` (``train_*``, ``val_*``, ``score_*``, ``epoch``) and, on
eval epochs, ``val_log.txt``. With ``rss_restart_gb`` > 0 the run exits
with status 75 at the end of an epoch, after its checkpoint, once the
process's resident memory exceeds that many GB (any rank's, under a group):
relaunch with ``--resume`` to go on. ``wandb.on`` prints that wandb is not
installed and goes on (the port never imports it). ``--mode eval``
evaluates once and returns.
``--synthetic`` first writes a small synthetic world under
``./synthetic_anet`` and reads it.

Under torchrun (``torchrun --nproc-per-node N -m
multimodal_feature_learning_tpu_torch.main ...``) the processes form a
group (``parallel.mesh.maybe_initialize_distributed``) laid out as
``cfg.mesh``: each data rank reads its strided shard of every epoch at
``--batch-size`` rows a step (the global batch is that times the data
ranks), rank 0's weights are broadcast, and with ``mesh.num_model`` > 1 the
parameters are placed tensor-parallel and the decoder's value tokens split
over the model axis. Rank 0 alone writes the logs, the checkpoints and the
submission; checkpoints are unsharded, so a run resumes on any mesh or in
one process.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import random
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .config import apply_overrides, load_config, recompute_losses
from .data.anet import SPLIT_FILES, FeatureBackend, audio_rescale_len, build_dataset
from .data.loader import DataLoader
from .data.raw_anet import build_raw_dataset, collate_raw
from .data.vocab import Vocab
from .device import resolve_device
from .engine.evaluate import evaluate, make_eval_step
from .engine.state import create_train_state, load_checkpoint, save_checkpoint, shard_state
from .engine.train import (
    TRANSFER_DTYPES, make_train_multistep, make_train_step, train_one_epoch,
)
from .evaluation import run_eval
from .models import build_model_and_criterion
from .parallel.mesh import (DATA, MODEL, axis_rank_size, is_main_process, main_process_first,
                            make_mesh, maybe_initialize_distributed, replicate_params)
from .utils.ref_bridge import load_reference_checkpoint
from .utils.weights import load_flax_params, load_npz

SYNTHETIC_WORDS = ["a", "man", "is", "playing", "guitar", "the", "dog", "runs",
                   "across", "field", "person", "rides", "bike", "crowd", "cheers"]


def make_synthetic_world(cfg, tmpdir: str = "./synthetic_anet",
                         vocab: Optional[Vocab] = None, write: bool = True):
    """Writes a small synthetic world and points ``cfg`` at it: the JAX
    package's ``main.py::make_synthetic_world`` annotations (64 train and 32
    val videos, numpy seed ``cfg.seed``, sentences of 4-8 of 15 words), the
    JAX package's synthetic features of every video as ``features/<key>.npy``
    ((64, feature_dim), seeded by the key's crc32), and, when ``vocab`` is
    given, that vocabulary as the world's vocab file (else the vocab is
    built from the train split on first use). ``write`` False only points
    ``cfg`` at the world (the ranks of a group but the first). Returns
    ``cfg``."""
    anet = cfg.dataset.activity_net
    feat_dir = os.path.join(tmpdir, "features")
    anet.anet_path = tmpdir
    anet.video_features_file = feat_dir
    anet.vocab_file_path = os.path.join(tmpdir, "vocab.pkl")
    if not write:
        return cfg
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
    if vocab is not None:
        vocab.save(anet.vocab_file_path)
    return cfg


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", default="train", choices=["train", "eval"])
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--output-dir", default=None)
    p.add_argument("--resume", default=None, help="a checkpoint written by this CLI")
    p.add_argument("--weights", default=None,
                   help="flat flax snapshot (.npz) to start from, loaded strictly")
    add_reference_flags(p)
    p.add_argument("--synthetic", action="store_true",
                   help="write and read a small synthetic world (no data needed)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--config-overrides", nargs="*", default=[],
                   help="dotted config overrides, e.g. dvc.d_model=256")
    return p.parse_args(argv)


def add_reference_flags(p: argparse.ArgumentParser) -> None:
    """``--from-reference-checkpoint`` and ``--trust-checkpoint``, with the
    JAX CLIs' help."""
    p.add_argument("--from-reference-checkpoint", default=None,
                   help="migrate a reference-trained .pth (main.py:129-134 "
                        "format) into the flagship UnimodalSparseDVC params")
    p.add_argument("--trust-checkpoint", action="store_true",
                   help="allow the full pickle loader for reference "
                        ".pth files that weights_only rejects "
                        "(executes code embedded in the file)")


def refuse_two_sources(args) -> None:
    """``--weights`` and ``--from-reference-checkpoint`` both name the
    starting weights: refused rather than one silently taking precedence."""
    if args.weights and args.from_reference_checkpoint:
        raise SystemExit("--weights and --from-reference-checkpoint both name the starting "
                         "weights; pass one of them")


def import_reference(args, model, cfg) -> None:
    """``--from-reference-checkpoint``: the file into ``model``, with the
    JAX CLIs' line."""
    leftover = load_reference_checkpoint(args.from_reference_checkpoint, model, cfg,
                                         trust_pickle=args.trust_checkpoint)
    print(f"imported reference checkpoint {args.from_reference_checkpoint} "
          f"({len(leftover)} reference-only keys skipped)")


def place_on_mesh(state, mesh, cfg) -> None:
    """Place a (loaded) train state on the mesh: replicated, or with
    ``mesh.num_model`` > 1 tensor-parallel over the model axis, with the
    sparse and dense families' decoder value tokens split over it too."""
    if mesh is None or cfg.mesh.num_model == 1:
        return
    shard_state(state, mesh, tp_axis=MODEL)
    if hasattr(state.model, "shard_tokens_axis"):
        state.model.shard_tokens_axis(mesh, MODEL)


RSS_RESTART_STATUS = 75  # EX_TEMPFAIL: not a finished run ("Training done", 0)


def host_rss_gb() -> float:
    """The process's resident memory in GB (``VmRSS`` of /proc/self/status,
    as JAX's ``main.py`` reads it), 0.0 where that cannot be read."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1e6
    except OSError:
        pass
    return 0.0


def rss_over_limit(limit_gb: int) -> float:
    """The resident GB of this process that exceeds ``limit_gb`` (the
    largest of the group's ranks under a process group, so that every rank
    stops together), or 0.0 when none does or ``limit_gb`` is 0."""
    if not limit_gb:
        return 0.0
    rss = host_rss_gb()
    if dist.is_initialized():
        box = torch.tensor([rss], dtype=torch.float64)
        if dist.get_backend() == "nccl":
            box = box.cuda()
        dist.all_reduce(box, op=dist.ReduceOp.MAX)
        rss = float(box.item())
    return rss if rss > limit_gb else 0.0


def _append_json(path: str, record: dict) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


def main(argv=None) -> dict:
    """Runs the CLI. Returns, in train mode, {"start_epoch", "epochs": the
    records written to train_log.txt, "train_seconds", "checkpoint_seconds"
    and "eval_seconds" of each epoch (0 where it did not evaluate),
    "train_examples" an epoch}; in eval mode {"start_epoch", "val_stats",
    "scores"}."""
    args = parse_args(argv)
    refuse_two_sources(args)
    owns_group = not dist.is_initialized()
    distributed = maybe_initialize_distributed(args.device)
    dev = resolve_device(args.device)
    cfg = apply_overrides(load_config(), args.config_overrides)
    if args.synthetic:
        # after the overrides: the features are written at their feature_dim
        with main_process_first():
            cfg = make_synthetic_world(cfg, write=is_main_process())
    recompute_losses(cfg)  # the losses follow the mask and family flags
    if args.epochs is not None:
        cfg.epochs = args.epochs
    if args.batch_size is not None:
        cfg.batch_size = args.batch_size
    if args.output_dir is not None:
        cfg.output_dir = args.output_dir
        cfg.submission_dir = os.path.join(cfg.output_dir, "submission")
    if args.resume is not None:
        cfg.resume = args.resume
    if is_main_process():
        os.makedirs(cfg.output_dir, exist_ok=True)
    np.random.seed(cfg.seed)
    mesh = make_mesh(cfg.mesh.num_data, cfg.mesh.num_model,
                     (cfg.mesh.data_axis, cfg.mesh.model_axis))
    data_rank, data_world = axis_rank_size(mesh, DATA)

    anet = cfg.dataset.activity_net
    collate_fn = None
    with main_process_first():  # the vocab is written once
        if cfg.use_raw_videos:
            train_ds, vocab = build_raw_dataset("train", cfg)
            val_ds, _ = build_raw_dataset("val", cfg, vocab)
            collate_fn = functools.partial(collate_raw, pad_idx=vocab.pad_idx,
                                           max_gt=anet.max_gt_target_segments,
                                           max_caption_len=anet.max_caption_len_all)
        else:
            train_ds, vocab = build_dataset("train", cfg)
            val_ds, _ = build_dataset("val", cfg, vocab)
    if anet.val_subset:
        val_ds.keys = sorted(val_ds.keys)[: anet.val_subset]
    if anet.train_subset:
        # the vocab is still the full train split's
        train_ds.keys = sorted(train_ds.keys)[: anet.train_subset]

    def make_loader(ds, shuffle):
        return DataLoader(ds, cfg.batch_size, vocab.pad_idx,
                          video_rescale_len=anet.video_rescale_len,
                          max_gt=anet.max_gt_target_segments,
                          max_caption_len=anet.max_caption_len_all,
                          shuffle=shuffle, seed=cfg.seed,
                          audio_rescale_len=audio_rescale_len(cfg), collate_fn=collate_fn,
                          rank=data_rank, world=data_world)

    train_loader, val_loader = make_loader(train_ds, True), make_loader(val_ds, False)
    print(f"train videos: {len(train_ds)}  val videos: {len(val_ds)}  vocab: {len(vocab)}")

    model, criterion, weight_dict = build_model_and_criterion(cfg, vocab, device=dev,
                                                              seed=cfg.seed)
    if args.weights:
        load_flax_params(model, load_npz(args.weights))
    elif args.from_reference_checkpoint:
        import_reference(args, model, cfg)
    replicate_params(model, mesh)
    print(f"params: {sum(p.numel() for p in model.parameters()) / 1e6:.2f} M")
    state = create_train_state(cfg, model, steps_per_epoch=max(len(train_loader), 1))
    start_epoch = cfg.start_epoch
    if cfg.resume:
        start_epoch = load_checkpoint(cfg.resume, state) + 1
        print(f"resumed from {cfg.resume} at epoch {start_epoch}")
    place_on_mesh(state, mesh, cfg)

    gt_path = os.path.join(anet.anet_path, SPLIT_FILES["val"])

    def score_fn(sub):
        return run_eval(cfg.eval, sub, gt_path, rng=random.Random(cfg.seed))

    eval_step = make_eval_step(
        model, criterion, weight_dict, cfg.eval.val_mode, faster_eval=cfg.eval.faster_eval,
        beam_size=cfg.eval.beam_size, length_penalty=cfg.eval.length_penalty, mesh=mesh)
    if args.mode == "eval":
        stats, _, scores = evaluate(eval_step, val_loader, vocab, cfg, epoch=start_epoch,
                                    score_fn=score_fn, device=dev, mesh=mesh)
        print("val stats:", {k: round(float(v), 4) for k, v in stats.items()})
        if owns_group and distributed:
            dist.destroy_process_group()
        return {"start_epoch": start_epoch, "val_stats": stats, "scores": scores}

    train_step = make_train_step(criterion, weight_dict, seed=cfg.seed, mesh=mesh)
    multi_step = None
    if cfg.steps_per_dispatch > 1:
        multi_step = make_train_multistep(criterion, weight_dict, seed=cfg.seed, mesh=mesh)
    transfer_dtype = TRANSFER_DTYPES[cfg.transfer_dtype]
    if cfg.wandb.on and is_main_process():
        print("wandb requested but not installed; continuing without it")
    run = {"start_epoch": start_epoch, "epochs": [], "train_seconds": [],
           "checkpoint_seconds": [], "eval_seconds": [], "train_examples": len(train_ds)}
    print("Start training")
    t_start = time.time()
    for epoch in range(start_epoch, cfg.epochs):
        t0 = time.perf_counter()
        train_loader.set_epoch(epoch)
        state, train_stats = train_one_epoch(train_step, state, train_loader, epoch,
                                             cfg.print_freq, transfer_dtype=transfer_dtype,
                                             multi_step=multi_step,
                                             chunk_k=cfg.steps_per_dispatch, mesh=mesh)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        run["train_seconds"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        save_checkpoint(cfg.output_dir, state, epoch)
        # rate 0: no numbered checkpoints (the rolling one is still written)
        if ((cfg.checkpoint_rate and (epoch + 1) % cfg.checkpoint_rate == 0)
                or (cfg.lr_drop and (epoch + 1) % cfg.lr_drop == 0)):
            save_checkpoint(cfg.output_dir, state, epoch, name=f"checkpoint{epoch:04d}")
        run["checkpoint_seconds"].append(time.perf_counter() - t0)

        log_stats = {f"train_{k}": v for k, v in train_stats.items()}
        log_stats["epoch"] = epoch
        t0 = time.perf_counter()
        if (cfg.eval_rate and (epoch + 1) % cfg.eval_rate == 0) or epoch == cfg.epochs - 1:
            val_stats, _, scores = evaluate(eval_step, val_loader, vocab, cfg, epoch=epoch,
                                            score_fn=score_fn, device=dev, mesh=mesh)
            log_stats.update({f"val_{k}": v for k, v in val_stats.items()})
            if scores:
                log_stats.update({f"score_{k}": v for k, v in scores.items()})
            run["eval_seconds"].append(time.perf_counter() - t0)
        else:
            run["eval_seconds"].append(0.0)

        val_items = {k: v for k, v in log_stats.items()
                     if k.startswith(("val_", "score_")) or k == "epoch"}
        if is_main_process():
            _append_json(os.path.join(cfg.output_dir, "train_log.txt"), log_stats)
            if len(val_items) > 1:
                _append_json(os.path.join(cfg.output_dir, "val_log.txt"), val_items)
        run["epochs"].append(log_stats)
        rss = rss_over_limit(cfg.rss_restart_gb)
        if rss:
            if is_main_process():
                print(f"host RSS {rss:.1f} GB > rss_restart_gb={cfg.rss_restart_gb}; exiting "
                      f"at epoch {epoch} for clean resume (checkpoint saved)", flush=True)
            if owns_group and distributed:
                dist.destroy_process_group()
            sys.exit(RSS_RESTART_STATUS)
    print(f"Training done in {time.time() - t_start:.1f}s")
    if owns_group and distributed:
        dist.destroy_process_group()
    return run


if __name__ == "__main__":
    main()
