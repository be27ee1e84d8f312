"""The port's entry points: the training CLI (``main.py``), ``inference.py
--resume`` and the serving CLI (``serve.py``), run in-process on the CPU at
``_small_cfg`` dims over one synthetic world (the port's
``make_synthetic_world``: 64 train and 32 val videos of 1-4 events, 16 and 4
of them kept by ``train_subset`` / ``val_subset``), batch 8, every dropout
rate 0.

The training CLI is held against the loop the JAX package's root ``main.py``
runs, built from the same JAX functions it calls (``build_dataset``,
``DataLoader``, ``build_model_and_criterion``, ``make_optimizer``,
``make_train_step``, ``train_one_epoch``), since that ``main.py`` cannot
start from given weights: both start from JAX's initialisation of the
model, which the port reads as a flat snapshot through ``--weights``. Each
epoch's averaged train losses agree within 1e-3 relative (measured: at most
9.8e-5, ``loss_counter`` of epoch 1). ``tests/test_torch_train.py`` holds a
step's losses to 1e-5 from perturbed weights; from JAX's initialisation the
encoder's sampling offsets put every tap on a whole-token coordinate, where
the location gradient jumps, so their gradients differ by up to 3.1% between
the sides (``test_grad_flow_dump_matches_jax``), and Adam's update, about lr
times the gradient's sign, turns that into weights up to 2 lr apart, which
the next steps' losses carry.

Then, on the port alone: 2 epochs straight equal 1 epoch and a resume for 1,
exactly; the checkpoint and eval rates; ``inference --resume`` of the CLI's
checkpoint equal to the CLI's own last evaluation; both servers' JSON rows
and the load test's sweep of them; and the refusals (``--faster-eval`` under ``--continuous``, no GPU without
``--device cpu``)."""

from __future__ import annotations

import json
import math
import os
import re

import jax
import numpy as np
import pytest
import torch

from test_cli_drivers import TINY
from test_torch_common import flatten_params

from multimodal_feature_learning_tpu_torch import inference, serve
from multimodal_feature_learning_tpu_torch import main as port_main
from multimodal_feature_learning_tpu_torch.config import Config, apply_overrides
from multimodal_feature_learning_tpu_torch.data.anet import build_dataset

DIMS = [o for o in TINY if not o.startswith(("eval_rate", "checkpoint_rate", "print_freq"))]
NO_DROPOUT = ["dvc.detr.transformer_dropout_prob=0"] + [
    f"dvc.caption.{name}=0" for name in (
        "positional_embedding_dropout", "attention_dropout", "projection_dropout",
        "mlp_dropout_1", "mlp_dropout_2")]
SUBSETS = ["dataset.activity_net.train_subset=16", "dataset.activity_net.val_subset=4"]
BATCH, EPOCHS = 8, 2
LOSS_RTOL = 1e-3
GRAD_NORM_TOL, OFFSET_GRAD_RTOL = 1e-6, 5e-2
LOSS_KEYS = ("loss", "loss_counter", "loss_bbox", "loss_giou", "loss_caption",
             "loss_context", "loss_mask_prediction")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(tmp dir, the overrides that point the port at the written world)."""
    root = tmp_path_factory.mktemp("cli")
    cfg = port_main.make_synthetic_world(apply_overrides(Config(), DIMS), str(root / "anet"))
    anet = cfg.dataset.activity_net
    return root, [f"dataset.activity_net.anet_path={anet.anet_path}",
                  f"dataset.activity_net.video_features_file={anet.video_features_file}",
                  f"dataset.activity_net.vocab_file_path={anet.vocab_file_path}"]


def overrides(world, *extra):
    return ["--config-overrides", *DIMS, *NO_DROPOUT, *SUBSETS, *world[1], "print_freq=0",
            *extra]


def read_log(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def jax_run(world):
    """The JAX main.py loop for EPOCHS epochs. Returns (flat snapshot of
    the initial params, per-epoch train stats, the pieces for one more
    step)."""
    from main import apply_overrides as jax_apply_overrides

    from multimodal_feature_learning_tpu.config import load_config, recompute_losses
    from multimodal_feature_learning_tpu.data.anet import build_dataset
    from multimodal_feature_learning_tpu.data.loader import DataLoader, split_batch
    from multimodal_feature_learning_tpu.engine.state import (
        create_train_state, make_lr_schedule, make_optimizer,
    )
    from multimodal_feature_learning_tpu.engine.train import make_train_step, train_one_epoch
    from multimodal_feature_learning_tpu.models import build_model_and_criterion
    from multimodal_feature_learning_tpu.parallel.mesh import make_mesh

    root, paths = world
    jcfg = jax_apply_overrides(load_config("train"), DIMS + NO_DROPOUT + SUBSETS + paths + [
        "dvc.caption.bridge_dropout=0", "dataset.activity_net.video_features_file=",
        f"dataset.activity_net.vocab_file_path={root / 'vocab_jax.pkl'}"])
    recompute_losses(jcfg)
    jcfg.batch_size = BATCH
    anet = jcfg.dataset.activity_net
    train_ds, vocab = build_dataset("train", jcfg)
    train_ds.keys = sorted(train_ds.keys)[: anet.train_subset]
    loader = DataLoader(train_ds, BATCH, vocab.pad_idx, video_rescale_len=anet.video_rescale_len,
                        max_gt=anet.max_gt_target_segments,
                        max_caption_len=anet.max_caption_len_all, shuffle=True, seed=jcfg.seed)
    model, criterion, weight_dict = build_model_and_criterion(jcfg, vocab)
    params = model.init(jax.random.PRNGKey(jcfg.seed), split_batch(next(iter(loader)))[0])
    flat = flatten_params(params)
    host_params = jax.tree_util.tree_map(np.array, params)  # the step donates params
    tx = make_optimizer(jcfg, steps_per_epoch=len(loader))
    schedule = make_lr_schedule(jcfg.lr, jcfg.lr_drop, len(loader))
    train_step = make_train_step(model, criterion, weight_dict, tx, schedule)
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    rng = jax.random.PRNGKey(jcfg.seed)
    state = create_train_state(params, tx)
    epochs = []
    for epoch in range(EPOCHS):
        loader.set_epoch(epoch)
        state, stats = train_one_epoch(model, criterion, weight_dict, train_step, state,
                                       loader, mesh, rng, epoch, print_freq=100)
        epochs.append(stats)
    step_args = (model, criterion, weight_dict, train_step, tx, loader, mesh, rng, host_params)
    return flat, epochs, step_args


@pytest.fixture(scope="module")
def snapshot(world, jax_run):
    path = str(world[0] / "jax_init.npz")
    np.savez(path, **jax_run[0])
    return path


@pytest.fixture(scope="module")
def straight(world, snapshot):
    """The port's CLI for EPOCHS epochs from the JAX initialisation."""
    out = str(world[0] / "straight")
    run = port_main.main(["--device", "cpu", "--weights", snapshot, "--epochs", str(EPOCHS),
                          "--batch-size", str(BATCH), "--output-dir", out,
                          *overrides(world)])
    return out, run


def test_train_losses_match_the_jax_loop(jax_run, straight):
    out, run = straight
    log = read_log(os.path.join(out, "train_log.txt"))
    assert [r["epoch"] for r in log] == list(range(EPOCHS)) and run["start_epoch"] == 0
    assert run["epochs"] == log
    for rec, ref in zip(log, jax_run[1]):
        assert set(LOSS_KEYS) <= set(ref)
        for k in LOSS_KEYS:
            got, want = rec[f"train_{k}"], float(ref[k])
            assert math.isfinite(got) and abs(got - want) <= LOSS_RTOL * abs(want), (k, got, want)
        assert rec["train_lr"] == pytest.approx(float(ref["lr"]))
    assert log[1]["train_loss"] != log[0]["train_loss"]
    # the last epoch is evaluated and scored (eval_rate 10); no numbered
    # checkpoint (checkpoint_rate 10, lr_drop 40)
    assert "val_loss" in log[-1] and "score_F1_score" in log[-1] and "val_loss" not in log[0]
    assert sorted(os.listdir(out)) == ["checkpoint", "submission", "train_log.txt",
                                       "val_log.txt"]


def test_resume_equals_the_straight_run(world, snapshot, straight):
    out = str(world[0] / "resumed")
    args = ["--device", "cpu", "--weights", snapshot, "--batch-size", str(BATCH),
            "--output-dir", out, *overrides(world)]
    port_main.main([*args, "--epochs", "1"])
    run = port_main.main([*args, "--epochs", str(EPOCHS),
                          "--resume", os.path.join(out, "checkpoint")])
    assert run["start_epoch"] == 1 and [r["epoch"] for r in run["epochs"]] == [1]
    resumed = read_log(os.path.join(out, "train_log.txt"))
    ref = read_log(os.path.join(straight[0], "train_log.txt"))
    assert [r["epoch"] for r in resumed] == [0, 1]
    for got, want in zip(resumed, ref):
        for k in want:
            if k.startswith("train_") or got["epoch"] == 1:
                assert got[k] == want[k], (got["epoch"], k)


def test_steps_per_dispatch_equals_single_steps(world, snapshot, straight, capsys):
    """``steps_per_dispatch=2`` (JAX's multi-step dispatch; 2 steps an
    epoch here, one dispatch each) from the same weights: the same train
    log and checkpoint params as the straight run's single steps, exactly,
    and one progress line a step."""
    out = str(world[0] / "multistep")
    capsys.readouterr()
    run = port_main.main(["--device", "cpu", "--weights", snapshot, "--epochs", str(EPOCHS),
                          "--batch-size", str(BATCH), "--output-dir", out,
                          *overrides(world, "steps_per_dispatch=2", "print_freq=1")])
    steps = run["train_examples"] // BATCH
    lines = re.findall(r"^Epoch: \[(\d+)\] \[ ?(\d+)/(\d+)\]", capsys.readouterr().out,
                       re.MULTILINE)
    assert steps == 2 and [(int(e), int(i)) for e, i, _ in lines] == \
        [(e, i) for e in range(EPOCHS) for i in range(steps)]
    got, want = read_log(os.path.join(out, "train_log.txt")), \
        read_log(os.path.join(straight[0], "train_log.txt"))
    assert [r["epoch"] for r in got] == list(range(EPOCHS))
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k.startswith("train_")} == \
            {k: v for k, v in w.items() if k.startswith("train_")}
    a = torch.load(os.path.join(out, "checkpoint"), weights_only=True)
    b = torch.load(os.path.join(straight[0], "checkpoint"), weights_only=True)
    assert a["step"] == b["step"] == EPOCHS * steps
    assert a["model"].keys() == b["model"].keys()
    for k, v in b["model"].items():
        assert torch.equal(a["model"][k], v), k


@pytest.mark.parametrize("rates, numbered, val_epochs", [
    (["checkpoint_rate=0", "eval_rate=0", "lr_drop=0"], [], [1]),
    (["checkpoint_rate=1", "eval_rate=1"], ["checkpoint0000", "checkpoint0001"], [0, 1]),
], ids=["rate0", "rate1"])
def test_checkpoint_and_eval_rates(world, rates, numbered, val_epochs):
    """Rate 0 keeps only the rolling checkpoint and evaluates the last epoch
    only (JAX ``tests/test_cli_drivers.py``); rate 1 keeps and evaluates
    every epoch."""
    out = world[0] / f"rates_{len(numbered)}"
    port_main.main(["--device", "cpu", "--epochs", str(EPOCHS), "--batch-size", str(BATCH),
                    "--output-dir", str(out), *overrides(world, *rates)])
    assert (out / "checkpoint").is_file()
    assert sorted(p.name for p in out.iterdir() if p.name.startswith("checkpoint0")) == numbered
    assert [r["epoch"] for r in read_log(out / "val_log.txt")] == val_epochs
    assert all(set(r) == {"epoch"} | {k for k in r if k.startswith(("val_", "score_"))}
               for r in read_log(out / "val_log.txt"))


def test_eval_mode_and_inference_resume_score_the_checkpoint(world, straight):
    """``main --mode eval`` and ``inference --resume`` of the CLI's last
    checkpoint give the CLI's own last evaluation, loss for loss."""
    out, run = straight
    ckpt = os.path.join(out, "checkpoint")
    last = run["epochs"][-1]
    sub = str(world[0] / "inference_sub")
    stats, submission, scores = inference.main(
        ["--device", "cpu", "--resume", ckpt, "--val-mode", "one_by_one",
         "--batch-size", str(BATCH), *overrides(world, f"submission_dir={sub}")])
    assert os.listdir(sub) == [f"submission_epoch_{EPOCHS - 1:04d}.json"]
    assert len(submission["results"]) == 4
    assert {f"val_{k}": v for k, v in stats.items()} == {
        k: v for k, v in last.items() if k.startswith("val_")}
    assert scores["F1_score"] == last["score_F1_score"]
    evaluated = port_main.main(["--device", "cpu", "--mode", "eval", "--resume", ckpt,
                                "--batch-size", str(BATCH), "--output-dir",
                                str(world[0] / "eval_mode"), *overrides(world)])
    assert evaluated["start_epoch"] == EPOCHS and evaluated["val_stats"] == stats


def test_grad_flow_dump_matches_jax(world, jax_run, tmp_path):
    """One step from the JAX initialisation on each side, each dumping its
    gradient norms: the same file name and keys (flax paths), and norms
    within 1e-6 of the largest, except the encoder's sampling offsets
    (measured: 1.9e-3 of the largest, 3.1% of their own). JAX initialises
    those offsets on a grid of whole tokens around each token's centre, so
    every tap of the first steps sits on a whole-token coordinate, where the
    gradient of the location jumps between the two taps' values: f32
    rounding on either side picks the side. They are held to 5% of their
    own norm; the gradients everywhere else agree to 8e-8 of the largest."""
    from multimodal_feature_learning_tpu.engine.state import create_train_state
    from multimodal_feature_learning_tpu.engine.train import train_one_epoch as jax_epoch
    from multimodal_feature_learning_tpu_torch.data.anet import build_dataset
    from multimodal_feature_learning_tpu_torch.data.loader import DataLoader
    from multimodal_feature_learning_tpu_torch.engine.state import create_train_state as state_of
    from multimodal_feature_learning_tpu_torch.engine.train import (
        make_train_step, train_one_epoch,
    )
    from multimodal_feature_learning_tpu_torch.models.criterion import build_criterion
    from multimodal_feature_learning_tpu_torch.models.dvc import build_model
    from multimodal_feature_learning_tpu_torch.utils.weights import load_flax_params

    model, criterion, weight_dict, train_step, tx, loader, mesh, rng, params = jax_run[2]
    loader.set_epoch(0)
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_epoch(model, criterion, weight_dict, train_step,
              create_train_state(jax.tree_util.tree_map(np.array, params), tx),
              [next(iter(loader))], mesh, rng, 0, print_freq=100,
              grad_flow_dir=str(jax_dir), grad_flow_freq=1)

    cfg = apply_overrides(Config(), DIMS + NO_DROPOUT + SUBSETS + world[1])
    cfg.batch_size = BATCH
    ds, vocab = build_dataset("train", cfg)
    ds.keys = sorted(ds.keys)[:16]
    tmodel = build_model(cfg, len(vocab), vocab.pad_idx, vocab.bos_idx, vocab.eos_idx,
                         device="cpu")
    load_flax_params(tmodel, flatten_params(params))
    crit, wd = build_criterion(cfg, vocab.pad_idx)
    tloader = DataLoader(ds, BATCH, vocab.pad_idx, cfg.dataset.activity_net.video_rescale_len,
                         cfg.dataset.activity_net.max_gt_target_segments,
                         cfg.dataset.activity_net.max_caption_len_all, seed=cfg.seed)
    train_one_epoch(make_train_step(crit, wd), state_of(cfg, tmodel, 2), [next(iter(tloader))],
                    0, print_freq=0, grad_flow_dir=str(port_dir), grad_flow_freq=1)

    assert os.listdir(jax_dir) == os.listdir(port_dir) == ["grads_e000_s00000.json"]
    with open(jax_dir / "grads_e000_s00000.json") as f, \
            open(port_dir / "grads_e000_s00000.json") as g:
        ref, got = json.load(f), json.load(g)
    assert got.keys() == ref.keys() and len(got) > 100
    scale = max(ref.values())
    for k, v in ref.items():
        if "enc_layers" in k and "sampling_offsets" in k:
            assert abs(got[k] - v) <= OFFSET_GRAD_RTOL * v, (k, got[k], v)
        else:
            assert abs(got[k] - v) <= GRAD_NORM_TOL * scale, (k, got[k], v)


def test_serving_cli_rows(world, straight, capsys):
    ckpt = os.path.join(straight[0], "checkpoint")
    keys = {"metric", "mode", "requests", "offered_rps", "achieved_rps", "latency_p50_ms",
            "latency_p95_ms", "latency_p99_ms", "batch_size", "max_wait_ms", "backend", "shed",
            "dispatches", "mean_batch_fill", "mean_step_ms"}
    for mode in ([], ["--continuous", "--chunk", "2"]):
        row = serve.main(["--device", "cpu", "--resume", ckpt, "--n-requests", "6",
                          "--rps", "500", "--batch-size", "2", *mode, *overrides(world)])
        printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert printed == row
        assert set(row) == keys | ({"chunks", "chunk_size", "mean_prefill_ms", "mean_chunk_ms"}
                                   if mode else set())
        assert row["mode"] == ("continuous" if mode else "static")
        assert row["requests"] == 6 and row["shed"] == 0 and row["backend"] == "cpu"
        assert row["dispatches"] >= 3 and row["latency_p50_ms"] > 0
        if mode:
            assert row["chunks"] >= 1 and row["chunk_size"] == 2


def test_load_test_sweeps_the_serving_cli(world, straight):
    """The load test's points, each through the serving CLI (here in-process
    in place of a subprocess): static and continuous at each rate."""
    from multimodal_feature_learning_tpu_torch.tools import load_test_serve

    default = load_test_serve.commands()
    assert [p for p, _ in default] == [f"{m}@{r}rps" for r in (50, 200) for m in (
        "static", "continuous_c2", "continuous_c4", "continuous_c8")]
    argv = default[0][1]
    assert argv[argv.index("--weights") + 1] == load_test_serve.SNAPSHOT
    assert argv[-1] == "use_differentiable_mask=false"
    rows = load_test_serve.run(
        launch=lambda argv, timeout_s: serve.main(argv), n_requests=4, rps=["500"],
        chunks=["2"], batch_size=2, resume=os.path.join(straight[0], "checkpoint"),
        overrides=[*DIMS, *NO_DROPOUT, *SUBSETS, *world[1]], device="cpu")
    assert [(r["point"], r["mode"], r["requests"]) for r in rows] == [
        ("static@500rps", "static", 4), ("continuous_c2@500rps", "continuous", 4)]
    assert load_test_serve.markdown(rows).count("@500rps") == 2


RAW = ["use_raw_videos=true", "dataset.activity_net.num_mel_bins=16"]
FAMILIES = {
    "dense": ["dvc.use_sparse_detr=False", "dvc.use_deformable_detr=True"],
    "multimodal": ["dvc.input_modalities=video,audio", "dvc.use_bimodal_encoder=True",
                   "dataset.activity_net.audio_rescale_len=12"],
    # frames from the synthetic decoder; AST: 7 x 2 patches + 2 = 16 tokens
    "raw": [*RAW, "dvc.input_modalities=video,audio", "dvc.vivit.depth=1",
            "dvc.vivit.temporal_depth=1", "dvc.vivit.num_heads=2", "dvc.ast.depth=1",
            "dvc.ast.num_heads=2", "dataset.activity_net.audio_rescale_len=16"],
    "regular": ["dvc.use_sparse_detr=False", "dvc.decoder.depth=2"],
    "regular_raw": [*RAW, "dvc.use_sparse_detr=False", "dvc.decoder.depth=2"],
    # the sparse family on a GloVe file narrower than d_model (written per test)
    "glove": ["dvc.caption.pretrained_word_embed_dim=12"],
}


def glove_overrides(world, tmp_path) -> list:
    """A GloVe file of 12 values a word for every other word of the world's
    vocabulary, and the overrides that point the caption embedding at it."""
    _, vocab = build_dataset("train", apply_overrides(Config(), DIMS + world[1]))
    rng = np.random.default_rng(0)
    path = tmp_path / "glove.txt"
    with open(path, "w") as f:
        for w in vocab.get_itos()[::2]:
            f.write(" ".join([w] + [f"{v:.4f}" for v in rng.normal(size=12)]) + "\n")
    return [f"dvc.caption.glove_file_path={path}",
            f"dvc.caption.embedding_matrix_file_path={tmp_path / 'matrix.pkl'}"]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_other_families_train_resume_and_evaluate(world, family, tmp_path):
    """The dense, the multimodal, the raw multimodal and the regular family
    (on features and on raw frames), and the sparse one on GloVe embeddings,
    through the training CLI: an epoch from a flat snapshot (``--weights``,
    loaded strictly) with eval and scoring and a numbered checkpoint,
    ``--resume`` for a second, then ``--mode eval --resume``, which gives
    the second epoch's evaluation."""
    from multimodal_feature_learning_tpu_torch.models import build_model_and_criterion
    from multimodal_feature_learning_tpu_torch.utils.weights import export_flax_params

    extra = [*FAMILIES[family], "checkpoint_rate=1"]
    if family == "glove":
        extra += glove_overrides(world, tmp_path)
    cfg = apply_overrides(Config(), DIMS + extra + world[1])
    _, vocab = build_dataset("train", cfg)
    model, _, _ = build_model_and_criterion(cfg, vocab, device="cpu", seed=5)
    # the GloVe embedder (a projection to d_model) is what --weights must carry
    assert hasattr(model.caption.target_embedding, "Dense_0") == (family == "glove")
    snapshot = str(tmp_path / "init.npz")
    np.savez(snapshot, **export_flax_params(model))
    out = str(tmp_path / "run")
    common = ["--device", "cpu", "--batch-size", str(BATCH), "--output-dir", out]
    first = port_main.main(["--weights", snapshot, "--epochs", "1", *common,
                            *overrides(world, *extra)])
    rec = first["epochs"][0]
    assert rec["epoch"] == 0 and np.isfinite(rec["train_loss"]) and "score_F1_score" in rec
    assert ("train_loss_mask_prediction" in rec) == (family in ("multimodal", "raw", "glove"))
    assert os.path.exists(os.path.join(out, "checkpoint0000"))
    ckpt = os.path.join(out, "checkpoint")
    second = port_main.main(["--resume", ckpt, "--epochs", "2", *common,
                             *overrides(world, *extra)])
    assert second["start_epoch"] == 1 and [r["epoch"] for r in second["epochs"]] == [1]
    evaluated = port_main.main(["--mode", "eval", "--resume", ckpt, *common,
                                *overrides(world, *extra)])
    assert evaluated["start_epoch"] == 2
    assert {f"val_{k}": v for k, v in evaluated["val_stats"].items()} == {
        k: v for k, v in second["epochs"][-1].items() if k.startswith("val_")}


def test_two_modalities_override_parses_as_jax():
    from main import apply_overrides as jax_apply_overrides

    from multimodal_feature_learning_tpu.config import load_config

    override = ["dvc.input_modalities=video,audio"]
    jcfg = jax_apply_overrides(load_config("train"), override)
    assert apply_overrides(Config(), override).dvc.input_modalities == \
        list(jcfg.dvc.input_modalities) == ["video", "audio"]


def test_cli_config_fields_match_jax():
    """The fields the CLIs read have JAX's defaults, and an override of each
    takes JAX's type coercion."""
    from main import apply_overrides as jax_apply_overrides

    from multimodal_feature_learning_tpu.config import load_config

    fields = ("checkpoint_rate", "eval_rate", "start_epoch", "resume", "transfer_dtype",
              "steps_per_dispatch", "dataset.activity_net.train_subset")
    values = ("3", "0", "5", "runs/x/checkpoint", "bfloat16", "4", "16")

    def get(cfg, name):
        for part in name.split("."):
            cfg = getattr(cfg, part)
        return cfg

    jcfg, tcfg = load_config("train"), Config()
    assert [get(tcfg, f) for f in fields] == [get(jcfg, f) for f in fields]
    overrides = [f"{f}={v}" for f, v in zip(fields, values)]
    jcfg, tcfg = jax_apply_overrides(jcfg, overrides), apply_overrides(tcfg, overrides)
    got, want = [get(tcfg, f) for f in fields], [get(jcfg, f) for f in fields]
    assert got == want and [type(v) for v in got] == [type(v) for v in want]


def test_refusals(world, monkeypatch):
    with pytest.raises(SystemExit, match="faster-eval"):
        serve.main(["--device", "cpu", "--continuous", "--faster-eval", *overrides(world)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in (port_main.main, serve.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(["--epochs", "1"] if entry is port_main.main else [])


def test_rss_restart_exits_75_after_the_checkpoint_as_jax(world, tmp_path, monkeypatch, capsys):
    """``rss_restart_gb`` below the process's resident memory (the reading
    replaced by 1000 GB on both sides): the training CLI saves epoch 0's
    checkpoint, logs the epoch and exits with status 75 before epoch 1, as
    JAX's root ``main.py`` does (run in-process on one CPU device, its
    synthetic world); ``wandb.on`` prints JAX's line where wandb is not
    installed and goes on."""
    import main as jax_main

    monkeypatch.setattr(port_main, "host_rss_gb", lambda: 1000.0)
    out = tmp_path / "port"
    with pytest.raises(SystemExit) as exited:
        port_main.main(["--device", "cpu", "--epochs", "2", "--batch-size", str(BATCH),
                        "--output-dir", str(out),
                        *overrides(world, "rss_restart_gb=1", "wandb.on=true")])
    assert exited.value.code == port_main.RSS_RESTART_STATUS == 75
    printed = capsys.readouterr().out
    assert "wandb requested but not installed; continuing without it" in printed
    assert ("host RSS 1000.0 GB > rss_restart_gb=1; exiting at epoch 0 for clean resume "
            "(checkpoint saved)") in printed
    assert (out / "checkpoint").exists()
    assert [r["epoch"] for r in read_log(out / "train_log.txt")] == [0]

    monkeypatch.setattr(jax_main, "_host_rss_gb", lambda: 1000.0)
    monkeypatch.chdir(tmp_path)
    jax_out = tmp_path / "jax"
    monkeypatch.setattr("sys.argv", [
        "main.py", "--synthetic", "--epochs", "2", "--batch-size", str(BATCH),
        "--output-dir", str(jax_out), "--config-overrides", *DIMS, *SUBSETS,
        "mesh.num_data=1", "print_freq=100", "rss_restart_gb=1"])
    cache_dir = jax.config.jax_compilation_cache_dir
    try:
        with pytest.raises(SystemExit) as exited:
            jax_main.main()
    finally:  # the JAX CLI points the process at its own compile cache
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    assert exited.value.code == 75
    assert "exiting at epoch 0 for clean resume (checkpoint saved)" in capsys.readouterr().out
    assert (jax_out / "checkpoint").exists()
    assert [r["epoch"] for r in read_log(jax_out / "train_log.txt")] == [0]
