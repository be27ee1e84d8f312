"""The port's evaluation loop, from files to scores, against the JAX
package's.

One synthetic world, written by the port's ``make_synthetic_world`` (the
JAX package's annotations, and its synthetic features as ``.npy`` files),
the first 10 val videos (``for_testing``), batch 4, so the last batch holds
2 videos and 2 dummy rows. The JAX side reads its synthetic features and
runs ``engine/evaluate.py::evaluate`` on a 1x1 CPU mesh; the port reads the
files and runs its ``evaluate`` on the CPU, with the same flax params at
``__graft_entry__._small_cfg`` dims (perturbed from a numpy seed), in
``one_by_one`` and ``teacher_forcing``. Held: the submission's keys and row
counts equal; sentences equal, string for string (greedy tokens match
exactly at these dims); timestamps within 1e-4 x the video's duration (the
JAX package's jitted step and its own eager forward differ by up to 4.9e-5
x duration on this world, f32 sums fused in another order; the port is
within 1.1e-5 of the eager one);
the averaged loss terms within 1e-4 relative; each side's scores, from its
own evaluator, within 1e-6; the ``corr`` diagnostic within 1e-4 relative.
And the port's entry point end to end on the CPU."""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from test_torch_common import flatten_params, jax_small_cfg, perturb, torch_cfg_like

from multimodal_feature_learning_tpu.data import anet as janet
from multimodal_feature_learning_tpu.data import loader as jloader
from multimodal_feature_learning_tpu.engine import evaluate as jevaluate
from multimodal_feature_learning_tpu.evaluation import run_eval as jax_run_eval
from multimodal_feature_learning_tpu.models import criterion as jcrit
from multimodal_feature_learning_tpu.models.dvc import build_model as jax_build_model
from multimodal_feature_learning_tpu.parallel.mesh import make_mesh
from multimodal_feature_learning_tpu_torch import inference
from multimodal_feature_learning_tpu_torch.data import anet as tanet
from multimodal_feature_learning_tpu_torch.data import loader as tloader
from multimodal_feature_learning_tpu_torch.data.vocab import Vocab
from multimodal_feature_learning_tpu_torch.engine import evaluate as tevaluate
from multimodal_feature_learning_tpu_torch.engine.train import batch_to_device
from multimodal_feature_learning_tpu_torch.evaluation import run_eval as port_run_eval
from multimodal_feature_learning_tpu_torch.models import criterion as tcrit
from multimodal_feature_learning_tpu_torch.models.dvc import build_model as port_build_model
from multimodal_feature_learning_tpu_torch.utils.weights import load_flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_VIDEOS, BATCH, SCORE_SEED = 10, 4, 0
MODES = ["one_by_one", "teacher_forcing"]
TS_TOL = 1e-4  # x duration


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(JAX config, port config, tmp dir) reading one written world."""
    root = tmp_path_factory.mktemp("world")
    jcfg = jax_small_cfg()
    tcfg = inference.make_synthetic_world(torch_cfg_like(jcfg), str(root / "anet"))
    for cfg in (jcfg, tcfg):
        anet = cfg.dataset.activity_net
        anet.for_testing, anet.num_samples = True, N_VIDEOS
        cfg.batch_size, cfg.print_freq = BATCH, 10
    tcfg.submission_dir = str(root / "port_sub")
    janet_cfg = jcfg.dataset.activity_net
    janet_cfg.anet_path = tcfg.dataset.activity_net.anet_path
    janet_cfg.video_features_file = ""  # the JAX package's synthetic features
    janet_cfg.vocab_file_path = str(root / "vocab_jax.pkl")
    jcfg.submission_dir = str(root / "jax_sub")
    return jcfg, tcfg, root


def loaders(jcfg, tcfg):
    jds, jvocab = janet.build_dataset("val", jcfg)
    tds, tvocab = tanet.build_dataset("val", tcfg)
    anet = tcfg.dataset.activity_net
    kw = dict(video_rescale_len=anet.video_rescale_len, max_gt=anet.max_gt_target_segments,
              max_caption_len=anet.max_caption_len_all, shuffle=False, seed=0)
    return (jloader.DataLoader(jds, BATCH, jvocab.pad_idx, **kw), jvocab,
            tloader.DataLoader(tds, BATCH, tvocab.pad_idx, **kw), tvocab)


@pytest.fixture(scope="module")
def models(world):
    """(jax model, flax params, port model, jax loader, jax vocab, port
    loader, port vocab)."""
    jcfg, tcfg, _ = world
    jl, jvocab, tl, tvocab = loaders(jcfg, tcfg)
    assert jvocab.itos == tvocab.itos
    V = len(tvocab)
    jmodel = jax_build_model(jcfg, V, tvocab.pad_idx, tvocab.bos_idx, tvocab.eos_idx)
    arrays, _ = jloader.split_batch(next(iter(jl)))
    params = perturb(jmodel.init(jax.random.PRNGKey(0), arrays), seed=0)
    tmodel = port_build_model(tcfg, V, tvocab.pad_idx, tvocab.bos_idx, tvocab.eos_idx,
                              device="cpu")
    load_flax_params(tmodel, flatten_params(params))
    return jmodel, params, tmodel, jl, jvocab, tl, tvocab


@pytest.fixture(scope="module", params=MODES)
def runs(request, world, models):
    """{'jax': (stats, submission, scores), 'port': ...} in one val_mode."""
    mode = request.param
    jcfg, tcfg, root = world
    jmodel, params, tmodel, jl, jvocab, tl, tvocab = models
    gt = os.path.join(tcfg.dataset.activity_net.anet_path, tanet.SPLIT_FILES["val"])

    def jax_score(sub):
        state = random.getstate()
        random.seed(SCORE_SEED)
        try:
            return jax_run_eval(jcfg.eval, sub, gt)
        finally:
            random.setstate(state)

    wd = jcrit.build_weight_dict(jcfg)
    jcriterion = jcrit.SetCriterion(num_classes=jcfg.dvc.num_classes, weight_dict=wd,
                                    losses=list(jcfg.dvc.losses), pad_idx=jvocab.pad_idx,
                                    smoothing=jcfg.dvc.smoothing)
    jstep = jevaluate.make_eval_step(jmodel, jcriterion, wd, mode)
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    ref = jevaluate.evaluate(jmodel, jcriterion, wd, jstep, params, jl, mesh, jvocab, jcfg,
                             score_fn=jax_score)

    tcriterion, twd = tcrit.build_criterion(tcfg, tvocab.pad_idx)
    tstep = tevaluate.make_eval_step(tmodel, tcriterion, twd, mode)
    got = tevaluate.evaluate(
        tstep, tl, tvocab, tcfg, device="cpu",
        score_fn=lambda sub: port_run_eval(tcfg.eval, sub, gt, rng=random.Random(SCORE_SEED)))
    with open(gt) as f:
        durations = {k: v["duration"] for k, v in json.load(f).items()}
    return {"jax": ref, "port": got, "durations": durations, "cfg": tcfg}


def test_world_equals_jax_world(world, tmp_path):
    """The port's world writes the JAX package's annotations, and its
    synthetic features as files."""
    from main import make_synthetic_world as jax_world

    jcfg, tcfg, _ = world
    jax_world(jax_small_cfg(), str(tmp_path / "jax"))
    for split in tanet.SPLIT_FILES["train"], tanet.SPLIT_FILES["val"]:
        with open(tmp_path / "jax" / split) as f, \
                open(os.path.join(tcfg.dataset.activity_net.anet_path, split)) as g:
            ann = json.load(g)
            assert ann == json.load(f)
    fb = janet.FeatureBackend("", feature_dim=jcfg.dvc.detr.feature_dim)
    files = tanet.FeatureBackend(tcfg.dataset.activity_net.video_features_file)
    for key in list(ann)[:3]:
        np.testing.assert_array_equal(files.get(key), fb.get(key))


def test_the_last_batch_is_partial(models):
    *_, tl, _ = models
    batches = list(tl)
    assert [len(b["keys"]) for b in batches] == [4, 4, 2]
    assert batches[-1]["batch_valid"].tolist() == [True, True, False, False]


def test_submission_keys_and_rows_match_jax(runs):
    ref, got = runs["jax"][1]["results"], runs["port"][1]["results"]
    assert list(got) == list(ref) and len(got) == N_VIDEOS
    assert [len(v) for v in got.values()] == [len(v) for v in ref.values()]
    assert all(len(v) > 0 for v in got.values())


def test_sentences_match_jax(runs):
    ref, got = runs["jax"][1]["results"], runs["port"][1]["results"]
    for key in ref:
        assert [e["sentence"] for e in got[key]] == [e["sentence"] for e in ref[key]], key
    assert len({e["sentence"] for v in got.values() for e in v}) > 1


def test_timestamps_match_jax(runs):
    ref, got = runs["jax"][1]["results"], runs["port"][1]["results"]
    for key in ref:
        r = np.array([e["timestamp"] for e in ref[key]])
        g = np.array([e["timestamp"] for e in got[key]])
        np.testing.assert_allclose(g, r, rtol=0, atol=TS_TOL * runs["durations"][key])


def test_stats_match_jax(runs):
    ref, got = runs["jax"][0], runs["port"][0]
    assert set(got) == set(ref) and "loss" in got and "loss_caption" in got
    assert not any(ch.isdigit() for k in got for ch in k)
    for k, r in ref.items():
        assert abs(got[k] - r) <= 1e-4 * abs(r), (k, got[k], r)


def test_scores_match_jax(runs):
    ref, got = runs["jax"][2], runs["port"][2]
    assert set(got) == set(ref) and "F1_score" in got and "CIDEr" in got
    for k, r in ref.items():
        assert abs(got[k] - r) <= 1e-6, (k, got[k], r)


def test_submission_file_is_saved(runs):
    path = os.path.join(runs["cfg"].submission_dir, "submission_epoch_0000.json")
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(runs["port"][1]))


def test_max_batches_stops_the_loop(models, world):
    jcfg, tcfg, _ = world
    *_, tmodel, _, _, tl, tvocab = models
    crit, wd = tcrit.build_criterion(tcfg, tvocab.pad_idx)
    step = tevaluate.make_eval_step(tmodel, crit, wd, "teacher_forcing")
    cfg = torch_cfg_like(jcfg)
    cfg.save_submission = False
    _, sub, scores = tevaluate.evaluate(step, tl, tvocab, cfg, max_batches=1, device="cpu")
    assert len(sub["results"]) == BATCH and scores is None


def test_corr_term_matches_jax(models):
    """``corr`` on the padded last batch (2 dummy rows): both criteria on
    the JAX package's forward_eval outputs, and the port's on its own."""
    jmodel, params, tmodel, jl, _, tl, tvocab = models
    jbatch = jloader.split_batch(list(jl)[-1])[0]
    tbatch = batch_to_device(tloader.split_batch(list(tl)[-1])[0], "cpu")
    assert not jbatch["batch_valid"].all()
    jcorr = jcrit.SetCriterion(num_classes=200, weight_dict={}, losses=["corr"],
                               pad_idx=tvocab.pad_idx)
    static = ("temporal_shapes", "level_start_index", "caption_head")

    @jax.jit
    def forward(p, b):
        out, _, idx, idx_aux, mask = jmodel.forward_eval(p, b, "teacher_forcing")
        return ({k: v for k, v in out.items() if k not in static}, idx, idx_aux, mask,
                jcorr(out, b, idx, idx_aux, mask))

    out, idx, idx_aux, mask, ref = forward(params, jbatch)
    out = {k: torch.from_numpy(np.array(v)) for k, v in out.items()
           if isinstance(v, jax.Array)}
    out["temporal_shapes"] = tuple(jmodel.temporal_shapes)
    out["level_start_index"] = tuple(
        int(s) for s in np.cumsum((0,) + tuple(jmodel.temporal_shapes[:-1])))
    tcorr = tcrit.SetCriterion(["corr"], tvocab.pad_idx)
    got = tcorr(out, tbatch, *(torch.from_numpy(np.array(a)) for a in (idx, idx_aux, mask)))
    assert set(got) == set(ref) == {"loss_corr"}
    r = float(ref["loss_corr"])
    assert r != 0 and abs(float(got["loss_corr"]) - r) <= 1e-4 * abs(r)
    # end to end: the share sums taps of both signs (the reference keeps a
    # negative margin), so f32 noise in the locations comes back amplified
    tout, _, tidx, taux, tmask = tmodel.forward_eval(tbatch, "teacher_forcing")
    own = tcorr(tout, tbatch, tidx, taux, tmask)["loss_corr"]
    assert not own.requires_grad and abs(float(own) - r) <= 1e-3 * abs(r)


def test_entry_points_default_to_the_card(monkeypatch, world):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inference.main(["--synthetic"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tevaluate.evaluate(None, [], None, world[1])


def test_synthetic_world_with_a_given_vocab(tmp_path):
    from multimodal_feature_learning_tpu_torch.config import Config

    itos = ["<unk>", "<pad>", "<bos>", "<eos>"] + [f"w{i}" for i in range(60)]
    cfg = inference.make_synthetic_world(Config(), str(tmp_path / "w"), vocab=Vocab(itos))
    ds, vocab = tanet.build_dataset("val", cfg)
    assert vocab.itos == itos and len(ds) == 32
    assert ds[0]["video_feature"].shape == (64, 512)


def test_inference_cli_on_the_cpu(tmp_path):
    from test_cli_drivers import TINY

    dims = [o for o in TINY if not o.startswith(("eval_rate", "checkpoint_rate"))]
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "multimodal_feature_learning_tpu_torch.inference",
         "--synthetic", "--device", "cpu", "--config-overrides", *dims],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "Eval scores:" in r.stdout and "val stats:" in r.stdout
    with open(tmp_path / "output" / "submission" / "submission_epoch_0000.json") as f:
        sub = json.load(f)
    with open(tmp_path / "synthetic_anet" / tanet.SPLIT_FILES["val"]) as f:
        assert set(sub["results"]) == set(json.load(f))
