"""The port's observability (``utils/observability.py``) against the JAX
package's: gradient-flow statistics and their JSON on the same gradients
within 1e-6 relative (numpy reductions on both sides, in flax's layout), the
grad-flow dump of the trainer under the same paths, and on the CPU the
timed and traced section and the memory report (no card: None, as JAX's
for its CPU device). Then the port's own span recorder (``SPANS``, which
JAX lacks): off it records nothing, on its spans nest, and a tiny server and
a tiny train step record the spans of their layers."""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from test_torch_common import (
    BOS, EOS, PAD, VOCAB_SIZE, array_batch, jax_small_cfg, small_vocab, torch_cfg_like,
)

from multimodal_feature_learning_tpu.utils import observability as jobs
from multimodal_feature_learning_tpu_torch.engine.state import create_train_state
from multimodal_feature_learning_tpu_torch.engine.train import (
    dump_grad_flow, make_train_step, train_one_epoch,
)
from multimodal_feature_learning_tpu_torch.models import build_model_and_criterion
from multimodal_feature_learning_tpu_torch.models.dvc import build_model
from multimodal_feature_learning_tpu_torch.serve import DVCServer
from multimodal_feature_learning_tpu_torch.models.embeddings import VocabularyEmbedder
from multimodal_feature_learning_tpu_torch.models.layers import MLP
from multimodal_feature_learning_tpu_torch.utils import observability as tobs
from multimodal_feature_learning_tpu_torch.utils.weights import export_flax_params, flax_key

REL = 1e-6


class Small(torch.nn.Module):
    """A few of the port's modules: Dense kernels (transposed in flax), an
    embedding, biases."""

    def __init__(self):
        super().__init__()
        matrix = np.random.default_rng(0).normal(size=(11, 6)).astype(np.float32)
        self.target_embedding = VocabularyEmbedder(11, 8, matrix)
        self.mlp = MLP(8, 16, 8)


def named_grads(seed: int = 0) -> dict:
    """{state_dict name: gradient} of ``Small``, drawn from a numpy seed."""
    rng = np.random.default_rng(seed)
    return {n: torch.from_numpy(rng.normal(size=tuple(p.shape)).astype(np.float32))
            for n, p in Small().named_parameters()}


def jax_tree(grads: dict) -> dict:
    """The same gradients as a flax tree, as JAX's train step gives them."""
    tree = {}
    for key, arr in export_flax_params(grads).items():
        node = tree
        *path, leaf = key.split("||")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def assert_stats_close(got: dict, ref: dict):
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].keys() == ref[k].keys(), k
        for stat, v in ref[k].items():
            assert abs(got[k][stat] - v) <= REL * abs(v), (k, stat, got[k][stat], v)


def test_grad_flow_stats_equal_jax():
    grads = named_grads()
    got = tobs.grad_flow_stats(grads)
    assert_stats_close(got, jobs.grad_flow_stats(jax_tree(grads)))
    assert "params/target_embedding/Dense_0/kernel" in got
    assert len(got) == len(grads)


def test_save_grad_flow_writes_jax_s_files(tmp_path):
    grads = named_grads(1)
    got = tobs.save_grad_flow(grads, str(tmp_path / "port"), step=7)
    ref = jobs.save_grad_flow(jax_tree(grads), str(tmp_path / "jax"), step=7)
    assert_stats_close(got, ref)
    for pkg in ("port", "jax"):
        assert sorted(os.listdir(tmp_path / pkg)) == ["grad_flow_00000007.json",
                                                      "grad_flow_00000007.png"]
    with open(tmp_path / "port" / "grad_flow_00000007.json") as f, \
            open(tmp_path / "jax" / "grad_flow_00000007.json") as g:
        assert_stats_close(json.load(f), json.load(g))
    tobs.save_grad_flow(grads, str(tmp_path / "noplot"), step=1, plot=False)
    assert os.listdir(tmp_path / "noplot") == ["grad_flow_00000001.json"]


def test_grad_flow_dump_keys_are_the_stats_paths(tmp_path):
    """The trainer's dump (``grad_leaf_norms`` by flax key) and the stats
    share one path mapping."""
    grads = named_grads(2)
    norms = {flax_key(n, g.dim()): g.norm() for n, g in grads.items()}
    path = dump_grad_flow(str(tmp_path), norms, epoch=1, step_in_epoch=3)
    assert os.path.basename(path) == "grads_e001_s00003.json"
    with open(path) as f:
        dumped = json.load(f)
    stats = tobs.grad_flow_stats(grads)
    assert dumped.keys() == stats.keys()
    for k, v in dumped.items():
        assert abs(v - stats[k]["norm"]) <= 1e-5 * stats[k]["norm"], k


@pytest.mark.parametrize("traced", [False, True])
def test_profile_section_on_the_cpu(tmp_path, capsys, traced):
    log_dir = str(tmp_path / "trace") if traced else ""
    with tobs.profile_section("matmul", log_dir, device="cpu"):
        torch.randn(64, 64) @ torch.randn(64, 64)
    out = capsys.readouterr().out
    assert out.startswith("[profile] matmul: ") and out.rstrip().endswith("s")
    float(out.split(": ")[1].rstrip().rstrip("s"))
    if traced:
        with open(os.path.join(log_dir, "matmul.pt.trace.json")) as f:
            events = json.load(f)["traceEvents"]
        assert any("mm" in str(e.get("name", "")) for e in events)
    else:
        assert not os.path.exists(tmp_path / "trace")


def test_device_memory_stats_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    got = tobs.device_memory_stats()
    assert got == {"cpu": None}
    assert set(jobs.device_memory_stats().values()) == {None}  # JAX's CPU devices


@pytest.fixture
def recorder():
    """The process's recorder, off and empty before and after the test."""
    tobs.SPANS.take()
    yield tobs.SPANS
    assert not tobs.SPANS.on
    tobs.SPANS.take()


def test_an_off_recorder_records_nothing(recorder):
    assert not recorder.on
    spans = [recorder.span("a"), recorder.span("b", ident=3)]
    assert spans[0] is spans[1] is tobs.NO_SPAN
    with recorder.span("a") as s:
        assert s is None
    recorder.add("serve.queued", 0, 1, (0, 0))
    assert recorder.take() == []


def test_spans_nest_per_thread_on_the_wall_clock(recorder):
    def other():
        with recorder.span("other"):
            with recorder.span("other.inner", ident=7):
                pass

    t0 = time.time_ns()
    with recorder.recording():
        with recorder.span("outer", ident=1) as outer:
            with recorder.span("inner"):
                worker = threading.Thread(target=other)
                worker.start()
                worker.join(timeout=30)
            with recorder.span("inner"):
                pass
            recorder.add("waited", outer.start, recorder.clock(), (4, 1))
    t1 = time.time_ns()
    spans = {(s.name, s.start_ns): s for s in recorder.take()}
    assert recorder.take() == []
    by_name = {}
    for s in spans.values():
        by_name.setdefault(s.name, []).append(s)
        assert t0 <= s.start_ns <= s.end_ns <= t1
    (top,), inners = by_name["outer"], by_name["inner"]
    assert top.parent is None and top.ident == 1
    assert len(inners) == 2 and all(s.parent == top.sid for s in inners)
    assert top.thread == threading.get_ident()
    (o,), (oi,) = by_name["other"], by_name["other.inner"]
    assert o.parent is None and oi.parent == o.sid and oi.ident == 7
    assert o.thread == worker.ident != top.thread
    (w,) = by_name["waited"]
    assert w.thread is None and w.parent is None and w.ident == (4, 1)
    assert w.start_ns == top.start_ns
    assert len({s.sid for s in spans.values()}) == len(spans)


def children(spans, parent):
    return [s.name for s in sorted(spans, key=lambda s: s.start_ns) if s.parent == parent.sid]


def test_a_served_batch_records_its_layers(recorder):
    """Three requests in one dispatch of a tiny server: the dispatch's
    children, one decode step a token the loop decoded, and each request's
    wait ending where its dispatch starts."""
    cfg = torch_cfg_like(jax_small_cfg())
    model = build_model(cfg, VOCAB_SIZE, PAD, BOS, EOS, device="cpu")
    steps = []
    decode_pair = model.caption.decode_pair
    model.caption.decode_pair = lambda *a, **k: steps.append(1) or decode_pair(*a, **k)
    rng = np.random.default_rng(0)
    D = cfg.dvc.detr.feature_dim
    server = DVCServer(model, batch_size=3, max_wait_ms=30000.0)
    steps.clear()  # the constructor's warm-up
    with recorder.recording():
        futs = [server.submit(rng.normal(size=(n, D)).astype(np.float32), 20.0 + n)
                for n in (12, 30, 50)]
        assert all(len(f.result(timeout=120)) >= 1 for f in futs)
        server.close()
    spans = recorder.take()
    assert server.stats["dispatches"] == 1
    names = [s.name for s in spans]
    (dispatch,) = [s for s in spans if s.name == "serve.dispatch"]
    assert children(spans, dispatch) == ["serve.to_device", "model.propose", "model.decode",
                                         "serve.to_host"]
    (decode,) = [s for s in spans if s.name == "model.decode"]
    assert children(spans, decode) == ["model.decode_step"] * len(steps)
    assert 1 <= len(steps) < cfg.dataset.activity_net.max_caption_len_all
    for name in ("serve.collect", "serve.assemble", "serve.answer"):
        assert names.count(name) == 1 and spans[names.index(name)].parent is None
    queued = [s for s in spans if s.name == "serve.queued"]
    assert sorted(s.ident for s in queued) == [(i, dispatch.ident) for i in range(3)]
    assert all(s.end_ns == dispatch.start_ns and s.start_ns < s.end_ns for s in queued)
    assert {s.thread for s in spans if s.name != "serve.queued"} == {server._worker.ident}


def test_a_train_step_records_its_stages_in_order(recorder):
    cfg = torch_cfg_like(jax_small_cfg())
    model, criterion, weight_dict = build_model_and_criterion(cfg, small_vocab(),
                                                              device="cpu")
    state = create_train_state(cfg, model, steps_per_epoch=10)
    step = make_train_step(criterion, weight_dict)
    with recorder.recording():
        train_one_epoch(step, state, [array_batch(cfg, 2)], epoch=0, print_freq=0)
    spans = sorted(recorder.take(), key=lambda s: s.start_ns)
    top = [s for s in spans if s.parent is None]
    assert [s.name for s in top] == ["train.data", "train.to_device", "train.step",
                                     "train.data", "train.fetch"]
    assert children(spans, top[2]) == ["train.forward", "train.criterion", "train.backward",
                                       "train.optimizer"]
    (forward,) = [s for s in spans if s.name == "train.forward"]
    assert children(spans, forward) == ["train.match"]
    assert all(a.end_ns <= b.start_ns for a, b in zip(top, top[1:]))
