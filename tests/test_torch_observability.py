"""The port's observability (``utils/observability.py``) against the JAX
package's: gradient-flow statistics and their JSON on the same gradients
within 1e-6 relative (numpy reductions on both sides, in flax's layout), the
grad-flow dump of the trainer under the same paths, and on the CPU the
timed and traced section and the memory report (no card: None, as JAX's
for its CPU device)."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from multimodal_feature_learning_tpu.utils import observability as jobs
from multimodal_feature_learning_tpu_torch.engine.train import dump_grad_flow
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
