"""Nothing the benchmark's command runs loads JAX, flax or the JAX package
(top-level module names compared whole: the port's name begins with the
JAX package's)."""

import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
FORBIDDEN = {"jax", "jaxlib", "flax", "multimodal_feature_learning_tpu"}

DRIVE = r"""
import json, pkgutil, importlib, sys, torch
torch.set_num_threads(2)
import portbench
for m in pkgutil.walk_packages(portbench.__path__, "portbench."):
    if ".tests" not in m.name:
        importlib.import_module(m.name)
from portbench.tests.tiny import tiny_cell
from portbench.run import ROOT, run_cell, forbidden_modules
import time
for w, kw in (("sparse_dvc.serve_backlog", dict(batch_size=2, outstanding=4, pool=6,
                                                check_requests=2)),
              ("mm_dvc.train_b64", dict(batch_size=2, pool=3))):
    run_cell(tiny_cell(ROOT, w, **kw), 7, 0.5, False, torch.device("cpu"), time.monotonic())
print(json.dumps(sorted({n.split(".")[0] for n in sys.modules})))
"""


def test_a_run_loads_no_jax_module():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", DRIVE], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "multimodal_feature_learning_tpu_torch" in top
    assert not top & FORBIDDEN


def test_no_source_names_a_forbidden_module():
    pattern = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|multimodal_feature_learning_tpu)"
                         r"(\.|\s|$)", re.M)
    for base, _, files in os.walk(os.path.dirname(HERE)):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(base, name)) as f:
                    assert not pattern.search(f.read()), os.path.join(base, name)


def test_forbidden_names_compare_whole(monkeypatch):
    from portbench.run import forbidden_modules

    monkeypatch.setitem(sys.modules, "multimodal_feature_learning_tpu_torch_x", sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert forbidden_modules() == ["jax"]
