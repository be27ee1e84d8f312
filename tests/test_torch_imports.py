"""The port and its on-card smoke test import neither JAX, its libraries,
the libraries the machine with the card lacks, nor the JAX package: an AST
scan of every import in ``multimodal_feature_learning_tpu_torch`` and
``chip_smoke.py``, by exact top-level module name."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "ml_collections", "h5py",
             "multimodal_feature_learning_tpu"}
FILES = sorted((ROOT / "multimodal_feature_learning_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def imported_top_levels(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names.add(arg.value.split(".")[0])
    return names


def test_the_scan_covers_the_port():
    rel = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "multimodal_feature_learning_tpu_torch/serve.py" in rel
    assert "multimodal_feature_learning_tpu_torch/main.py" in rel
    assert "multimodal_feature_learning_tpu_torch/tools/load_test_serve.py" in rel
    assert "multimodal_feature_learning_tpu_torch/models/dvc.py" in rel
    assert "multimodal_feature_learning_tpu_torch/utils/ref_bridge.py" in rel
    assert "multimodal_feature_learning_tpu_torch/tools/export_to_reference.py" in rel
    assert "chip_smoke.py" in rel


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_forbidden_imports(path):
    assert not imported_top_levels(path) & FORBIDDEN


def test_the_scan_sees_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import os\nfrom multimodal_feature_learning_tpu.ops import x\n"
                   "def f():\n    import jax.numpy as jnp\n")
    assert imported_top_levels(bad) & FORBIDDEN == {"jax", "multimodal_feature_learning_tpu"}
