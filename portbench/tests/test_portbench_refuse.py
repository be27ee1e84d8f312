"""The timed command refuses to run without a CUDA device, and fails in a
checkout that holds only the benchmark; neither prints a result."""

import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
ARGS = ["-m", "portbench.run", "--workload", "sparse_dvc.serve_backlog", "--seed",
        "2147483659", "--seconds", "1", "--trace", "0"]


def run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, *ARGS], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_refuses_without_a_cuda_device():
    out = run(ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA" in out.stderr


def test_fails_with_the_benchmark_alone(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    out = run(tmp_path)
    assert out.returncode != 0
    assert "{" not in out.stdout
