"""A configuration, a traffic mix, a limits file and a metric added as new
files are found by name, with no file of the benchmark edited (only the
index, BENCHMARK.json, gains entries)."""

import hashlib
import json
import os
import shutil
from types import SimpleNamespace

from portbench import registry

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def digests(tree: str) -> dict:
    out = {}
    for base, _, files in os.walk(tree):
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, tree)] = hashlib.sha1(f.read()).hexdigest()
    return out


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    before = digests(tmp_path / "portbench")
    pb = tmp_path / "portbench"
    (pb / "configs" / "dummy.json").write_text(json.dumps(
        {"name": "dummy", "vocab_size": 7, "weights": {"kind": "seeded"}, "config": {}}))
    (pb / "traffic" / "dummy_mix.json").write_text(json.dumps({"kind": "serve", "pool": 3}))
    (pb / "limits" / "dummy.dummy_mix.json").write_text(json.dumps({"token_gap": 0.5}))
    (pb / "metrics" / "dummy_metric.py").write_text(
        "def read(run):\n    return run.value * 2\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy", "source": "https://example.org/dummy",
                             "file": "portbench/configs/dummy.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "dummy.dummy_mix", "config": "dummy",
                               "traffic": "dummy_mix", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "dummy_metric", "unit": "%", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "setup_s", "workloads": ["dummy.dummy_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = registry.find_cell(str(tmp_path), "dummy.dummy_mix", here=str(pb))
    assert cell.config["vocab_size"] == 7 and cell.traffic["pool"] == 3
    assert cell.limits == {"token_gap": 0.5}
    assert [m["name"] for m in cell.per_layer] == ["dummy_metric"]
    assert "setup_s" in [m["name"] for m in cell.end_to_end]
    got = registry.read_metrics(cell.per_layer, SimpleNamespace(value=21), here=str(pb))
    assert got == {"dummy_metric": {"value": 42, "unit": "%"}}
    after = digests(pb)
    assert {k: v for k, v in after.items() if k in before} == before


def test_every_cell_of_the_benchmark_resolves():
    bench = registry.benchmark(ROOT)
    for w in bench["workloads"]:
        cell = registry.find_cell(ROOT, w["name"])
        assert cell.limits and cell.traffic["kind"] in ("serve", "train")
        for m in cell.end_to_end + cell.per_layer:
            assert callable(registry.reader(m["name"]))
