"""Finds what a cell needs by the names in ``BENCHMARK.json``: its
configuration (``configs/<config>.json``, the path the entry names), its
traffic mix (``traffic/<traffic>.json``), the limits its comparison holds
the program to (``limits/<workload>.json``) and the reader of each of its
metrics (``metrics/<metric>.py``, a function ``read(run)``). A later cell,
configuration, mix or metric is a new file and a new entry: no file here
changes."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass
class Cell:
    name: str
    chips: int
    config: dict           # the configuration file's contents
    traffic: dict          # the mix's parameters
    limits: dict           # {number compared: limit}
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str) -> dict:
    return read_json(os.path.join(root, "BENCHMARK.json"))


def metrics_of(bench: dict, kind: str, workload: str) -> List[dict]:
    """The metrics of ``kind`` ("end_to_end", "per_layer") that the cell
    reports: those that list it under ``workloads``, and those that list no
    cells."""
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def find_cell(root: str, workload: str, here: str = HERE) -> Cell:
    bench = benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(it has {sorted(entries)})")
    entry = entries[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(os.path.join(root, configs[entry["config"]]["file"]))
    return Cell(name=workload, chips=int(entry["chips"]), config=config,
                traffic=read_json(os.path.join(here, "traffic", f"{entry['traffic']}.json")),
                limits=read_json(os.path.join(here, "limits", f"{workload}.json")),
                end_to_end=metrics_of(bench, "end_to_end", workload),
                per_layer=metrics_of(bench, "per_layer", workload))


def reader(name: str, here: str = HERE) -> Callable:
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(here, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(metrics: List[dict], run, here: str = HERE) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of every metric whose reader finds
    something to read; a reader that finds nothing returns None and the
    metric is left out."""
    out = {}
    for m in metrics:
        value = reader(m["name"], here)(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
