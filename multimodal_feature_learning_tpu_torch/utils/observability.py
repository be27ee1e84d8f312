"""Observability: gradient-flow statistics, a timed and traced section,
device memory; counterpart of the JAX ``utils/observability.py``.

Gradients are named as the port names its parameters (state_dict names)
and reported under the flax params paths of the JAX package ("a/b/c"), the
keys of its grad-flow files, so that the two packages' files compare key
by key. The trace of a section is torch.profiler's Chrome trace where JAX
writes a ``jax.profiler`` trace; memory comes from PyTorch's caching
allocator under JAX's key names.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .weights import SEP, export_flax_params


def flax_path(key: str) -> str:
    """A flat flax params key ("a||b||c", ``utils.weights.flax_key``) as
    JAX's grad-flow files key it, "a/b/c"."""
    return key.replace(SEP, "/")


def grad_flow_stats(grads: Mapping[str, torch.Tensor]) -> Dict[str, Dict[str, float]]:
    """{flax path: {mean_abs, max_abs, norm}} of gradients given by the
    state_dict names of their parameters, computed on the host in flax's
    layout with JAX's numpy reductions."""
    stats = {}
    for key, arr in export_flax_params(grads).items():
        a = np.abs(arr)
        stats[flax_path(key)] = {"mean_abs": float(a.mean()), "max_abs": float(a.max()),
                                 "norm": float(np.linalg.norm(a))}
    return stats


def save_grad_flow(grads: Mapping[str, torch.Tensor], out_dir: str, step: int,
                   plot: bool = True) -> Dict[str, Dict[str, float]]:
    """``grad_flow_stats`` written to ``grad_flow_{step:08d}.json`` in
    ``out_dir``, and with ``plot`` a bar plot of the mean and max |grad| of
    each parameter beside it where matplotlib imports, as JAX's."""
    os.makedirs(out_dir, exist_ok=True)
    stats = grad_flow_stats(grads)
    with open(os.path.join(out_dir, f"grad_flow_{step:08d}.json"), "w") as f:
        json.dump(stats, f)
    if plot:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return stats
        names = list(stats)
        xs = np.arange(len(names))
        fig, ax = plt.subplots(figsize=(max(8, len(names) * 0.2), 6))
        ax.bar(xs, [stats[n]["max_abs"] for n in names], alpha=0.4, lw=1, color="c",
               label="max")
        ax.bar(xs, [stats[n]["mean_abs"] for n in names], alpha=0.7, lw=1, color="b",
               label="mean")
        ax.set_xticks(xs)
        ax.set_xticklabels(names, rotation=90, fontsize=4)
        ax.set_yscale("log")
        ax.set_ylabel("|grad|")
        ax.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, f"grad_flow_{step:08d}.png"), dpi=150)
        plt.close(fig)
    return stats


@contextlib.contextmanager
def profile_section(name: str, log_dir: str = "", device: Optional[str] = None):
    """A timed section: its wall seconds printed on exit as JAX prints them.
    With ``log_dir``, torch.profiler traces it into ``<log_dir>/<name>.
    pt.trace.json`` (Chrome trace), with the card's kernels when ``device``
    is a CUDA device (None: the card where there is one). On the card the
    section ends with a synchronisation, so its time holds the work it
    queued."""
    cuda = torch.cuda.is_available() if device is None else torch.device(device).type == "cuda"
    prof = None
    if log_dir:
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(log_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=activities)
    t0 = time.perf_counter()
    with prof if prof is not None else contextlib.nullcontext():
        yield
        if cuda:
            torch.cuda.synchronize()
    print(f"[profile] {name}: {time.perf_counter() - t0:.3f}s", flush=True)
    if prof is not None:
        prof.export_chrome_trace(os.path.join(log_dir, f"{name}.pt.trace.json"))


# JAX's memory_stats keys and the caching allocator's counters they read
_MEMORY_KEYS = {"bytes_in_use": "allocated_bytes.all.current",
                "peak_bytes_in_use": "allocated_bytes.all.peak",
                "num_allocs": "allocation.all.allocated",
                "bytes_reserved": "reserved_bytes.all.current",
                "peak_bytes_reserved": "reserved_bytes.all.peak"}


def device_memory_stats() -> Dict[str, Optional[Dict[str, int]]]:
    """Memory of each device, under JAX's key names: for each CUDA device
    the caching allocator's counters (``_MEMORY_KEYS``) and ``bytes_limit``,
    the card's memory (``torch.cuda.mem_get_info``); without a card
    {"cpu": None}, as JAX gives None for a CPU device."""
    if not torch.cuda.is_available():
        return {"cpu": None}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {key: int(stats.get(name, 0)) for key, name in _MEMORY_KEYS.items()}
        out[f"cuda:{i}"]["bytes_limit"] = int(torch.cuda.mem_get_info(i)[1])
    return out
