"""Observability: gradient-flow statistics, a timed and traced section,
device memory, and the spans of the port's layers (``SPANS``); counterpart
of the JAX ``utils/observability.py``, which has no spans.

Gradients are named as the port names its parameters (state_dict names)
and reported under the flax params paths of the JAX package ("a/b/c"), the
keys of its grad-flow files, so that the two packages' files compare key
by key. The trace of a section is torch.profiler's Chrome trace where JAX
writes a ``jax.profiler`` trace; memory comes from PyTorch's caching
allocator under JAX's key names.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Mapping, NamedTuple, Optional

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


class Span(NamedTuple):
    """One span of ``SpanRecorder``: ``start_ns`` and ``end_ns`` on
    ``time.time_ns``'s clock, the clock of torch.profiler's events;
    ``parent`` the ``sid`` of the span open around it on its thread (None
    at the top); ``thread`` the ``threading.get_ident`` of the thread that
    ran it (its pthread id, whose low 32 bits the profiler gives the
    thread's CUDA calls as their resource id), None for a wait that no
    thread spends, such as a request's in the queue; ``ident`` the request
    or dispatch it belongs to, where one applies."""
    sid: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    thread: Optional[int]
    ident: object


class _NoSpan:
    """The context every span is while the recorder is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _ThreadSpans(threading.local):
    """A thread's open spans, innermost last, and its id."""

    def __init__(self):
        self.stack: List[int] = []
        self.tid = threading.get_ident()


class _OpenSpan:
    __slots__ = ("rec", "name", "ident", "sid", "parent", "start")

    def __init__(self, rec: "SpanRecorder", name: str, ident):
        self.rec, self.name, self.ident = rec, name, ident

    def __enter__(self):
        stack = self.rec._local.stack
        self.parent = stack[-1] if stack else None
        self.sid = next(self.rec._ids)
        stack.append(self.sid)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        local = self.rec._local
        local.stack.pop()
        self.rec._spans.append((self.sid, self.name, self.start, end, self.parent, local.tid,
                                self.ident))
        return False


class SpanRecorder:
    """Spans at the port's layer boundaries (the server's queue, batcher and
    dispatch, the model's proposal and decode, the train step's stages),
    kept in memory while ``recording``. Off, the default, ``span`` tests one
    attribute and returns the shared ``NO_SPAN``: no allocation, no clock
    read. On or off it never synchronises the card and never records a CUDA
    event: a span measures the host, and holds the card's time only where
    the port already waits for it (the decode's per-step ``done`` read,
    ``device.to_host``, the trainer's lagged fetch). Spans are stamped on
    ``clock`` (``time.perf_counter_ns``) and handed out by ``take`` on
    ``time.time_ns``'s clock, through the offset between the two that
    ``recording`` reads once when it turns the recorder on.

    The spans are opened deep inside the model's code, which is handed no
    recorder, so the process has one: ``SPANS``."""

    clock = staticmethod(time.perf_counter_ns)

    def __init__(self):
        self.on = False
        self._offset_ns = 0
        self._spans: list = []
        self._ids = itertools.count()
        self._local = _ThreadSpans()

    def span(self, name: str, ident=None):
        """A context that records ``name`` over its block (with ``ident``,
        the request or dispatch it serves) and enters as the open span, its
        ``start`` on ``clock``; off, ``NO_SPAN``, which enters as None."""
        if not self.on:
            return NO_SPAN
        return _OpenSpan(self, name, ident)

    def add(self, name: str, start_ns: int, end_ns: int, ident=None) -> None:
        """Record a span that no thread runs, from ``start_ns`` to
        ``end_ns`` on ``clock``: a request's wait in the queue."""
        if self.on:
            self._spans.append((next(self._ids), name, start_ns, end_ns, None, None, ident))

    @contextlib.contextmanager
    def recording(self):
        """The recorder on over the block, from no spans."""
        self._spans = []
        self._offset_ns = time.time_ns() - time.perf_counter_ns()
        self.on = True
        try:
            yield self
        finally:
            self.on = False

    def take(self) -> List[Span]:
        """The spans recorded so far, each as it closed, and none kept."""
        spans, self._spans = self._spans, []
        off = self._offset_ns
        return [Span(sid, name, start + off, end + off, parent, tid, ident)
                for sid, name, start, end, parent, tid, ident in spans]


SPANS = SpanRecorder()
