"""The port's spans on the device trace's timeline (``portbench/spans.py``),
on synthetic events: a span recorded by the port lands where the wall
clock says it was; an idle gap with no CUDA call at its midpoint takes the
innermost span's name; with no spans the reduction is ``trace``'s own.
Then the span metrics of tiny cells on the CPU, from their windows' own
spans."""

import time

import pytest
import torch

from portbench import serve_cell, spans, train_cell
from portbench.run import ROOT
from portbench.tests.tiny import tiny_cell
from portbench.trace import reduce_events

from multimodal_feature_learning_tpu_torch.utils.observability import SPANS, Span

CPU = torch.device("cpu")
MS = 1_000_000


class Event:
    """A profiler event as ``trace`` and ``spans`` read one."""

    def __init__(self, kind, name, start, end, thread=0):
        self.kind, self._name, self.start, self.end, self.thread = kind, name, start, end, thread

    def activity_type(self):
        return self.kind

    def name(self):
        return self._name

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.end - self.start

    def device_resource_id(self):
        return self.thread


def kernel(start, end):
    return Event("kernel", "k", start, end)


def call(name, start, end, thread=7):
    return Event("cuda_runtime", name, start, end, thread)


def span(sid, name, start, end, parent=None, thread=7, ident=None):
    return Span(sid, name, start, end, parent, thread, ident)


def gaps_around(*mids):
    """Kernels that leave an idle gap of 2 ms centred on each of ``mids``
    (sorted), and one before and after them."""
    events, cursor = [], mids[0] - 10 * MS
    for m in mids:
        events.append(kernel(cursor, m - MS))
        cursor = m + MS
    events.append(kernel(cursor, cursor + MS))
    return events


def test_a_recorded_span_lands_on_the_trace_clock():
    """Spans from the port's recorder against wall-clock stamps taken
    inside them: each gap centred on a stamp is named by the span the stamp
    was taken in, and one after them all stays "none"."""
    with SPANS.recording():
        with SPANS.span("outer"):
            time.sleep(0.005)
            in_outer = time.time_ns()
            time.sleep(0.005)
            with SPANS.span("inner"):
                time.sleep(0.005)
                in_inner = time.time_ns()
                time.sleep(0.005)
            time.sleep(0.005)
    time.sleep(0.005)
    after = time.time_ns()
    recorded = SPANS.take()
    events = gaps_around(in_outer, in_inner, after)
    t0, t1 = events[0].start, events[-1].end
    placed = spans.place(events, t0, t1, recorded)
    assert dict(placed["idle_gaps"]) == pytest.approx(
        {"outer": 0.002, "inner": 0.002, "none": 0.002})
    assert placed["idle_unattributed_share"] == pytest.approx(1 / 3)


def test_idle_gaps_take_the_innermost_span_where_no_call_is_open():
    events = gaps_around(20 * MS, 40 * MS, 60 * MS, 80 * MS)
    events.append(call("cudaStreamSynchronize", 39 * MS, 41 * MS))  # open at a midpoint
    events.append(call("cudaLaunchKernel", 59 * MS, 59 * MS + 1000))  # closed before one
    recorded = [span(0, "serve.dispatch", 15 * MS, 70 * MS),
                span(1, "model.decode", 30 * MS, 65 * MS, parent=0),
                span(2, "model.decode_step", 58 * MS, 62 * MS, parent=1),
                span(3, "serve.queued", 0, 90 * MS, thread=None)]  # no thread's: not a name
    t0, t1 = 10 * MS, 87 * MS
    placed = spans.place(events, t0, t1, recorded)
    idle = dict(placed["idle_gaps"])
    assert idle["serve.dispatch"] == pytest.approx(0.002)
    assert idle["cudaStreamSynchronize"] == pytest.approx(0.002)
    assert idle["model.decode_step"] == pytest.approx(0.002)
    assert idle["none"] == pytest.approx(0.002 + 0.005)
    assert "serve.queued" not in idle
    # idle, inside the decode, with no call open: the gaps at 40 and 60 ms,
    # less the sync that covers the first and the launch inside the second
    assert placed["idle_in_decode_s"] == pytest.approx(0.002 - 1e-6)
    # calls of the spans' thread that begin inside one of its spans
    assert placed["runtime_calls_in_spans"] == 1.0 and placed["runtime_calls"] == 2
    assert placed["program_spans"]["model.decode_step"] == {"count": 1, "mean_ms": 4.0,
                                                           "total_ms": 4.0}


def test_without_spans_the_reduction_is_the_trace_s_own():
    events = gaps_around(20 * MS, 40 * MS, 60 * MS)
    events += [call("cudaStreamSynchronize", 39 * MS, 41 * MS),
               call("cudaLaunchKernel", 5 * MS, 6 * MS, thread=9),
               Event("gpu_memcpy", "Memcpy HtoD", 61 * MS, 61 * MS + 10)]
    t0, t1 = 0, 80 * MS
    base = reduce_events(events, t0, t1)
    placed = spans.place(events, t0, t1, [])
    assert placed["idle_gaps"] == base["idle_gaps"]
    assert placed["runtime_calls_in_spans"] is None
    assert placed["runtime_calls_other_threads"] == 2
    assert spans.read_metrics("sparse_dvc.serve_backlog", {**base, **placed}) == {}


def test_a_call_outside_its_thread_s_spans_is_not_covered():
    events = [kernel(0, MS), call("cudaLaunchKernel", 2 * MS, 3 * MS),
              call("cudaLaunchKernel", 12 * MS, 13 * MS), kernel(20 * MS, 21 * MS)]
    recorded = [span(0, "train.step", 1 * MS, 10 * MS),
                span(1, "train.forward", 1 * MS, 10 * MS, parent=0),
                span(2, "train.step", 15 * MS, 18 * MS, thread=8)]  # another thread's
    placed = spans.place(events, 0, 21 * MS, recorded)
    assert placed["runtime_calls_in_spans"] == 0.5


SERVE = dict(batch_size=2, outstanding=4, pool=8, check_requests=4)


@pytest.mark.parametrize("workload, names", [
    ("sparse_dvc.serve_backlog", {"serve.decode_ms.backlog", "serve.idle_in_decode.backlog"}),
    ("sparse_dvc.serve_poisson", {"serve.queue_wait_ms.poisson"}),
    ("sparse_dvc.train_b64", {"train.fetch_wait_ms", "train.forward_host_ms",
                              "train.backward_host_ms"}),
])
def test_a_tiny_cell_s_window_gives_its_span_metrics(workload, names):
    """The window of a cell at the CPU tests' size with the recorder on: its
    spans, placed against an empty trace (one idle gap), give the cell's
    span metrics."""
    if "serve" in workload:
        cell = tiny_cell(ROOT, workload, **SERVE, rate_per_s=20.0)
        env = serve_cell.setup(cell, 3, CPU)
        with SPANS.recording():
            run = serve_cell.window(env, cell.traffic, 3, 0.5, False, CPU)
        serve_cell.free(env)
        answered = sum(1 for r in run.records if "events" in r)
    else:
        cell = tiny_cell(ROOT, workload, batch_size=2, pool=3)
        env = train_cell.setup(cell, 3, CPU, trace=False)
        with SPANS.recording():
            run = train_cell.window(env, cell.traffic, 0.5, False, CPU)
        train_cell.free(env)
    recorded = SPANS.take()
    trace = {"window_s": 0.5, **spans.place([], 0, time.time_ns(), recorded)}
    metrics = spans.read_metrics(workload, trace)
    assert set(metrics) == names
    assert all(m["value"] > 0 for m in metrics.values())
    counts = {n: v["count"] for n, v in trace["program_spans"].items()}
    if "serve" in workload:
        assert counts["serve.queued"] == answered
        assert counts["model.decode"] == counts["serve.dispatch"] == run.stats["dispatches"]
    else:
        assert counts["train.step"] == counts["train.fetch"] == run.attempted
