"""A serving cell: the port's static server (``DVCServer``) under a closed
loop that keeps a number of requests outstanding, or an open loop of
Poisson arrivals, for the window; then its answers against the plain
reference."""

from __future__ import annotations

import gc
import threading
import time
from types import SimpleNamespace

import torch

from . import check, port, traffic
from .trace import Window

WAIT_AFTER_S = 120.0  # an answer may come this long after the window closes


def setup(cell, seed: int, device):
    """The model, the server (warmed up by its own constructor, then by one
    full batch of this mix's requests) and the request pool."""
    mix = cell.traffic
    cfg, model = port.build_model(cell.config, device, seed)
    pool = traffic.serve_requests(mix, seed, cfg.dvc.detr.feature_dim)
    server = port.make_server(model, mix)
    for fut in [server.submit(f, d) for f, d in pool[:mix["batch_size"]]]:
        fut.result()
    return SimpleNamespace(cfg=cfg, model=model, server=server, pool=pool)


def window(env, mix: dict, seed: int, seconds: float, trace: bool, device) -> SimpleNamespace:
    """Offer the mix's load for ``seconds``; returns the run's records: one
    dict a request (pool index, due and answer times on the host clock,
    the dispatch that answered it, its events or its error), the K3
    launches counted when each dispatch answered, the server's counters
    over the window, the generator's lateness and the trace."""
    server, pool = env.server, env.pool
    records, dispatch_launches = [], {}
    lock = threading.Lock()
    closed = mix["loop"] == "closed"
    counter = {"next": 0}
    gaps = traffic.arrival_gaps(mix, seed) if not closed else None

    def answered(fut, rec):
        now = time.monotonic()
        d = server.stats["dispatches"]
        if d not in dispatch_launches:
            dispatch_launches[d] = port.launches()["fused_decode"]
        rec["done"], rec["dispatch"] = now, d
        try:
            rec["events"] = fut.result()
        except Exception as e:  # noqa: BLE001 - a failed request counts as failed
            rec["error"] = repr(e)
        if closed and now < t_end:
            send(now)

    def send(due):
        with lock:
            i = counter["next"] % len(pool)
            counter["next"] += 1
        rec = {"i": i, "due": due}
        records.append(rec)
        try:
            fut = server.submit(*pool[i])
        except RuntimeError as e:
            rec["error"], rec["done"] = repr(e), time.monotonic()
            return
        fut.add_done_callback(lambda f, rec=rec: answered(f, rec))

    stats0 = dict(server.stats)
    late = []
    if device.type == "cuda":
        torch.cuda.synchronize()
    with Window(trace) as win:
        t0 = time.monotonic()
        t_end = t0 + seconds
        dispatch_launches[stats0["dispatches"]] = port.launches()["fused_decode"]
        if closed:
            for _ in range(mix["outstanding"]):
                send(t0)
            while time.monotonic() < t_end:
                time.sleep(min(0.05, max(t_end - time.monotonic(), 0)))
        else:
            due, n = t0, 0
            while True:
                due += float(gaps[n % len(gaps)])
                n += 1
                if due >= t_end:
                    break
                pause = due - time.monotonic()
                if pause > 0:
                    time.sleep(pause)
                late.append(time.monotonic() - due)
                send(due)
            pause = t_end - time.monotonic()
            if pause > 0:
                time.sleep(pause)
        # the answers still due, inside the traced window: reducing the
        # trace holds the interpreter, and would slow the last dispatches
        deadline = time.monotonic() + WAIT_AFTER_S
        while any("done" not in r for r in records) and time.monotonic() < deadline:
            time.sleep(0.01)
    stats1 = dict(server.stats)
    return SimpleNamespace(t0=t0, t_end=t_end, seconds=seconds, records=records,
                           dispatch_launches=dispatch_launches,
                           stats={k: stats1[k] - stats0[k] for k in stats0},
                           late_s=late, trace=win.summary, batch_size=mix["batch_size"])


def free(env) -> None:
    env.server.close()
    env.server = env.model = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def correctness(cell, env, run, seed: int, device, weight_seed=None) -> dict:
    """The serving numbers of a sample of the window's answers against the
    reference; also the model FLOPs of one video's proposal half
    (``flops_proposal``), counted on the reference's own pass. The
    reference's weights are those of ``weight_seed`` (default ``seed``)
    where the configuration draws them."""
    from torch.utils.flop_counter import FlopCounterMode

    from .reference.run import build, precision as ref_precision, serve_outputs

    picked = check.sample_requests(run.records, cell.traffic["check_requests"], seed)
    requests = [env.pool[r["i"]] for r in picked]
    answers = [r["events"] for r in picked]
    _, model = build(cell.config, device, seed if weight_seed is None else weight_seed)
    model.requires_grad_(False)
    with ref_precision("f32", device):
        counter = FlopCounterMode(display=False)
        with counter:
            ref = serve_outputs(model, requests, device)
        numbers = check.serve_numbers(model, ref, answers, device)
    numbers["flops_proposal"] = counter.get_total_flops() / len(requests)
    numbers["requests_compared"] = len(requests)
    numbers["_model"], numbers["_ref"], numbers["_requests"] = model, ref, requests
    return numbers
