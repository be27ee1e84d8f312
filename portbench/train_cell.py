"""A training cell: the port's trainer (``engine/train.py``:
``train_one_epoch`` around ``make_train_step``) over a pool of synthetic
batches. Set-up builds the train state and drives it from the seed through
the mix's first ``check_steps`` steps, through the same call and feed as
the window, keeping what the comparison needs; the window then goes on
with that same state. Afterwards the plain reference follows those first
steps."""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import torch

from . import check, port, traffic
from .trace import Window
from .yardstick import msda_bound_ms, msda_bwd_bound_ms


def batch_shapes(cfg, vocab_size: int) -> dict:
    """The sizes ``traffic.train_batches`` makes batches at."""
    anet = cfg.dataset.activity_net
    return {"feature_dim": cfg.dvc.detr.feature_dim, "vocab_size": vocab_size,
            "max_gt": anet.max_gt_target_segments,
            "max_caption_len": anet.max_caption_len_all,
            "video_rescale_len": anet.video_rescale_len,
            "audio_rescale_len": anet.audio_rescale_len
            if len(cfg.dvc.input_modalities) == 2 else 0}


class Steps:
    """The port's train step with the benchmark's span around each call:
    the host seconds the call took (the step queues its work and returns),
    and a CUDA event recorded after it, which the device reaches when the
    step's work is done."""

    def __init__(self, train_step, device):
        self.train_step, self.device = train_step, device
        self.enqueue_s, self.events, self.returned = [], [], []

    def __call__(self, state, batch, leaf_norms: bool = False):
        t = time.perf_counter()
        metrics = self.train_step(state, batch, leaf_norms=leaf_norms)
        self.enqueue_s.append(time.perf_counter() - t)
        self.returned.append(time.monotonic())
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
        return metrics


def setup(cell, seed: int, device, trace: bool):
    mix = cell.traffic
    cfg, model = port.build_model(cell.config, device, seed)
    pool = traffic.train_batches(mix, seed, batch_shapes(cfg, cell.config["vocab_size"]))
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, train_step, train_one_epoch = port.make_trainer(cfg, model, seed)
    steps = Steps(train_step, device)
    logs = []

    def epoch(batches):
        train_one_epoch(steps, state, batches, epoch=0, print_freq=1 << 30,
                        step_logger=lambda log, _: logs.append(log))

    n = mix["check_steps"]
    epoch(pool[:1])
    moments = {k: v.clone() for k, v in port.adam_first_moments(state).items()}
    epoch(pool[1:n - 1])
    msda = None
    if trace:
        with port.recording_msda_calls() as calls:
            epoch(pool[n - 1:n])
        msda = msda_step_bounds(calls)
        del calls
    else:
        epoch(pool[n - 1:n])
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    prog = {"losses": [log["loss"] for log in logs[:n]], "moments": moments,
            "params": params, "terms": logs[0]}
    return SimpleNamespace(cfg=cfg, model=model, state=state, steps=steps, epoch=epoch,
                           pool=pool, p0=p0, prog=prog, msda=msda, n_check=n)


def msda_step_bounds(calls) -> dict:
    """K1's and K2's bound (ms) summed over one step's MSDA calls, and the
    number of calls."""
    fwd = sum(msda_bound_ms(c["value"], c["shapes"], c["loc"], c["aw"], c["out"])[0]
              for c in calls)
    bwd = sum(msda_bwd_bound_ms(c["value"], c["shapes"], c["loc"], c["aw"], c["g"])[0]
              for c in calls if "g" in c)
    return {"fwd_ms": fwd, "bwd_ms": bwd, "calls": len(calls)}


def window(env, mix: dict, seconds: float, trace: bool, device) -> SimpleNamespace:
    """Train for ``seconds`` from the state set-up left, cycling the pool;
    a step counts when the device has finished it."""
    pool, steps = env.pool, env.steps
    first = len(steps.enqueue_s)

    def feed():
        i = env.n_check
        while time.monotonic() < t_end:
            yield pool[i % len(pool)]
            i += 1

    if device.type == "cuda":
        torch.cuda.synchronize()
    with Window(trace) as win:
        start = torch.cuda.Event(enable_timing=True) if device.type == "cuda" else None
        t0 = time.monotonic()
        if start is not None:
            start.record()
        t_end = t0 + seconds
        env.epoch(feed())
    done_s = []
    if start is not None:
        torch.cuda.synchronize()
        done_s = [start.elapsed_time(ev) / 1e3 for ev in steps.events[first:]]
    else:
        # on the CPU a step is done when its call returns
        done_s = [t - t0 for t in steps.returned[first:]]
    in_window = [t for t in done_s if t <= seconds]
    return SimpleNamespace(seconds=seconds, attempted=len(done_s), done_s=in_window,
                           enqueue_s=steps.enqueue_s[first:first + len(in_window)],
                           trace=win.summary, batch_size=mix["batch_size"], msda=env.msda)


def free(env) -> None:
    env.model = env.state = env.steps = env.epoch = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference_steps(cell, env, seed: int, device, precision: str = "f32",
                    half_batch: bool = False) -> dict:
    """The plain reference's first steps from the weights the program
    started from, over the same batches and dropout seeds, computed in
    ``precision`` (``half_batch``: a fault, each step on half its rows):
    ``losses``, ``moments``, ``params`` and ``flops`` (its first step's
    forward and backward, as ``FlopCounterMode`` counts them)."""
    from .reference.run import build, precision as ref_precision, train_steps

    cfg, model = build(cell.config, device, seed)
    with ref_precision(precision, device):
        losses, moments, params, flops, terms = train_steps(
            cfg, model, env.pool[:env.n_check], seed, device, half_batch=half_batch)
    del model
    return {"losses": losses, "moments": moments, "params": params, "flops": flops,
            "terms": terms}


def correctness(cell, env, seed: int, device) -> dict:
    """The training numbers of the program's first steps against the
    reference's; also ``flops_step``, the model FLOPs of one step."""
    ref = reference_steps(cell, env, seed, device)
    numbers = check.train_numbers(env.prog, ref, env.p0)
    numbers["flops_step"] = ref["flops"]
    numbers["_ref"] = ref
    return numbers
