"""The readings that the limits of ``limits/<workload>.json`` are set
from, on the card at the cell's own size: for each seed, the program's
numbers against the plain reference, the control's (the reference itself
in the program's place, computed with TF32 products, the precision below
the configurations' f32), and each fault's the cell can have. The
benchmark's own runs do not run this.

    python3 -m portbench.control --workload <name> --seeds 1,2,3 [--seconds 3]

Serving: one model and server for every seed; each seed a short window at
the cell's load, then its sample's numbers against the reference; the
control's, from a TF32 reference pass over the same prompts (its own
events; at each compared position the token it puts first); the faults: a
served token altered, a served segment moved by 1% of the duration.
Training: each seed a new model and train state and its first steps (no
window); the control's, the reference's steps in TF32; the fault: each
step on half of its rows (the mean over the rest). A state left unchanged
reads 1 on ``grad_gap`` and ``change_gap`` by their definition and needs no
run. One JSON line a seed.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time

import torch

from . import check, registry, serve_cell, train_cell
from .reference.run import precision as ref_precision, serve_outputs


def _public(numbers: dict) -> dict:
    return {k: v for k, v in numbers.items() if not k.startswith("_")}


def serve_control(cell, numbers: dict, device) -> dict:
    """The control's serving numbers: the TF32 reference's own events
    against the f32 reference, and its token reading."""
    model, ref, requests = numbers["_model"], numbers["_ref"], numbers["_requests"]
    with ref_precision("tf32", device):
        low = serve_outputs(model, requests, device)
    G = model.max_gt
    answers = []
    for b in range(len(requests)):
        k = int(low["count"][b].argmax().clamp(1, G))
        top = low["order"][b][:k]
        answers.append([{"segment": tuple(float(x) for x in low["segments"][b, q]),
                         "score": float(low["scores"][b, q]),
                         "caption": [int(t) for t in numbers["_tokens"][b, j]]}
                        for j, q in enumerate(top)])
    out = check.serve_numbers(model, ref, answers, device)
    with ref_precision("tf32", device):
        from .reference.run import caption_logits

        control_logits = caption_logits(model, low["memory"], numbers["_crop"],
                                        numbers["_tokens"])
    out["token_gap"] = check.control_token_gap(numbers, control_logits)
    return _public(out)


def serve_faults(numbers: dict, answers: list, device) -> dict:
    """The numbers of the program's answers with one served token altered
    (the first compared position of the longest request's first event, to
    the token after it in the vocabulary), with one segment moved by 1% of
    its video's duration, and with the last event of the first request of
    several events dropped."""
    model, ref = numbers["_model"], numbers["_ref"]
    token = copy.deepcopy(answers)
    cap = token[0][0]["caption"]
    cap[1] = (cap[1] + 1) % model.caption.head.out_features
    moved = copy.deepcopy(answers)
    start, end = moved[0][0]["segment"]
    dur = float(ref["durations"][0])
    moved[0][0]["segment"] = (start + 0.01 * dur, end + 0.01 * dur)
    count = copy.deepcopy(answers)
    several = next((a for a in count if len(a) > 1), None)
    if several is not None:
        several.pop()
    return {"token_altered": _public(check.serve_numbers(model, ref, token, device)),
            "segment_moved": _public(check.serve_numbers(model, ref, moved, device)),
            "event_dropped": _public(check.serve_numbers(model, ref, count, device))}


def run_serve(cell, seeds, seconds: float, device) -> None:
    env = serve_cell.setup(cell, seeds[0], device)
    from . import traffic

    for seed in seeds:
        env.pool = traffic.serve_requests(cell.traffic, seed, env.cfg.dvc.detr.feature_dim)
        run = serve_cell.window(env, cell.traffic, seed, seconds, False, device)
        numbers = serve_cell.correctness(cell, env, run, seed, device, weight_seed=seeds[0])
        picked = check.sample_requests(run.records, cell.traffic["check_requests"], seed)
        answers = [r["events"] for r in picked]
        line = {"seed": seed, "program": _public(numbers),
                "control": serve_control(cell, numbers, device),
                **serve_faults(numbers, answers, device)}
        print(json.dumps(line), flush=True)
        del numbers
        torch.cuda.empty_cache() if device.type == "cuda" else None
    serve_cell.free(env)


def run_train(cell, seeds, device) -> None:
    for seed in seeds:
        env = train_cell.setup(cell, seed, device, trace=False)
        train_cell.free(env)
        numbers = train_cell.correctness(cell, env, seed, device)
        ref = numbers["_ref"]
        low = train_cell.reference_steps(cell, env, seed, device, precision="tf32")
        half = train_cell.reference_steps(cell, env, seed, device, half_batch=True)
        line = {"seed": seed, "program": _public(numbers),
                "control": _public(check.train_numbers(low, ref, env.p0)),
                "half_batch": _public(check.train_numbers(half, ref, env.p0))}
        del numbers, ref, low, half
        print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    from .run import ROOT, fix_caches

    cell = registry.find_cell(ROOT, args.workload)
    fix_caches(ROOT)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    from . import port

    port.build_kernels()
    seeds = [int(s) for s in args.seeds.split(",")]
    t = time.monotonic()
    if cell.traffic["kind"] == "serve":
        run_serve(cell, seeds, args.seconds, torch.device("cuda"))
    else:
        run_train(cell, seeds, torch.device("cuda"))
    print(json.dumps({"seconds": time.monotonic() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
