"""Serving load test: the static server against the continuous one, swept
over offered Poisson rates and decode chunk sizes; counterpart of the JAX
repository's ``tools/load_test_serve.py``.

    python3 -m multimodal_feature_learning_tpu_torch.tools.load_test_serve \\
        [--n-requests 256] [--rps 50,200] [--chunks 2,4,8] [--batch-size 16] \\
        [--weights snapshots/conv_e79.npz] [--resume CHECKPOINT] \\
        [--overrides use_differentiable_mask=false] [--device cuda]

Each point runs the port's serving CLI (``serve.py``) in a process of its
own, so every server starts clean: ``static`` and ``continuous_c<chunk>``
at every rate. The weights default to the trained conv_e79 snapshot, which
was trained without the differentiable context mask: trained captions end
at different lengths, which is where harvesting finished slots early can
pay (untrained ones run every row to the end). Prints one JSON row a point
(the CLI's row and ``point``) and, on stderr, a markdown table.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Callable, Dict, List, Sequence, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SNAPSHOT = os.path.join(REPO, "snapshots", "conv_e79.npz")


def commands(n_requests: int = 256, rps: Sequence[str] = ("50", "200"),
             chunks: Sequence[str] = ("2", "4", "8"), batch_size: int = 16,
             weights: str = SNAPSHOT, resume: str = "",
             overrides: Sequence[str] = ("use_differentiable_mask=false",),
             device: str = "cuda") -> List[Tuple[str, List[str]]]:
    """(point name, serve CLI arguments) of every point, rate by rate."""
    common = ["--n-requests", str(n_requests), "--batch-size", str(batch_size),
              "--device", device]
    if resume:
        common += ["--resume", resume]
    elif weights:
        common += ["--weights", weights]
    if overrides:
        common += ["--config-overrides", *overrides]
    modes = [("static", [])] + [(f"continuous_c{c}", ["--continuous", "--chunk", str(c)])
                                for c in chunks]
    return [(f"{name}@{r}rps", ["--rps", str(r), *extra, *common])
            for r in rps for name, extra in modes]


def run_point(argv: List[str], timeout_s: float) -> Dict:
    """The serve CLI in a subprocess; its last JSON line, or the error."""
    cmd = [sys.executable, "-m", "multimodal_feature_learning_tpu_torch.serve", *argv]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p))
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout_s, cwd=REPO,
                       env=env)
    if r.returncode != 0:
        return {"error": r.stderr[-300:], "cmd": " ".join(cmd)}
    for line in reversed(r.stdout.strip().splitlines()):
        try:
            return json.loads(line)
        except json.JSONDecodeError:
            continue
    return {"error": "no JSON line", "cmd": " ".join(cmd)}


def run(timeout_s: float = 900, launch: Callable[[List[str], float], Dict] = run_point,
        **kw) -> List[Dict]:
    """Every point of ``commands(**kw)`` through ``launch`` (a subprocess
    each, by default), printing each row as it comes."""
    rows = []
    for point, argv in commands(**kw):
        row = dict(launch(argv, timeout_s), point=point)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def markdown(rows: List[Dict]) -> str:
    lines = ["| point | offered rps | achieved rps | p50 ms | p95 ms | p99 ms | mean fill "
             "| dispatches |", "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if "error" in r:
            lines.append(f"| {r['point']} | ERROR {r['error'][:80]} |")
            continue
        lines.append(f"| {r['point']} | {r['offered_rps']} | {r['achieved_rps']:.2f} | "
                     f"{r['latency_p50_ms']:.2f} | {r['latency_p95_ms']:.2f} | "
                     f"{r['latency_p99_ms']:.2f} | {r['mean_batch_fill']:.2f} | "
                     f"{r['dispatches']} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-requests", type=int, default=256)
    ap.add_argument("--rps", default="50,200")
    ap.add_argument("--chunks", default="2,4,8")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--timeout-s", type=float, default=900)
    ap.add_argument("--weights", default=SNAPSHOT,
                    help="flat flax snapshot for every point ('' = weights from the seed)")
    ap.add_argument("--resume", default="", help="a checkpoint of the port's training CLI "
                                                 "(in place of --weights)")
    ap.add_argument("--overrides", default="use_differentiable_mask=false",
                    help="comma-separated config overrides for every point")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = run(timeout_s=args.timeout_s, n_requests=args.n_requests,
               rps=args.rps.split(","), chunks=args.chunks.split(","),
               batch_size=args.batch_size, weights=args.weights, resume=args.resume,
               overrides=[o for o in args.overrides.split(",") if o], device=args.device)
    print(markdown(rows), file=sys.stderr)
    return rows


if __name__ == "__main__":
    main()
