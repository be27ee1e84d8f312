"""Runs one cell of the port's benchmark once and prints its result as the
last line of standard output:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix; ``registry`` finds their files. Set-up builds the port's model
on the card and warms the cell's shapes up; the window offers the mix for
``--seconds``; then the program's state is freed and what the window
produced is compared with the plain reference (``check``). With
``--trace 0`` the result holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics and the device trace's reduction. The
run refuses (status 2, no result) where CUDA is absent or has fewer cards
than the cell asks for, and fails (status 3, no result) where the JAX
package or JAX itself is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "multimodal_feature_learning_tpu")


def fix_caches(root: str) -> None:
    """Every compile cache at a fixed directory inside the checkout (the
    port builds its kernels into ``build/kernels`` there by itself)."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, "build", "torch_extensions")


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def shapes_of(cfg, vocab_size: int) -> dict:
    from .reference.models.base_encoder import pyramid_shapes

    det, cap, anet = cfg.dvc.detr, cfg.dvc.caption, cfg.dataset.activity_net
    return {"G": anet.max_gt_target_segments, "D": cap.d_model, "H": cap.num_heads,
            "depth": cap.depth, "Lc": anet.max_caption_len_all,
            "S": sum(pyramid_shapes(det.video_rescale_len, det.num_feature_levels)),
            "F": int(cap.d_model * cap.mlp_ratio), "V": vocab_size}


def device_record(device, chips: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips))}


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run of ``cell``: set-up, the window, the comparison. Returns the
    result's fields (``correct``, ``attempted``, ``failed``, ``metrics``,
    ``device``, with a trace ``breakdown``, then ``spans`` and ``checks``)."""
    from . import check, registry, serve_cell, train_cell

    kind = cell.traffic["kind"]
    if kind == "serve":
        env = serve_cell.setup(cell, seed, device)
        setup_s = time.monotonic() - t_start
        run = serve_cell.window(env, cell.traffic, seed, seconds, trace, device)
        dev = device_record(device, cell.chips)
        serve_cell.free(env)
        numbers = serve_cell.correctness(cell, env, run, seed, device)
        attempted = len(run.records)
        failed = sum(1 for r in run.records if "error" in r)
        run.flops_proposal = numbers["flops_proposal"]
        spans = serve_spans(run)
    elif kind == "train":
        env = train_cell.setup(cell, seed, device, trace)
        setup_s = time.monotonic() - t_start
        run = train_cell.window(env, cell.traffic, seconds, trace, device)
        dev = device_record(device, cell.chips)
        train_cell.free(env)
        numbers = train_cell.correctness(cell, env, seed, device)
        attempted, failed = run.attempted, 0
        run.flops_step = numbers["flops_step"]
        spans = {"steps": len(run.done_s), "steps_queued": run.attempted}
    else:
        raise ValueError(f"unknown traffic kind {kind!r}")
    run.kind, run.setup_s = kind, setup_s
    run.shapes = shapes_of(env.cfg, cell.config["vocab_size"])
    metrics = registry.read_metrics(cell.per_layer if trace else cell.end_to_end, run)
    ok, checks = check.judge(numbers, cell.limits)
    result = {"correct": bool(ok and attempted > 0 and failed == 0), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"], dev["window_s"] = run.trace["busy_s"], run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    spans.update({k: v for k, v in numbers.items()
                  if not k.startswith("_") and k not in cell.limits})
    result["spans"] = spans
    result["checks"] = checks
    return result


def serve_spans(run) -> dict:
    """From the benchmark's own records: the dispatches that answered the
    window's requests, the share of them during which more requests arrived
    than a dispatch carries (between one dispatch's answers and the next's),
    and how late the open loop's generator sent (99th percentile, ms)."""
    import numpy as np

    done = {}
    for r in run.records:
        if "events" in r:
            done.setdefault(r["dispatch"], r["done"])
    times = sorted(done.values())
    dues = np.sort([r["due"] for r in run.records])
    over = sum(1 for a, b in zip(times, times[1:])
               if np.searchsorted(dues, b) - np.searchsorted(dues, a) > run.batch_size)
    out = {"dispatches": len(times), "server_stats": run.stats, "window_s": run.seconds,
           "overflow_share": over / max(len(times) - 1, 1)}
    if run.late_s:
        out["late_p99_ms"] = float(np.percentile(run.late_s, 99)) * 1e3
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from . import check, registry

    cell = registry.find_cell(ROOT, args.workload)
    fix_caches(ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    from . import port

    port.build_kernels()
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda"), T_START)
    leaked = forbidden_modules()
    if leaked:
        print(f"portbench: loaded after the window: {leaked}", file=sys.stderr)
        return 3
    check.print_checks(result["checks"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
