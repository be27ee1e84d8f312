"""One traced run of a cell, as ``python3 -m portbench.run --trace 1``
makes it, with the port's span recorder on over the window
(``spans.SpanWindow``), printing that run's result line with the idle gaps
named by the spans, the span metrics (``spans.METRICS``) among the
metrics, and under ``spans`` the spans' counts and host times, the share of
the idle time no span or CUDA call names and the share of the port's CUDA
calls inside its spans:

    python3 -m portbench.spanrun --workload <name> --seed <n> --seconds <s> [--recorder 0|1]

``--recorder 0`` leaves the recorder off: the same traced run, to set the
recorder's cost against. The run needs a CUDA device, as ``portbench.run``
does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

T_START = time.monotonic()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--recorder", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)

    from . import check, registry, run, serve_cell, spans, train_cell

    cell = registry.find_cell(run.ROOT, args.workload)
    run.fix_caches(run.ROOT)
    import torch

    if not torch.cuda.is_available():
        print(f"portbench: {args.workload} needs a CUDA device", file=sys.stderr)
        return 2
    from . import port

    port.build_kernels()
    windows = []

    def window(enabled: bool):
        windows.append(spans.SpanWindow(enabled, recorder=bool(args.recorder)))
        return windows[-1]

    # the cells' windows are trace.Window, bound in each module
    serve_cell.Window = train_cell.Window = window
    result = run.run_cell(cell, args.seed, args.seconds, True, torch.device("cuda"), T_START)
    summary = windows[-1].summary
    result["metrics"].update(spans.read_metrics(cell.name, summary))
    result["spans"].update({k: summary[k] for k in (
        "program_spans", "idle_unattributed_share", "runtime_calls_in_spans",
        "runtime_calls", "runtime_calls_other_threads", "idle_in_decode_s")})
    check.print_checks(result["checks"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
