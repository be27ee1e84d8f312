"""The marginal cost of one op in a chain, on the card: counterpart of the JAX
repository's ``tools/probe_op_overhead.py``.

    python3 -m multimodal_feature_learning_tpu_torch.tools.probe_op_overhead

Four rows, each a chain of N ops where every op takes the previous one's
output (the carry), as JAX's scan body does:

- ``add_us_per_op``: ``c + 1`` on (160, 64) bf16;
- ``probe_add_us_per_launch``: the same through the port's kernel K5
  (``ops/probe_add.py``, ``csrc/probe_add.cu``, bound with ctypes);
- ``matmul160x512x512_us_per_op``: ``tanh(c @ w)``, (160, 512) @ (512, 512)
  bf16;
- ``xattn_563keys_us_per_seq``: a decode-shaped cross-attention op sequence
  (einsum, f32 softmax of the logits x 0.125, einsum, tanh) of c (16, 8, 10,
  64) against K and V (16, 8, 563, 64), bf16 zeros.

Each row is timed in two modes: ``graph``, the N ops captured in one
``torch.cuda.CUDAGraph`` and replayed (the counterpart of JAX's one compiled
program), and ``eager``, the N ops dispatched from Python (how the port runs
today). The marginal µs per op is the difference between chains of 64 and
512 ops over 448, each chain's time the best of 3 reps of the mean of 10
runs, host clock around a synchronize. Graph mode needs the card and raises
elsewhere.
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, Tuple

import torch

from ..device import resolve_device
from ..ops.probe_add import PROBE_ADD, probe_add
from .timing import device_label, host_ms

MODES = ("graph", "eager")
ROWS = ("add_us_per_op", "probe_add_us_per_launch", "matmul160x512x512_us_per_op",
        "xattn_563keys_us_per_seq")


def make_rows(dev: torch.device) -> Dict[str, Tuple[Callable, torch.Tensor]]:
    """Each row's op and the carry it starts from, zeros as in JAX."""
    bf16 = torch.bfloat16
    w = torch.zeros((512, 512), dtype=bf16, device=dev)
    keys = torch.zeros((16, 8, 563, 64), dtype=bf16, device=dev)
    values = torch.zeros((16, 8, 563, 64), dtype=bf16, device=dev)

    def xattn(c):
        logits = torch.einsum("bhqd,bhkd->bhqk", c, keys).float()
        attn = torch.softmax(logits * 0.125, dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", attn.to(values.dtype), values)
        return torch.tanh(out)

    small = torch.zeros((160, 64), dtype=bf16, device=dev)
    return {
        "add_us_per_op": (lambda c: c + 1.0, small),
        "probe_add_us_per_launch": (probe_add, small),
        # tanh keeps the chain from folding into one product
        "matmul160x512x512_us_per_op": (lambda c: torch.tanh(c @ w),
                                        torch.zeros((160, 512), dtype=bf16, device=dev)),
        "xattn_563keys_us_per_seq": (xattn, torch.zeros((16, 8, 10, 64), dtype=bf16, device=dev)),
    }


def eager_ms(body, x, length: int, reps: int, iters: int) -> float:
    """Best-of-``reps`` mean ms of a chain of ``length`` ops dispatched from
    Python."""
    def chain():
        c = x
        for _ in range(length):
            c = body(c)
        return c

    chain()
    return host_ms(chain, x.device, iters, reps)


def graph_ms(body, x, length: int, reps: int, iters: int) -> Tuple[float, int]:
    """Best-of-``reps`` mean ms of one replay of a CUDA graph holding a chain
    of ``length`` ops, and the number of replays made. Each op is warmed up
    on a side stream first (the kernels are built and loaded there), and
    nothing inside the capture synchronises the host."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"graph mode needs a CUDA device, got {dev}")
    static = x.clone()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(3):
            body(static)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        c = static
        for _ in range(length):
            c = body(c)
    graph.replay()
    ms = host_ms(graph.replay, dev, iters, reps)
    del graph
    return ms, 1 + reps * iters


def run(device="cuda", modes=MODES, n1: int = 64, n2: int = 512, reps: int = 3,
        iters: int = 10) -> Dict:
    """Every row in every mode of ``modes``: µs per op from the chains of
    ``n1`` and ``n2`` ops. Also K5's launches over the run: in eager mode the
    wrapper's count, in graph mode the launches the replays ran (the
    wrapper counts a captured launch once, at capture)."""
    dev = resolve_device(device)
    for mode in modes:
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if mode == "graph" and dev.type != "cuda":
            raise ValueError(f"graph mode needs a CUDA device, got {dev}")
    rows = make_rows(dev)
    result = {"device": device_label(dev), "chain_lengths": [n1, n2], "reps": reps,
              "iters": iters, "probe_add_launches": {}}
    for mode in modes:
        result[mode] = {}
        for name in ROWS:
            body, x = rows[name]
            before = PROBE_ADD.launches
            if mode == "eager":
                t1, t2 = eager_ms(body, x, n1, reps, iters), eager_ms(body, x, n2, reps, iters)
                ran = PROBE_ADD.launches - before
            else:
                (t1, r1), (t2, r2) = graph_ms(body, x, n1, reps, iters), \
                    graph_ms(body, x, n2, reps, iters)
                # the captured launches ran once per replay, not at capture
                ran = PROBE_ADD.launches - before - (n1 + n2) + n1 * r1 + n2 * r2
            if body is probe_add:
                result["probe_add_launches"][mode] = ran
            result[mode][name] = 1e3 * (t2 - t1) / (n2 - n1)
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    result = run(args.device, tuple(args.modes.split(",")), reps=args.reps, iters=args.iters)
    print(f"device: {result['device']}")
    for mode in args.modes.split(","):
        for name in ROWS:
            print(f"{name} [{mode}]: {result[mode][name]:.3f}")
    print(f"probe_add_launches: {result['probe_add_launches']}")


if __name__ == "__main__":
    main()
