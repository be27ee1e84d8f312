"""The MSDA backends at the flagship's shapes, on the card: counterpart of the
JAX repository's ``tools/profile_msda.py``.

    python3 -m multimodal_feature_learning_tpu_torch.tools.profile_msda [--iters 50]

Backends: ``plain`` (``ops/ms_deform_attn.py``: ``ms_deform_attn_core`` and
``ms_deform_attn_core_backward``) and ``kernel`` (``ops/msda.py``:
``ms_deform_attn``, the forward K1 and the backward K2). For each case the
forward ms, and the forward plus the backward of ``sum(out ** 2)`` with
respect to value, loc and aw, ms; CUDA events over ``iters`` calls after a
warm-up. Cases: B=16, pyramid (300, 150, 75, 38), H=8, Dh=64, P=4, with
Q = 563 (encoder, dense), 282 (encoder, sparse, rho 0.5) and 20 (decoder).
Prints one markdown table per case.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ops.ms_deform_attn import ms_deform_attn_core, ms_deform_attn_core_backward
from ..ops.msda import ms_deform_attn
from .timing import device_label, device_ms

SHAPES = (300, 150, 75, 38)
CASES = (("encoder self-attn", 563), ("encoder sparse (rho=0.5)", 282),
         ("decoder cross-attn", 20))
BACKENDS = ("plain", "kernel")


def inputs(B, Q, H, Dh, shapes, P, dev, seed=0):
    """value N(0, 1), loc U(0, 1), aw U(0, 1) normalised over (L, P), from a
    numpy seed, as the JAX tool makes them."""
    rng = np.random.default_rng(seed)
    S, L = sum(shapes), len(shapes)
    value = rng.normal(size=(B, S, H, Dh)).astype(np.float32)
    loc = rng.uniform(0, 1, size=(B, Q, H, L, P)).astype(np.float32)
    aw = rng.uniform(0, 1, size=(B, Q, H, L, P)).astype(np.float32)
    aw /= aw.sum(axis=(3, 4), keepdims=True)
    return [torch.from_numpy(a).to(dev) for a in (value, loc, aw)]


def backend_fns(backend: str, value, shapes, loc, aw):
    """(forward, forward + backward) of one backend on these inputs."""
    if backend == "plain":
        def fwd():
            return ms_deform_attn_core(value, shapes, loc, aw)

        def fwd_bwd():
            out = ms_deform_attn_core(value, shapes, loc, aw)
            return ms_deform_attn_core_backward(value, shapes, loc, aw, 2 * out)
        return fwd, fwd_bwd
    if backend != "kernel":
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    leaves = [t.clone().requires_grad_() for t in (value, loc, aw)]

    def fwd():
        with torch.no_grad():
            return ms_deform_attn(value, shapes, loc, aw)

    def fwd_bwd():
        out = ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2])
        return torch.autograd.grad((out ** 2).sum(), leaves)
    return fwd, fwd_bwd


def run(device="cuda", iters: int = 50, B: int = 16, H: int = 8, Dh: int = 64, P: int = 4,
        shapes: Sequence[int] = SHAPES, cases=CASES, backends=BACKENDS) -> Dict:
    """Rows {case, Q, backend, fwd_ms, fwd_bwd_ms} of every case and backend."""
    dev = resolve_device(device)
    shapes = tuple(shapes)
    rows: List[Dict] = []
    for name, Q in cases:
        value, loc, aw = inputs(B, Q, H, Dh, shapes, P, dev)
        for backend in backends:
            fwd, fwd_bwd = backend_fns(backend, value, shapes, loc, aw)
            fwd(), fwd_bwd()  # warm-up (builds the kernels on first use)
            rows.append({"case": name, "Q": Q, "backend": backend,
                         "fwd_ms": device_ms(fwd, dev, iters),
                         "fwd_bwd_ms": device_ms(fwd_bwd, dev, iters)})
    return {"device": device_label(dev), "B": B, "H": H, "Dh": Dh, "P": P,
            "shapes": list(shapes), "iters": iters, "rows": rows}


def markdown(result: Dict) -> str:
    lines = []
    for name, Q in dict.fromkeys((r["case"], r["Q"]) for r in result["rows"]):
        lines += [f"\n### {name}  (B={result['B']} Q={Q} H={result['H']} Dh={result['Dh']} "
                  f"S={sum(result['shapes'])} L={len(result['shapes'])} P={result['P']}, "
                  f"{result['device']})\n", "| backend | fwd ms | fwd+bwd ms |", "|---|---|---|"]
        lines += [f"| {r['backend']} | {r['fwd_ms']:.4f} | {r['fwd_bwd_ms']:.4f} |"
                  for r in result["rows"] if r["case"] == name]
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    print(markdown(run(args.device, args.iters)))


if __name__ == "__main__":
    main()
