"""Device time of the MSDA kernels (K1 forward, K2 backward) and of the
matcher kernel (K6) on the card, for this checkout and, in turns, for
another one.

    python3 -m multimodal_feature_learning_tpu_torch.tools.msda_device_time \
        [--against DIR] [--turns 2] [--in-step] [--cases NAME,...] [--out FILE]

For each case (the flagship's encoder call Q=282 and decoder call Q=20 at
B=16, S=563, H=8, Dh=64, L=P=4; and a long pyramid (1200, 600, 300, 150)
with the sparse encoder's Q=1126 at B=2, which takes the kernels' chunked
route; ``--cases`` picks others by name from CASES, FAMILY_CALLS and
RAW_CALLS) and each kernel, K1 and K2 in f32 and bf16, four times in
milliseconds:
- ``graph_ms``: one wrapper call replayed from a CUDA graph of 50, the
  kernel's device time with the host out of the way (for K2 of a checkout
  whose wrapper zeroes dvalue first, that memset is in it);
- ``kernel_ms``: the kernel's own time in torch.profiler, inputs warm in L2;
- ``cold_kernel_ms``: the same with 64 MB written before each call, so the
  inputs come from device memory;
- ``eager_ms``: CUDA events around 50 eager wrapper calls (host-paced where
  a launch takes longer to issue than to run).
The case ``hungarian`` (K6_CASES, by name in ``--cases``) times K6 on the
flagship's matching (96 problems of 20 queries x 10 GT slots, random costs)
the same four ways, and adds ``host_us``: the median host microseconds of
200 calls of ``ops/hungarian.py::batched_hungarian_torch`` without a
synchronise.

``--against DIR`` loads the port's package of another checkout under
another name (each checkout builds its own kernels into its own
``build/kernels/``) and measures both in turns: this, other, other, this
for two turns. ``--in-step`` adds, per checkout and turn, K1's device time
in one profiled ``forward_serve`` and K1's and K2's in one profiled train
step of the full-width flagship with the weights of
``snapshots/conv_e79.npz`` (and K6's, in µs), and the wall ms a step of
STEP_TIMES train steps after it (B=16, dropout on). One JSON line per row; ``--out`` also
writes them to a file.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, List

import torch

from .profile_msda import inputs
from .timing import device_ms, graph_call_ms, profiled_kernel_ms

PACKAGE = "multimodal_feature_learning_tpu_torch"
ROOT = Path(__file__).resolve().parents[2]
SNAPSHOT = ROOT / "snapshots" / "conv_e79.npz"
FLAGSHIP = (300, 150, 75, 38)
LONG_PYRAMID = (1200, 600, 300, 150)
# (name, B, Q, level lengths); H=8, Dh=64, P=4 throughout
CASES = (("encoder", 16, 282, FLAGSHIP), ("decoder", 16, 20, FLAGSHIP),
         ("long_pyramid", 2, 1126, LONG_PYRAMID))
AUDIO = (50, 25, 13, 7)  # pyramid_shapes(50, 4): the audio features' pyramid
# the calls of the dense and the multimodal families at full width that the
# flagship's CASES do not already hold (the sparse multimodal encoder's video
# self-attention is the flagship encoder's call, its decoder's video
# cross-attention the flagship decoder's): (name, B, Q, the value's level
# lengths); the queries of a cross-modal call come from the other pyramid
FAMILY_CALLS = (
    ("dense_encoder", 16, 563, FLAGSHIP),     # every video token a query
    ("mm_audio_self", 16, 48, AUDIO),         # int(95 * 0.5) + 1 sparse audio tokens
    ("mm_v2a", 16, 282, AUDIO),               # sparse video tokens sample the audio
    ("mm_a2v", 16, 48, FLAGSHIP),             # sparse audio tokens sample the video
    ("mm_decoder_audio", 16, 20, AUDIO),      # the decoder's queries over the audio
    ("mm_dense_audio_self", 16, 95, AUDIO),
    ("mm_dense_v2a", 16, 563, AUDIO),
    ("mm_dense_a2v", 16, 95, FLAGSHIP),
)
RAW_AUDIO = (93, 47, 24, 12)  # pyramid_shapes(93, 4): the AST tokens' pyramid
# the calls of the raw multimodal family at full width (93 AST tokens of 128
# mels x 64 frames) that FAMILY_CALLS and CASES do not hold
RAW_CALLS = (
    ("raw_audio_self", 16, 89, RAW_AUDIO),     # int(176 * 0.5) + 1 sparse audio tokens
    ("raw_v2a", 16, 282, RAW_AUDIO),           # sparse video tokens sample the audio
    ("raw_a2v", 16, 89, FLAGSHIP),             # sparse audio tokens sample the video
    ("raw_decoder_audio", 16, 20, RAW_AUDIO),  # the decoder's queries over the audio
)
# (name, problems, queries, GT slots) of K6: the flagship's training
# matching, 6 decoder layers x B=16
K6_CASES = (("hungarian", 96, 20, 10),)
FLUSH_BYTES = 64 << 20  # more than the H100's 50 MB L2
STEP_TIMES = 6  # train steps timed a checkout and turn by --in-step


def load_checkout(root: Path, alias: str):
    """The port's package of the checkout at ``root``, imported under the
    name ``alias`` (its modules import each other relatively, so it loads
    beside this one)."""
    if alias in sys.modules:
        return sys.modules[alias]
    pkg_dir = Path(root).resolve() / PACKAGE
    spec = importlib.util.spec_from_file_location(
        alias, pkg_dir / "__init__.py", submodule_search_locations=[str(pkg_dir)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return module


def call_times(fn, name: str, dev) -> Dict[str, float]:
    """The four times (ms) of one wrapper call ``fn`` whose kernel's name
    contains ``name``: ``graph_ms``, ``kernel_ms``, ``cold_kernel_ms`` and
    ``eager_ms``, as the module's docstring defines them."""
    flush_buf = torch.empty(FLUSH_BYTES // 4, device=dev)
    kernel_ms, _ = profiled_kernel_ms(fn, dev, name)
    cold_ms, _ = profiled_kernel_ms(fn, dev, name, flush=lambda: flush_buf.fill_(1.0))
    return {"graph_ms": graph_call_ms(fn, dev), "kernel_ms": kernel_ms,
            "cold_kernel_ms": cold_ms, "eager_ms": device_ms(fn, dev, 50)}


def kernel_rows(msda, dev, cases=CASES, H: int = 8, Dh: int = 64, P: int = 4) -> List[Dict]:
    """The four times of each kernel on each case, with ``msda`` a checkout's
    ``ops.msda`` module."""
    rows = []
    for case, B, Q, shapes in cases:
        value, loc, aw = inputs(B, Q, H, Dh, shapes, P, dev, seed=Q)
        g = torch.randn((B, Q, H * Dh), generator=torch.Generator(device=dev).manual_seed(Q),
                        device=dev)
        calls = [("msda_fwd", "float32", lambda v=value: msda.MSDA_FWD(v, shapes, loc, aw)),
                 ("msda_fwd", "bfloat16",
                  lambda v=value.to(torch.bfloat16): msda.MSDA_FWD(v, shapes, loc, aw)),
                 ("msda_bwd", "float32", lambda: msda.MSDA_BWD(value, shapes, loc, aw, g)),
                 ("msda_bwd", "bfloat16",
                  lambda v=value.to(torch.bfloat16), gb=g.to(torch.bfloat16):
                  msda.MSDA_BWD(v, shapes, loc, aw, gb))]
        for name, dtype, fn in calls:
            rows.append({"kernel": name, "case": case, "B": B, "Q": Q, "shapes": list(shapes),
                         "dtype": dtype, **call_times(fn, name, dev)})
        del value, loc, aw, g
    return rows


def k6_rows(hungarian, dev, cases=K6_CASES) -> List[Dict]:
    """The four times of K6 and the wrapper's host µs a call on each case,
    with ``hungarian`` a checkout's ``ops.hungarian`` module: random normal
    costs, about 60% of the slots valid (one at least; numpy seed 0)."""
    import time

    import numpy as np

    rows = []
    for case, P, Q, G in cases:
        rng = np.random.default_rng(0)
        valid = rng.random((P, G)) < 0.6
        valid[np.arange(P), rng.integers(0, G, P)] = True
        cost = torch.from_numpy(rng.normal(size=(P, Q, G)).astype(np.float32)).to(dev)
        valid = torch.from_numpy(valid).to(dev)
        call = lambda: hungarian.HUNGARIAN(cost, valid)  # noqa: E731
        host = []
        for _ in range(200):
            t0 = time.perf_counter()
            hungarian.batched_hungarian_torch(cost, valid)
            host.append(1e6 * (time.perf_counter() - t0))
        torch.cuda.synchronize(dev)
        rows.append({"kernel": "hungarian", "case": case, "P": P, "Q": Q, "G": G,
                     **call_times(call, "hungarian", dev), "host_us": sorted(host)[100]})
    return rows


def in_step_rows(pkg, dev, batch: int = 16) -> Dict:
    """K1's device ms in one profiled forward_serve of a batch, and K1's and
    K2's in one profiled train step, of the flagship built by ``pkg`` (a
    checkout's package) with the conv_e79 weights; then the wall ms a step
    of STEP_TIMES train steps, each on its own batch."""
    import time

    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    config = importlib.import_module(f"{pkg.__name__}.config")
    dvc = importlib.import_module(f"{pkg.__name__}.models.dvc")
    weights = importlib.import_module(f"{pkg.__name__}.utils.weights")
    criterion_mod = importlib.import_module(f"{pkg.__name__}.models.criterion")
    state_mod = importlib.import_module(f"{pkg.__name__}.engine.state")
    train_mod = importlib.import_module(f"{pkg.__name__}.engine.train")
    anet = importlib.import_module(f"{pkg.__name__}.data.anet")

    cfg = config.load_config()
    cfg.use_differentiable_mask = False
    config.recompute_losses(cfg)
    flat = weights.load_npz(str(SNAPSHOT))
    vocab_size = int(flat["BF16||caption||params||head||bias"].shape[0])
    model = dvc.build_model(cfg, vocab_size, device=dev)
    weights.load_flax_params(model, flat)

    def profiled(fn) -> Dict[str, float]:
        fn()
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize(dev)
        ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        return {k: sum(e.self_device_time_total for e in ev if k in e.key) / 1e3
                for k in ("msda_fwd", "msda_bwd", "hungarian")}

    rng = np.random.default_rng(0)
    video = torch.from_numpy(rng.normal(size=(batch, model.video_rescale_len,
                                              cfg.dvc.detr.feature_dim)).astype(np.float32)).to(dev)
    mask = torch.zeros(video.shape[:2], dtype=torch.bool, device=dev)
    durs = torch.from_numpy(rng.uniform(10, 180, size=batch).astype(np.float32)).to(dev)
    with torch.no_grad():
        serve = profiled(lambda: model.forward_serve(video, mask, durs))
    criterion, weight_dict = criterion_mod.build_criterion(cfg, model.pad_idx)
    state = state_mod.create_train_state(cfg, model, steps_per_epoch=1000)
    step = train_mod.make_train_step(criterion, weight_dict, seed=cfg.seed)
    batches = [train_mod.batch_to_device(b, dev) for b in anet.synthetic_batches(
        cfg, batch, vocab_size, seed=0, num_batches=STEP_TIMES + 1)]
    train = profiled(lambda: step(state, batches[0]))
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for tb in batches[1:]:
        step(state, tb)
    torch.cuda.synchronize(dev)
    step_ms = 1e3 * (time.perf_counter() - t0) / STEP_TIMES
    del model, state, batches
    torch.cuda.empty_cache()
    return {"serve_msda_fwd_ms": serve["msda_fwd"], "train_msda_fwd_ms": train["msda_fwd"],
            "train_msda_bwd_ms": train["msda_bwd"],
            "train_hungarian_us": 1e3 * train["hungarian"], "train_step_ms": step_ms}


def run(against=None, turns: int = 2, in_step: bool = False, cases=CASES, emit=print) -> List[Dict]:
    dev = torch.device("cuda")
    if not torch.cuda.is_available():
        raise RuntimeError("msda_device_time measures on the card; no CUDA device here")
    checkouts = [("this", load_checkout(ROOT, "_msda_this"))]
    if against is not None:
        checkouts.append(("against", load_checkout(Path(against), "_msda_against")))
    k6_names = {c[0] for c in K6_CASES}
    msda_cases = [c for c in cases if c[0] not in k6_names]
    k6_cases = [c for c in cases if c[0] in k6_names]
    rows = []
    for turn in range(turns):
        for label, pkg in (checkouts if turn % 2 == 0 else checkouts[::-1]):
            msda = importlib.import_module(f"{pkg.__name__}.ops.msda")
            found = kernel_rows(msda, dev, msda_cases)
            if k6_cases:
                hungarian = importlib.import_module(f"{pkg.__name__}.ops.hungarian")
                found += k6_rows(hungarian, dev, k6_cases)
            if in_step:
                found.append({"kernel": "in_step", **in_step_rows(pkg, dev)})
            for row in found:
                row = {"checkout": label, "turn": turn, **row}
                emit(json.dumps(row))
                rows.append(row)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", default=None, help="root of another checkout")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--in-step", action="store_true")
    ap.add_argument("--cases", default=None,
                    help="comma-separated case names (default: those of CASES)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    cases = CASES
    if args.cases:
        known = {c[0]: c for c in CASES + FAMILY_CALLS + RAW_CALLS + K6_CASES}
        cases = tuple(known[name] for name in args.cases.split(","))
    print(torch.cuda.get_device_name(0), flush=True)
    lines = []

    def emit(line):
        print(line, flush=True)
        lines.append(line)

    run(args.against, args.turns, args.in_step, cases, emit=emit)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
