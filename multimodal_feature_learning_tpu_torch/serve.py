"""Servers and serving CLI for GT-free dense video captioning.

Counterpart of the JAX repository's ``serve.py``:

* ``DVCServer``, static micro-batching: requests (one video's features and
  its duration) arrive on any thread; a worker thread collects up to
  ``batch_size`` of them or waits at most ``max_wait_ms``, nearest-rescales
  each to the model's token grid, pads the tail, runs one
  ``UnimodalDVC.forward_serve`` on the model's device, and resolves each
  request's Future to its ``k`` events.
* ``ContinuousDVCServer``, slot refill: ``batch_size`` resident slots
  advance through the caption decode ``chunk`` tokens at a time, each at
  its own cursor; between chunks the finished slots are answered and
  refilled from the queue (prefill, then a merge into the pool).
* ``main``, a Poisson load generator over the val split that prints one JSON
  row (throughput, latency percentiles, the server's counters):

    python -m multimodal_feature_learning_tpu_torch.serve [--synthetic] \\
        [--weights snapshot.npz | --resume checkpoint | --from-reference-checkpoint ref.pth \\
        [--trust-checkpoint]] [--continuous --chunk 4] \\
        [--rps 100] [--n-requests 256] [--batch-size 16] [--max-wait-ms 10] \\
        [--max-queue 0] [--faster-eval] [--device cuda|cpu] \\
        [--config-overrides a.b=value ...]

The weights: ``--resume``, else ``--from-reference-checkpoint`` (a reference
SAGA-DVC ``.pth``, ``utils/ref_bridge.py``), as in JAX, else ``--weights``;
``--weights`` beside ``--from-reference-checkpoint`` is refused.

A failed dispatch fails the futures of that batch, and the worker goes on.
"""

from __future__ import annotations

import argparse
import itertools
import json
import queue
import sys
import threading
import time
from concurrent.futures import Future
from typing import List, Optional

import numpy as np
import torch

from .data.anet import nearest_resize
from .data.vocab import Vocab
from .device import to_host
from .engine.train import TRANSFER_DTYPES
from .utils.observability import SPANS
from .utils.postprocess import captions_to_string

class DVCServer:
    """Micro-batching server over ``model.forward_serve``.

    ``model`` is a ``models.dvc.UnimodalDVC`` on its serving device (see
    ``models.dvc.build_model``). Captions come back as token-id lists, or,
    when a ``vocab`` is given, as the strings of
    ``utils.postprocess.captions_to_string``, as the JAX server gives them.

    ``faster_eval`` and ``rank`` go to ``forward_serve``. With
    ``max_queue`` > 0 a submit that finds that many requests waiting is shed:
    it raises RuntimeError and counts in ``stats["shed"]``.
    ``transfer_dtype`` "bfloat16" sends the features to the card in bf16,
    where they are upcast to f32.

    With ``utils.observability.SPANS`` recording, each request's wait from
    ``submit`` to its dispatch is a ``serve.queued`` span (ident: the
    request's and the dispatch's numbers), and the worker records
    ``serve.collect`` (blocked on the queue, then the fill wait),
    ``serve.assemble``, ``serve.dispatch`` (ident: its number) around
    ``serve.to_device``, the model's spans and ``serve.to_host``, and
    ``serve.answer`` (the events and ``set_result``, with the done-callbacks
    it runs)."""

    def __init__(self, model, vocab: Optional[Vocab] = None, batch_size: int = 16,
                 max_wait_ms: float = 10.0, faster_eval: bool = False,
                 rank: str = "stability", max_queue: int = 0,
                 transfer_dtype: str = "float32"):
        self._setup(model, vocab, batch_size, max_queue, transfer_dtype)
        self.max_wait_s = max_wait_ms / 1000.0
        self.faster_eval = faster_eval
        self.rank = rank
        # warm-up at serving shapes: builds the kernels and allocator pools
        # before the first request is timed
        B, T, D = batch_size, self.rescale_len, self.feature_dim
        self._step(np.zeros((B, T, D), np.float32), np.ones((B,), np.float32))
        self._start()

    def _setup(self, model, vocab, batch_size, max_queue, transfer_dtype):
        if transfer_dtype not in TRANSFER_DTYPES:
            raise ValueError(f"transfer_dtype must be one of {tuple(TRANSFER_DTYPES)}, "
                             f"got {transfer_dtype!r}")
        self.model = model
        self.vocab = vocab
        self.batch_size = batch_size
        self.transfer_dtype = TRANSFER_DTYPES[transfer_dtype]
        self.device = next(model.parameters()).device
        self.rescale_len = model.video_rescale_len
        self.feature_dim = model.proposal.base_encoder.input_proj[0].in_channels
        self.stats = {"dispatches": 0, "filled": 0, "step_s": 0.0, "errors": 0, "shed": 0}
        self._request_ids = itertools.count()
        self._dispatch_ids = itertools.count()
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._closed = False
        # guards _closed and the enqueue, so no submit lands after the
        # shutdown sentinel and strands its Future
        self._close_lock = threading.Lock()

    def _start(self):
        self._worker = threading.Thread(target=self._serve_loop, daemon=True)
        self._worker.start()

    # -- client API -------------------------------------------------------

    def submit(self, features: np.ndarray, duration: float) -> Future:
        """features (T, feature_dim), duration in seconds. Returns a Future
        resolving to a list of k events {"segment": (start_s, end_s),
        "caption": token ids or str, "score": float}."""
        feats = np.asarray(features, np.float32)
        if feats.ndim != 2 or feats.shape[1] != self.feature_dim or feats.shape[0] < 1:
            raise ValueError(f"features must be (T, {self.feature_dim}); got {feats.shape}")
        if not np.isfinite(duration) or duration <= 0:
            raise ValueError(f"duration must be a positive number of seconds; got {duration}")
        fut: Future = Future()
        # (request number, submit time) for the request's serve.queued span
        queued = (next(self._request_ids), SPANS.clock()) if SPANS.on else None
        with self._close_lock:
            if self._closed:
                raise RuntimeError("server closed")
            try:
                self._q.put_nowait((feats, float(duration), fut, queued))
            except queue.Full:
                self.stats["shed"] += 1
                raise RuntimeError(
                    f"server overloaded: queue at max_queue={self._q.maxsize}") from None
        return fut

    def close(self):
        """Stop taking requests, serve the ones taken, stop the worker, and
        fail any request still queued."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)
        self._worker.join()
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item[2].done():
                item[2].set_exception(RuntimeError("server closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- internals --------------------------------------------------------

    def _ingest(self, features: np.ndarray) -> np.ndarray:
        """Nearest rescale of one request to the model's token grid, as the
        collate does."""
        return nearest_resize(features[None], self.rescale_len, axis=1)[0]

    def _to_device(self, video: np.ndarray) -> torch.Tensor:
        """The features on the card, crossing in ``transfer_dtype``, as f32."""
        video = torch.from_numpy(video)
        if self.transfer_dtype is not None:
            video = video.to(self.transfer_dtype)
        return video.to(self.device).float()

    def _step(self, video: np.ndarray, durations: np.ndarray):
        B, T = video.shape[:2]
        dev = self.device
        with SPANS.span("serve.to_device"):
            inputs = (self._to_device(video),
                      torch.zeros((B, T), dtype=torch.bool, device=dev),  # all tokens valid
                      torch.from_numpy(durations).to(dev))
        out = self.model.forward_serve(*inputs, faster_eval=self.faster_eval, rank=self.rank)
        keys = ("segments", "captions", "k", "scores")
        with SPANS.span("serve.to_host"):
            return dict(zip(keys, to_host(*(out[k] for k in keys))))

    def _assemble(self, items, slots):
        """The batch's features and durations, with each item's ingest in
        ``slots``; an item whose ingest raises fails its own future and
        leaves its slot zero. Returns (video, durations, the slots filled)."""
        B, T, D = self.batch_size, self.rescale_len, self.feature_dim
        video = np.zeros((B, T, D), np.float32)
        durations = np.ones((B,), np.float32)
        filled = []
        for (feats, dur, fut, _), slot in zip(items, slots):
            try:
                video[slot] = self._ingest(feats)
            except Exception as e:  # noqa: BLE001 - handed to the waiting caller
                self.stats["errors"] += 1
                fut.set_exception(e)
                continue
            durations[slot] = dur
            filled.append(slot)
        return video, durations, filled

    def _events(self, i: int, k: int, caption_rows, segments, scores):
        ids = caption_rows[:k].tolist()
        captions = captions_to_string(ids, self.vocab) if self.vocab else ids
        return [{"segment": (float(segments[i, j, 0]), float(segments[i, j, 1])),
                 "caption": captions[j], "score": float(scores[i, j])} for j in range(k)]

    def _collect(self):
        """Block for a request, then take more until the batch is full or
        ``max_wait_s`` has passed. Returns (batch, closing): ``closing`` once
        the shutdown sentinel is taken, with the batch taken before it."""
        item = self._q.get()
        if item is None:
            return [], True
        batch = [item]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                return batch, True
            batch.append(nxt)
        return batch, False

    def _serve_loop(self):
        closing = False
        while not closing:
            with SPANS.span("serve.collect"):
                batch, closing = self._collect()
            if batch:
                self._dispatch_safe(batch)

    def _dispatch_safe(self, batch):
        """A failed dispatch fails that batch's futures instead of killing the
        worker and stranding every later request."""
        try:
            self._dispatch(batch)
        except Exception as e:  # noqa: BLE001 - handed to the waiting callers
            self.stats["errors"] += 1
            for _, _, fut, _ in batch:
                if not fut.done():
                    fut.set_exception(e)

    def _dispatch(self, batch):
        with SPANS.span("serve.assemble"):
            video, durations, filled = self._assemble(batch, range(len(batch)))
        d = next(self._dispatch_ids)
        with SPANS.span("serve.dispatch", d) as span:
            if span is not None:
                for *_, queued in batch:
                    if queued is not None:
                        SPANS.add("serve.queued", queued[1], span.start, (queued[0], d))
            t0 = time.monotonic()
            host = self._step(video, durations)
        self.stats["dispatches"] += 1
        self.stats["filled"] += len(batch)
        self.stats["step_s"] += time.monotonic() - t0
        with SPANS.span("serve.answer"):
            for i in filled:
                k = int(host["k"][i])
                batch[i][2].set_result(self._events(i, k, host["captions"][i],
                                                    host["segments"], host["scores"]))


class ContinuousDVCServer(DVCServer):
    """Slot-refill continuous batching over ``forward_serve_prefill``,
    ``forward_serve_decode_chunk`` and ``merge_serve_slots``.

    The pool holds ``batch_size`` resident slots. Each round the worker
    admits queued requests into the free slots (one prefill of a full batch,
    then a merge that returns a new pool, so a failed admit fails only that
    wave and leaves the pool as it was), advances every active slot by
    ``chunk`` decode tokens in place, reads each video's ``done`` and
    cursor from the card (one host sync a chunk), and answers the finished
    slots (one host sync a harvest). A failed chunk fails the active slots
    and rebuilds the pool from a zero prefill; a failed rebuild counts in
    ``stats["rebuild_errors"]``. ``stats`` adds ``prefills`` and ``chunks``
    and splits ``step_s`` into ``prefill_s`` (admits: prefill and merge)
    and ``chunk_s`` (chunks and their host sync).
    Each answer equals the static server's: a video's greedy decode does
    not depend on the other rows of its batch."""

    def __init__(self, model, vocab: Optional[Vocab] = None, batch_size: int = 16,
                 chunk: int = 4, rank: str = "stability", max_queue: int = 0,
                 transfer_dtype: str = "float32"):
        self._setup(model, vocab, batch_size, max_queue, transfer_dtype)
        self.chunk = chunk
        self.rank = rank
        self.G = model.max_gt
        self.seq_len = model.seq_len
        self.stats.update(prefills=0, chunks=0, prefill_s=0.0, chunk_s=0.0)
        B, T, D = batch_size, self.rescale_len, self.feature_dim
        self._zero_video = np.zeros((B, T, D), np.float32)
        self._zero_mask = torch.zeros((B, T), dtype=torch.bool, device=self.device)
        self._slots: List[Optional[Future]] = [None] * B
        self._active = np.zeros(B, dtype=bool)
        # warm-up of the three programs on zero slots, which also makes the
        # resident pool
        self._ctx, self._state = self._zero_pool()
        ctx, state = self._zero_pool()
        self._ctx, self._state = model.merge_serve_slots(
            self._ctx, self._state, ctx, state, self._on_device(np.zeros(B, bool)), self.G)
        self._decode_chunk()
        self._start()

    # -- internals ----------------------------------------------------------

    def _prefill(self, video: np.ndarray, durations: np.ndarray):
        return self.model.forward_serve_prefill(
            self._to_device(video), self._zero_mask,
            torch.from_numpy(durations).to(self.device), rank=self.rank)

    def _zero_pool(self):
        return self._prefill(self._zero_video, np.ones((self.batch_size,), np.float32))

    def _on_device(self, mask: np.ndarray) -> torch.Tensor:
        return torch.tensor(mask, device=self.device)

    def _decode_chunk(self) -> np.ndarray:
        """Advance the active slots by one chunk; returns, on the host, which
        slots' videos are finished (every row done, or the cursor at the
        end)."""
        self.model.forward_serve_decode_chunk(self._ctx, self._state,
                                              self._on_device(self._active), self.chunk)
        done = self._state["done"].view(self.batch_size, self.G).all(dim=1) | (
            self._state["t"] >= self.seq_len)
        return to_host(done)[0]

    def _serve_loop(self):
        B = self.batch_size
        closing = False
        while True:
            free = [i for i in range(B) if not self._active[i]]
            new_items = []
            if free and not closing:
                if not self._active.any():
                    item = self._q.get()  # idle: block for work
                    if item is None:
                        return
                    new_items.append(item)
                while len(new_items) < len(free):
                    try:
                        nxt = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is None:
                        closing = True
                        break
                    new_items.append(nxt)
            elif closing and not self._active.any():
                return
            if new_items:
                self._admit(new_items, free)
            if not self._active.any():
                continue

            t0 = time.monotonic()
            try:
                finished = self._decode_chunk()
            except Exception as e:  # noqa: BLE001 - handed to the waiting callers
                self._fail_slots(np.flatnonzero(self._active), e)
                continue
            self.stats["chunks"] += 1
            self.stats["chunk_s"] += time.monotonic() - t0
            self.stats["step_s"] += time.monotonic() - t0
            finished &= self._active
            if finished.any():
                self._harvest(np.flatnonzero(finished))

    def _admit(self, items, free):
        video, durations, filled = self._assemble(items, free)
        replace = np.zeros(self.batch_size, dtype=bool)
        replace[filled] = True
        t0 = time.monotonic()
        try:
            ctx, state = self._prefill(video, durations)
            self._ctx, self._state = self.model.merge_serve_slots(
                self._ctx, self._state, ctx, state, self._on_device(replace), self.G)
        except Exception as e:  # noqa: BLE001 - the pool is untouched: fail this wave only
            self.stats["errors"] += 1
            for (_, _, fut, _), slot in zip(items, free):
                if slot in filled:
                    fut.set_exception(e)
        else:
            for (_, _, fut, _), slot in zip(items, free):
                if slot in filled:
                    self._slots[slot] = fut
                    self._active[slot] = True
        self.stats["prefills"] += 1
        self.stats["prefill_s"] += time.monotonic() - t0
        self.stats["step_s"] += time.monotonic() - t0
        self.stats["filled"] += len(items)
        self.stats["dispatches"] += 1

    def _harvest(self, slots):
        G, L = self.G, self.seq_len
        captions, segments, ks, scores = to_host(
            self._state["captions"], self._ctx["segments"], self._ctx["k"],
            self._ctx["scores"])
        captions = captions.reshape(self.batch_size, G, L)
        eos, pad = self.model.eos_idx, self.model.pad_idx
        for slot in slots:
            fut = self._slots[slot]
            self._slots[slot] = None
            self._active[slot] = False
            k = int(ks[slot])
            rows = captions[slot, :k]
            # the trailing token greedy_decode appends: <pad> after an <eos>,
            # else <eos>
            tail = np.where((rows == eos).any(axis=1), pad, eos).astype(rows.dtype)
            rows = np.concatenate([rows, tail[:, None]], axis=1)
            fut.set_result(self._events(slot, k, rows, segments, scores))

    def _fail_slots(self, slots, exc):
        self.stats["errors"] += 1
        for slot in slots:
            fut = self._slots[slot]
            self._slots[slot] = None
            self._active[slot] = False
            if fut is not None and not fut.done():
                fut.set_exception(exc)
        # the chunk updates the pool in place, so a failed one may have left
        # it half written: rebuild it from a zero prefill (its requests were
        # just failed)
        try:
            self._ctx, self._state = self._zero_pool()
        except Exception as e:  # noqa: BLE001 - the next dispatch surfaces it again
            self.stats["rebuild_errors"] = self.stats.get("rebuild_errors", 0) + 1
            print(f"serve: rebuilding the resident pool failed ({e!r}); it is tried again "
                  "after the next failed chunk", file=sys.stderr)


# -- load generator ---------------------------------------------------------


def parse_args(argv=None):
    from .main import add_reference_flags

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--resume", default=None, help="a checkpoint of the port's training CLI")
    add_reference_flags(p)
    p.add_argument("--weights", default=None,
                   help="flat flax snapshot (.npz) to load strictly")
    p.add_argument("--synthetic", action="store_true",
                   help="write and read a small synthetic world (no data needed)")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--max-wait-ms", type=float, default=10.0)
    p.add_argument("--max-queue", type=int, default=0,
                   help="shed submits beyond this queue depth (0 = unbounded)")
    p.add_argument("--continuous", action="store_true",
                   help="slot-refill continuous batching: finished slots are answered "
                        "and refilled between decode chunks")
    p.add_argument("--chunk", type=int, default=4,
                   help="decode tokens a dispatch under --continuous")
    p.add_argument("--rps", type=float, default=100.0,
                   help="Poisson arrival rate of the load generator")
    p.add_argument("--n-requests", type=int, default=256)
    p.add_argument("--faster-eval", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--config-overrides", nargs="*", default=[],
                   help="dotted config overrides, e.g. dvc.d_model=256")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Serves ``--n-requests`` val videos, offered at ``--rps`` Poisson
    arrivals (numpy seed 0), through the static or the continuous server;
    prints the JSON row and returns it."""
    from .config import apply_overrides, load_config, recompute_losses
    from .data.anet import build_dataset
    from .device import resolve_device
    from .engine.state import load_model_weights
    from .main import import_reference, make_synthetic_world, refuse_two_sources
    from .models.dvc import build_model
    from .utils.weights import load_flax_params, load_npz

    args = parse_args(argv)
    refuse_two_sources(args)
    if args.continuous and args.faster_eval:
        raise SystemExit("--faster-eval is a fill-all-slots batch-eval semantic; it has no "
                         "meaning under --continuous")
    dev = resolve_device(args.device)
    cfg = apply_overrides(load_config(), args.config_overrides)
    if args.synthetic:
        # after the overrides: the features are written at their feature_dim
        cfg = make_synthetic_world(cfg)
    recompute_losses(cfg)

    np.random.seed(cfg.seed)
    val_ds, vocab = build_dataset("val", cfg)
    model = build_model(cfg, len(vocab), vocab.pad_idx, vocab.bos_idx, vocab.eos_idx,
                        device=dev, seed=cfg.seed)
    if args.resume:
        load_model_weights(args.resume, model)
    elif args.from_reference_checkpoint:
        import_reference(args, model, cfg)
    elif args.weights:
        load_flax_params(model, load_npz(args.weights))

    if args.continuous:
        server = ContinuousDVCServer(model, vocab, batch_size=args.batch_size,
                                     chunk=args.chunk, max_queue=args.max_queue,
                                     transfer_dtype=cfg.transfer_dtype)
    else:
        server = DVCServer(model, vocab, batch_size=args.batch_size,
                           max_wait_ms=args.max_wait_ms, faster_eval=args.faster_eval,
                           max_queue=args.max_queue, transfer_dtype=cfg.transfer_dtype)

    reqs = []
    for i in range(args.n_requests):
        sample = val_ds[i % len(val_ds)]
        if sample is not None:
            reqs.append((sample["video_feature"], float(sample["duration"])))

    rng = np.random.default_rng(0)
    done: List[float] = []
    lock = threading.Lock()
    pending = []
    shed = 0
    try:
        t_start = time.monotonic()
        for feats, dur in reqs:
            t0 = time.monotonic()
            try:
                fut = server.submit(feats, dur)
            except RuntimeError:
                shed += 1  # --max-queue: the request is refused, the generator goes on
            else:
                def _record(_f, t0=t0):
                    with lock:
                        done.append(time.monotonic() - t0)

                fut.add_done_callback(_record)
                pending.append(fut)
            time.sleep(float(rng.exponential(1.0 / args.rps)))
        for fut in pending:
            fut.result()
        t_done = time.monotonic()
    finally:
        server.close()
    stats = dict(server.stats)

    lat_ms = np.array(sorted(done)) * 1000.0
    result = {
        "metric": "dvc_serving",
        "mode": "continuous" if args.continuous else "static",
        "requests": len(done),
        "offered_rps": args.rps,
        "achieved_rps": len(done) / (t_done - t_start),
        "latency_p50_ms": float(np.percentile(lat_ms, 50)),
        "latency_p95_ms": float(np.percentile(lat_ms, 95)),
        "latency_p99_ms": float(np.percentile(lat_ms, 99)),
        "batch_size": args.batch_size,
        "max_wait_ms": args.max_wait_ms,
        "backend": dev.type,
        "shed": shed,
        "dispatches": stats["dispatches"],
        "mean_batch_fill": stats["filled"] / max(stats["dispatches"], 1),
        "mean_step_ms": 1000 * stats["step_s"]
        / max(stats["dispatches"] + stats.get("chunks", 0), 1),
    }
    if args.continuous:
        result["chunks"] = stats["chunks"]
        result["chunk_size"] = args.chunk
        result["mean_prefill_ms"] = 1000 * stats["prefill_s"] / max(stats["prefills"], 1)
        result["mean_chunk_ms"] = 1000 * stats["chunk_s"] / max(stats["chunks"], 1)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
