"""Static micro-batching server for GT-free dense video captioning.

Counterpart of the JAX repository's ``serve.py::DVCServer``: requests (one
video's features and its duration) arrive on any thread; a worker thread
collects up to ``batch_size`` of them or waits at most ``max_wait_ms``,
nearest-rescales each to the model's token grid, pads the tail, runs one
``UnimodalDVC.forward_serve`` on the model's device, and resolves each
request's Future to its ``k`` events.

A failed dispatch fails the futures of that batch, and the worker goes on.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from .data.anet import nearest_resize
from .data.vocab import Vocab
from .utils.postprocess import captions_to_string


class DVCServer:
    """Micro-batching server over ``model.forward_serve``.

    ``model`` is a ``models.dvc.UnimodalDVC`` on its serving device (see
    ``models.dvc.build_model``). Captions come back as token-id lists, or,
    when a ``vocab`` is given, as the strings of
    ``utils.postprocess.captions_to_string``, as the JAX server gives them."""

    def __init__(self, model, vocab: Optional[Vocab] = None, batch_size: int = 16,
                 max_wait_ms: float = 10.0):
        self.model = model
        self.vocab = vocab
        self.batch_size = batch_size
        self.max_wait_s = max_wait_ms / 1000.0
        self.device = next(model.parameters()).device
        self.rescale_len = model.video_rescale_len
        self.feature_dim = model.proposal.base_encoder.input_proj[0].in_channels
        self.stats = {"dispatches": 0, "filled": 0, "step_s": 0.0, "errors": 0}
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        # guards _closed and the enqueue, so no submit lands after the
        # shutdown sentinel and strands its Future
        self._close_lock = threading.Lock()

        # warm-up at serving shapes: builds the kernels and allocator pools
        # before the first request is timed
        B, T, D = batch_size, self.rescale_len, self.feature_dim
        self._step(np.zeros((B, T, D), np.float32), np.ones((B,), np.float32))

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
        with self._close_lock:
            if self._closed:
                raise RuntimeError("server closed")
            self._q.put((feats, float(duration), fut))
        return fut

    def close(self):
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)
        self._worker.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- internals --------------------------------------------------------

    def _step(self, video: np.ndarray, durations: np.ndarray):
        B, T = video.shape[:2]
        dev = self.device
        out = self.model.forward_serve(
            torch.from_numpy(video).to(dev),
            torch.zeros((B, T), dtype=torch.bool, device=dev),  # all tokens valid
            torch.from_numpy(durations).to(dev))
        return {k: out[k].cpu().numpy() for k in ("segments", "captions", "k", "scores")}

    def _serve_loop(self):
        while True:
            item = self._q.get()
            if item is None:
                return
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
                    self._dispatch_safe(batch)
                    return
                batch.append(nxt)
            self._dispatch_safe(batch)

    def _dispatch_safe(self, batch):
        """A failed dispatch fails that batch's futures instead of killing the
        worker and stranding every later request."""
        try:
            self._dispatch(batch)
        except Exception as e:  # noqa: BLE001 - handed to the waiting callers
            self.stats["errors"] += 1
            for _, _, fut in batch:
                if not fut.done():
                    fut.set_exception(e)

    def _dispatch(self, batch):
        B, T, D = self.batch_size, self.rescale_len, self.feature_dim
        video = np.zeros((B, T, D), np.float32)
        durations = np.ones((B,), np.float32)
        for i, (feats, dur, _) in enumerate(batch):
            video[i] = nearest_resize(feats[None], T, axis=1)[0]
            durations[i] = dur
        t0 = time.monotonic()
        host = self._step(video, durations)
        self.stats["dispatches"] += 1
        self.stats["filled"] += len(batch)
        self.stats["step_s"] += time.monotonic() - t0
        for i, (_, _, fut) in enumerate(batch):
            k = int(host["k"][i])
            ids = host["captions"][i, :k].tolist()
            captions = captions_to_string(ids, self.vocab) if self.vocab else ids
            events = [{
                "segment": (float(host["segments"][i, j, 0]),
                            float(host["segments"][i, j, 1])),
                "caption": captions[j],
                "score": float(host["scores"][i, j]),
            } for j in range(k)]
            fut.set_result(events)
