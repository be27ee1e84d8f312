"""Host-side batch iterator with a prefetching thread; the port's copy of the
JAX package's ``data/loader.py`` for one process (shard 0 of 1).

An epoch's order is ``np.random.default_rng(seed + epoch).permutation`` when
shuffling, else the dataset's order; batches are fixed-shape dicts of numpy
arrays (``data.anet.collate_fixed``), padded to ``batch_size`` rows unless
``pad_batches`` is off, or what the caller's ``collate_fn`` makes of the
samples (raw batches: uint8 frames, kept uint8 to the card). The worker
thread only reads and collates: it makes numpy batches and never touches
torch or CUDA, so all device work stays on the caller's thread.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Iterator

import numpy as np

from .anet import collate_fixed

ARRAY_KEYS = (
    "video_tensor", "video_mask", "audio_tensor", "audio_mask", "durations", "batch_valid",
    "gt_segments", "gt_mask", "gt_labels", "cap_tokens",
)


def split_batch(batch):
    """(arrays, host metadata) split of a collated batch."""
    arrays = {k: batch[k] for k in ARRAY_KEYS if k in batch}
    meta = {k: v for k, v in batch.items() if k not in ARRAY_KEYS}
    return arrays, meta


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        pad_idx: int,
        video_rescale_len: int = 300,
        max_gt: int = 10,
        max_caption_len: int = 20,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        pad_batches: bool = True,
        num_prefetch: int = 2,
        audio_rescale_len: int = 0,
        collate_fn=None,
    ):
        """``audio_rescale_len`` > 0 collates the samples' audio features
        too (the multimodal family). ``collate_fn`` (a list of samples -> a
        batch dict or None) replaces ``collate_fixed``: raw batches go
        through ``data.raw_anet.collate_raw``, which pads no batch."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.pad_idx = pad_idx
        self.video_rescale_len = video_rescale_len
        self.max_gt = max_gt
        self.max_caption_len = max_caption_len
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.pad_batches = pad_batches
        self.num_prefetch = num_prefetch
        self.audio_rescale_len = audio_rescale_len
        self.collate_fn = collate_fn
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return np.random.default_rng(self.seed + self.epoch).permutation(n)
        return np.arange(n)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _produce(self) -> Iterator[dict]:
        idxs = self._indices()
        for start in range(0, len(idxs), self.batch_size):
            chunk = idxs[start: start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            samples = [self.dataset[int(i)] for i in chunk]
            if self.collate_fn is not None:
                batch = self.collate_fn(samples)
            else:
                batch = collate_fixed(
                    samples, self.pad_idx, self.video_rescale_len, self.max_gt,
                    self.max_caption_len,
                    pad_to_batch=self.batch_size if self.pad_batches else 0,
                    audio_rescale_len=self.audio_rescale_len)
            if batch is not None:
                yield batch

    def __iter__(self):
        """Batches from a background thread that keeps up to
        ``num_prefetch`` of them ready. An exception in the thread is raised
        here; leaving the loop early stops the thread."""
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.num_prefetch)
        stop = threading.Event()
        done = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def worker():
            try:
                for batch in self._produce():
                    if not put(batch):
                        return
            except Exception as e:  # handed to the consumer, which raises it
                put(e)
                return
            put(done)

        t = threading.Thread(target=worker, name="DataLoader", daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=10)
