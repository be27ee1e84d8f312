"""Host-side batch iterator with a prefetching thread; the port's copy of the
JAX package's ``data/loader.py``.

An epoch's order is ``np.random.default_rng(seed + epoch).permutation`` when
shuffling, else the dataset's order, and a data rank reads its strided part
of it, ``order[rank::world]`` (JAX's ``process_index``-strided shard; world
1 is the whole order). Every rank yields the same number of batches: a
rank whose part is one video short pads it with one dummy row, so the
ranks' collectives stay in step. The dummy row is the row ``collate_fixed``
pads a batch with (no key, ``batch_valid`` and ``gt_mask`` False, zero
features, no ground truth, ``<pad>`` captions), so it adds nothing to a
loss or a normaliser. Batches are fixed-shape dicts of numpy
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


# the values of collate_fixed's padding rows; cap_tokens takes <pad>
_DUMMY_FILL = {
    "video_tensor": 0, "video_mask": False, "audio_tensor": 0, "audio_mask": False,
    "durations": 1, "batch_valid": False, "gt_segments": 0, "gt_mask": False,
    "gt_labels": 0,
}


def _dummy_tail(batch: dict, n_real: int, pad_idx: int) -> dict:
    """``batch`` with its rows from ``n_real`` on made dummy rows, as
    ``collate_fixed`` pads a batch."""
    for k, v in (*_DUMMY_FILL.items(), ("cap_tokens", pad_idx)):
        if k in batch:
            batch[k] = batch[k].copy()
            batch[k][n_real:] = v
    for k in ("keys", "raw_captions", "gt_timestamps"):
        if k in batch:
            batch[k] = batch[k][:n_real]
    return batch


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
        rank: int = 0,
        world: int = 1,
    ):
        """``audio_rescale_len`` > 0 collates the samples' audio features
        too (the multimodal family). ``collate_fn`` (a list of samples -> a
        batch dict or None) replaces ``collate_fixed``: raw batches go
        through ``data.raw_anet.collate_raw``, which pads no batch.
        ``rank`` / ``world``: this data rank's strided shard of the epoch
        (``parallel.mesh.axis_rank_size(mesh, "data")``)."""
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
        self.rank, self.world = rank, world
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        """This rank's part of the epoch's order, without its padding."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng(self.seed + self.epoch).permutation(n)
        return order[self.rank::self.world]

    def _shard_len(self) -> int:
        """Length of every rank's part, the padded ones included."""
        return -(-len(self.dataset) // self.world)

    def __len__(self):
        n = self._shard_len()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _produce(self) -> Iterator[dict]:
        real = self._indices()
        n, n_real = self._shard_len(), len(real)
        # a part one video short takes a dummy row; its sample (video 0)
        # only gives a batch of dummy rows its shapes
        idxs = np.concatenate([real, np.zeros(n - n_real, real.dtype)])
        for start in range(0, n, self.batch_size):
            chunk = idxs[start: start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            samples = [self.dataset[int(i)] for i in chunk]
            here = min(max(n_real - start, 0), len(chunk))  # real rows of the chunk
            if self.collate_fn is not None:
                batch = self.collate_fn(samples)
            else:
                # collate_fixed pads past the real rows itself, with the
                # features of the real rows alone deciding their resize
                batch = collate_fixed(
                    samples[:here] or samples, self.pad_idx, self.video_rescale_len,
                    self.max_gt, self.max_caption_len,
                    pad_to_batch=self.batch_size if self.pad_batches else len(chunk),
                    audio_rescale_len=self.audio_rescale_len)
            if batch is not None and here < len(chunk):
                batch = _dummy_tail(batch, here, self.pad_idx)
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
