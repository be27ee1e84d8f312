"""Host-side batch assembly; the port's copy of what it needs from the JAX
``data/anet.py`` (``nearest_resize``, the numpy path of ``collate_fixed``),
and a synthetic source of training batches in the shape of the JAX
package's synthetic world (``__graft_entry__._synth_batch``)."""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np


def nearest_resize(x: np.ndarray, new_size: int, axis: int = 1) -> np.ndarray:
    """``F.interpolate(mode='nearest')`` semantics along ``axis``:
    out[i] = in[floor(i * T_in / T_out)]."""
    t_in = x.shape[axis]
    idx = (np.arange(new_size) * t_in) // new_size
    return np.take(x, idx, axis=axis)


def collate_fixed(samples: List[Optional[Dict]], pad_idx: int, video_rescale_len: int = 300,
                  max_gt: int = 10, max_caption_len: int = 20) -> Optional[Dict]:
    """Fixed-shape batch dict of numpy arrays; ``None`` samples are dropped.

    Each sample: video_feature (T_i, D), duration (s), gt_timestamps [n, 2]
    seconds, action_labels [n], caption_tokens [n lists of ids], key.
    Returns video_tensor (B, T, D) f32, video_mask (B, T) bool True=pad,
    durations (B,), batch_valid (B,), gt_segments (B, G, 2) (center,
    length), gt_mask (B, G), gt_labels (B, G) i32, cap_tokens (B, G, Lc) i32
    (<pad> in unused slots), and the list ``keys``."""
    samples = [s for s in samples if s is not None]
    if not samples:
        return None
    B = len(samples)
    D = samples[0]["video_feature"].shape[1]
    max_len = max(s["video_feature"].shape[0] for s in samples)

    video = np.zeros((B, max_len, D), dtype=np.float32)
    mask = np.ones((B, max_len), dtype=bool)
    durations = np.ones((B,), dtype=np.float32)
    gt_segments = np.zeros((B, max_gt, 2), dtype=np.float32)
    gt_mask = np.zeros((B, max_gt), dtype=bool)
    gt_labels = np.zeros((B, max_gt), dtype=np.int32)
    cap_tokens = np.full((B, max_gt, max_caption_len), pad_idx, dtype=np.int32)
    keys = []
    for i, s in enumerate(samples):
        L = s["video_feature"].shape[0]
        video[i, :L] = s["video_feature"]
        mask[i, :L] = False
        durations[i] = s["duration"]
        n = len(s["gt_timestamps"])
        for j, ts in enumerate(s["gt_timestamps"]):
            gt_segments[i, j] = ((ts[1] + ts[0]) / (2 * s["duration"]),
                                 (ts[1] - ts[0]) / s["duration"])
        gt_mask[i, :n] = True
        gt_labels[i, :n] = s["action_labels"]
        for j, ids in enumerate(s["caption_tokens"]):
            cap_tokens[i, j, :len(ids)] = ids
        keys.append(s["key"])
    # pad to the batch max, then nearest-rescale the tensor and the mask
    video = nearest_resize(video, video_rescale_len, axis=1)
    mask = nearest_resize(mask, video_rescale_len, axis=1)
    return {
        "video_tensor": video, "video_mask": mask, "durations": durations,
        "batch_valid": np.ones((B,), dtype=bool), "gt_segments": gt_segments, "gt_mask": gt_mask,
        "gt_labels": gt_labels, "cap_tokens": cap_tokens, "keys": keys,
    }


def synthetic_samples(cfg, n: int, vocab_size: int, rng: np.random.Generator,
                      pad_idx: int = 1, bos_idx: int = 2, eos_idx: int = 3) -> List[Dict]:
    """``n`` random videos: features of 120-900 tokens, durations 10-180 s,
    1 to max_gt events of 5-30% of the duration with centres in 20-80%, and
    captions <bos> + 4..(Lc-2) words + <eos>."""
    anet = cfg.dataset.activity_net
    G, Lc, D = anet.max_gt_target_segments, anet.max_caption_len_all, cfg.dvc.detr.feature_dim
    out = []
    for i in range(n):
        T = int(rng.integers(120, 901))
        dur = float(rng.uniform(10, 180))
        k = int(rng.integers(1, G + 1))
        centers = rng.uniform(0.2, 0.8, size=k)
        lengths = rng.uniform(0.05, 0.3, size=k)
        stamps = [[max(0.0, (c - l / 2) * dur), min(dur, (c + l / 2) * dur)]
                  for c, l in zip(centers, lengths)]
        caps = []
        for _ in range(k):
            words = rng.integers(4, vocab_size, size=int(rng.integers(4, Lc - 1)))
            caps.append([bos_idx, *words.tolist(), eos_idx][:Lc])
        out.append({
            "key": f"synthetic_{i:06d}",
            "video_feature": rng.normal(size=(T, D)).astype(np.float32),
            "duration": dur,
            "gt_timestamps": stamps,
            "action_labels": [0] * k,
            "caption_tokens": caps,
        })
    return out


def synthetic_batches(cfg, batch_size: int, vocab_size: int, seed: int = 0,
                      num_batches: Optional[int] = None, pad_idx: int = 1) -> Iterator[Dict]:
    """Training batches of ``synthetic_samples`` through ``collate_fixed``,
    made from a numpy seed; endless unless ``num_batches`` is given."""
    rng = np.random.default_rng(seed)
    anet = cfg.dataset.activity_net
    i = 0
    while num_batches is None or i < num_batches:
        yield collate_fixed(synthetic_samples(cfg, batch_size, vocab_size, rng, pad_idx),
                            pad_idx, anet.video_rescale_len, anet.max_gt_target_segments,
                            anet.max_caption_len_all)
        i += 1
