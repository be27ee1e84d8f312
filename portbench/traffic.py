"""The general generator of the benchmark's traffic: every mix is a data
file (``traffic/<name>.json``) of parameters that these functions read.

Every seed gets the same set of sizes and arrivals, drawn once from the
mix's ``base_seed``, in its own order. A serving mix's videos are drawn
from ``base_seed`` too (what a video holds sets how long its captions
decode); a training mix draws its features and caption words from the
run's seed (a step's work follows its shapes alone).

Serving mixes (``"kind": "serve"``): ``pool`` distinct requests, each the
features of a video of ``tokens`` [lo, hi] feature tokens and its duration
in ``duration_s`` [lo, hi] seconds (as the repository's ``chip_smoke.py``
draws them). ``"loop": "closed"`` keeps ``outstanding`` requests in flight;
``"loop": "open"`` sends Poisson arrivals at ``rate_per_s``, their gaps a
fixed set of ``gaps`` exponential draws.

Training mixes (``"kind": "train"``): ``pool`` distinct batches of
``batch_size`` synthetic videos as the port's ``data/anet.py::
synthetic_samples`` makes them (1 to max_gt events of 5-30% of the duration,
centres in 20-80%, captions of 4 to Lc-2 words), collated as its
``collate_fixed`` collates them; these two are copied here so that the
traffic stays fixed while the program changes.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

PAD, BOS, EOS = 1, 2, 3


def nearest_resize(x: np.ndarray, new_size: int, axis: int = 1) -> np.ndarray:
    """``F.interpolate(mode='nearest')`` along ``axis``: out[i] = in[floor(i
    * T_in / T_out)]."""
    t_in = x.shape[axis]
    idx = (np.arange(new_size) * t_in) // new_size
    return np.take(x, idx, axis=axis)


def serve_requests(mix: dict, seed: int, feature_dim: int) -> List[tuple]:
    """The ``pool`` requests (features (T, feature_dim) f32, duration s):
    the mix's fixed set of videos, in the seed's order. The captions a
    video decodes, and so a dispatch's decode steps, follow its features,
    so every seed serves the same videos."""
    base = np.random.default_rng(mix["base_seed"])
    n = mix["pool"]
    lengths = base.integers(mix["tokens"][0], mix["tokens"][1] + 1, size=n)
    durations = base.uniform(*mix["duration_s"], size=n)
    videos = [base.standard_normal((int(t), feature_dim), dtype=np.float32) for t in lengths]
    order = np.random.default_rng(seed).permutation(n)
    return [(videos[i], float(durations[i])) for i in order]


def arrival_gaps(mix: dict, seed: int) -> np.ndarray:
    """The open loop's gaps between arrivals (s): the mix's fixed set of
    exponential draws at ``rate_per_s``, in the seed's order."""
    base = np.random.default_rng(mix["base_seed"] + 1)
    gaps = base.exponential(1.0 / mix["rate_per_s"], size=mix["gaps"])
    return gaps[np.random.default_rng(seed).permutation(len(gaps))]


def synthetic_samples(mix: dict, n: int, feature_dim: int, vocab_size: int, max_gt: int,
                      max_caption_len: int, audio: bool, base: np.random.Generator,
                      rng: np.random.Generator) -> List[Dict]:
    """``n`` videos: sizes, events and caption lengths from ``base``,
    features and words from ``rng``."""
    out = []
    for i in range(n):
        T = int(base.integers(mix["tokens"][0], mix["tokens"][1] + 1))
        dur = float(base.uniform(*mix["duration_s"]))
        k = int(base.integers(1, max_gt + 1))
        centers = base.uniform(0.2, 0.8, size=k)
        lengths = base.uniform(0.05, 0.3, size=k)
        stamps = [[max(0.0, (c - l / 2) * dur), min(dur, (c + l / 2) * dur)]
                  for c, l in zip(centers, lengths)]
        caps = []
        for _ in range(k):
            n_words = int(base.integers(4, max_caption_len - 1))
            words = rng.integers(4, vocab_size, size=n_words)
            caps.append([BOS, *words.tolist(), EOS][:max_caption_len])
        sample = {"video_feature": rng.standard_normal((T, feature_dim), dtype=np.float32),
                  "duration": dur, "gt_timestamps": stamps, "action_labels": [0] * k,
                  "caption_tokens": caps}
        if audio:
            Ta = int(base.integers(mix["audio_tokens"][0], mix["audio_tokens"][1] + 1))
            sample["audio_feature"] = rng.standard_normal((Ta, feature_dim), dtype=np.float32)
        out.append(sample)
    return out


def _pad_and_resize(feats: List[np.ndarray], rescale_len: int):
    """Features zero-padded to the longest and masked (True = pad), both
    nearest-resized to ``rescale_len``."""
    x = np.zeros((len(feats), max(f.shape[0] for f in feats), feats[0].shape[1]),
                 dtype=np.float32)
    mask = np.ones(x.shape[:2], dtype=bool)
    for i, f in enumerate(feats):
        x[i, :f.shape[0]] = f
        mask[i, :f.shape[0]] = False
    return nearest_resize(x, rescale_len), nearest_resize(mask, rescale_len)


def collate(samples: List[Dict], video_rescale_len: int, max_gt: int, max_caption_len: int,
            audio_rescale_len: int = 0) -> Dict[str, np.ndarray]:
    """The fixed-shape batch of ``samples``, the port's training batch."""
    B = len(samples)
    video, mask = _pad_and_resize([s["video_feature"] for s in samples], video_rescale_len)
    durations = np.array([s["duration"] for s in samples], dtype=np.float32)
    gt_segments = np.zeros((B, max_gt, 2), dtype=np.float32)
    gt_mask = np.zeros((B, max_gt), dtype=bool)
    gt_labels = np.zeros((B, max_gt), dtype=np.int32)
    cap_tokens = np.full((B, max_gt, max_caption_len), PAD, dtype=np.int32)
    for i, s in enumerate(samples):
        n = len(s["gt_timestamps"])
        for j, ts in enumerate(s["gt_timestamps"]):
            gt_segments[i, j] = ((ts[1] + ts[0]) / (2 * s["duration"]),
                                 (ts[1] - ts[0]) / s["duration"])
        gt_mask[i, :n] = True
        gt_labels[i, :n] = s["action_labels"]
        for j, ids in enumerate(s["caption_tokens"]):
            cap_tokens[i, j, :len(ids)] = ids
    batch = {"video_tensor": video, "video_mask": mask, "durations": durations,
             "batch_valid": np.ones((B,), dtype=bool), "gt_segments": gt_segments,
             "gt_mask": gt_mask, "gt_labels": gt_labels, "cap_tokens": cap_tokens}
    if audio_rescale_len:
        batch["audio_tensor"], batch["audio_mask"] = _pad_and_resize(
            [s["audio_feature"] for s in samples], audio_rescale_len)
    return batch


def train_batches(mix: dict, seed: int, shapes: dict) -> List[Dict[str, np.ndarray]]:
    """The ``pool`` distinct batches of a training mix. ``shapes``:
    feature_dim, vocab_size, max_gt, max_caption_len, video_rescale_len,
    audio_rescale_len (0 without audio)."""
    base = np.random.default_rng(mix["base_seed"])
    rng = np.random.default_rng(seed)
    n = mix["pool"] * mix["batch_size"]
    audio = shapes["audio_rescale_len"] > 0
    samples = synthetic_samples(mix, n, shapes["feature_dim"], shapes["vocab_size"],
                                shapes["max_gt"], shapes["max_caption_len"], audio, base, rng)
    samples = [samples[i] for i in rng.permutation(n)]
    B = mix["batch_size"]
    return [collate(samples[i:i + B], shapes["video_rescale_len"], shapes["max_gt"],
                    shapes["max_caption_len"], shapes["audio_rescale_len"])
            for i in range(0, n, B)]

