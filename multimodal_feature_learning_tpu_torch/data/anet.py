"""ActivityNet Captions on precomputed features, and fixed-shape batches;
the port's copy of the JAX package's ``data/anet.py`` (video features, and
audio features for the multimodal family), with a synthetic source of batches in the shape of the JAX package's
synthetic world (``__graft_entry__._synth_batch``).

* ``FeatureBackend``: a directory of ``<video key>.npy`` arrays of shape
  (num_tokens, feature_dim), each memory-mapped when read, or the JAX
  package's deterministic synthetic generator. The JAX package reads an h5
  file through ``h5py``; the port has no ``h5py``, so it reads ``.npy``
  files instead and refuses an ``.h5`` path.
* ``ActivityNetDataset``: skip videos with a degenerate timestamp, keep at
  most ``max_gt_target_segments`` events (a fresh random subset each time in
  training, a subset fixed per key in evaluation), tokenize captions to
  ``<bos> ... <eos>``, keep the raw captions.
* ``collate_fixed``: zero-pad to the batch's longest video, mask, normalise
  the events to (centre, length), nearest-resize to ``video_rescale_len``,
  and optionally pad the batch with dummy rows; the audio features, when the
  samples have them, likewise to ``audio_rescale_len``.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Dict, Iterator, List, Optional

import numpy as np

from .vocab import Vocab, build_vocab, word_tokenize


def nearest_resize(x: np.ndarray, new_size: int, axis: int = 1) -> np.ndarray:
    """``F.interpolate(mode='nearest')`` semantics along ``axis``:
    out[i] = in[floor(i * T_in / T_out)]."""
    t_in = x.shape[axis]
    idx = (np.arange(new_size) * t_in) // new_size
    return np.take(x, idx, axis=axis)


class FeatureBackend:
    """Features of a video by key: from ``features_path``, a directory of
    ``<key>.npy`` files, or, when it is "", from a generator seeded by the
    key's crc32 (normal, ``(synthetic_len, feature_dim)`` f32), bit for bit
    the JAX package's synthetic features."""

    def __init__(self, features_path: str = "", feature_dim: int = 512,
                 synthetic_len: int = 64):
        self.path = features_path
        self.feature_dim = feature_dim
        self.synthetic_len = synthetic_len
        self.keys = None
        if features_path:
            if features_path.endswith(".h5"):
                raise ValueError(
                    f"{features_path}: h5 feature files are not read by the port (it has "
                    "no h5py); give a directory of <video key>.npy arrays instead")
            self.keys = {f[:-4] for f in os.listdir(features_path) if f.endswith(".npy")}

    def __contains__(self, key: str) -> bool:
        return self.keys is None or key in self.keys

    def get(self, key: str) -> np.ndarray:
        if self.keys is not None:
            # mapped, so only the video read comes off the disk
            x = np.load(os.path.join(self.path, key + ".npy"), mmap_mode="r")
            return np.asarray(x, dtype=np.float32)
        # crc32, not hash(): string hashing is randomised per process
        rng = np.random.default_rng(zlib.crc32(key.encode()))
        return rng.normal(size=(self.synthetic_len, self.feature_dim)).astype(np.float32)


class ActivityNetDataset:
    def __init__(
        self,
        annotation_file: str,
        features: FeatureBackend,
        vocab: Vocab,
        is_training: bool,
        max_gt_target_segments: int = 10,
        max_caption_len: int = 20,
        invalid_videos_json: str = "",
        for_testing: bool = False,
        num_samples: int = 6,
        num_classes: int = 200,
        seed: int = 0,
        audio_features: Optional[FeatureBackend] = None,
    ):
        """In training the event subsets come from ``self.rng``
        (``np.random.default_rng(seed)``); in evaluation each key's subset
        comes from ``default_rng((crc32(key), seed))``, so it does not depend
        on the order or the number of passes. With ``audio_features`` each
        sample also holds its ``audio_feature``."""
        with open(annotation_file) as f:
            self.annotation = json.load(f)
        invalid = set()
        if invalid_videos_json and os.path.exists(invalid_videos_json):
            with open(invalid_videos_json) as f:
                invalid = set(json.load(f))
        self.keys = [
            k for k in self.annotation.keys() if k not in invalid and k in features
        ]
        if for_testing:
            self.keys = self.keys[:num_samples]
        self.features = features
        self.audio_features = audio_features
        self.vocab = vocab
        self.is_training = is_training
        self.max_gt = max_gt_target_segments
        self.max_caption_len = max_caption_len
        self.num_classes = num_classes
        self.base_seed = seed
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, idx: int) -> Optional[Dict]:
        key = self.keys[idx]
        ann = self.annotation[key]
        for ts in ann["timestamps"]:
            if ts[0] >= ts[1]:
                return None  # degenerate ground truth

        duration = float(ann["duration"])
        captions = list(ann["sentences"])
        gt_timestamps = [list(ts) for ts in ann["timestamps"]]
        action_labels = list(ann.get("classes", [0] * len(gt_timestamps)))

        n = min(len(gt_timestamps), self.max_gt)
        if self.is_training:
            rng = self.rng
        else:
            rng = np.random.default_rng((zlib.crc32(key.encode()), self.base_seed))
        chosen = rng.choice(len(gt_timestamps), n, replace=False)
        chosen_set = set(int(c) for c in chosen)
        keep = [i for i in range(len(gt_timestamps)) if i in chosen_set]
        captions = [captions[i] for i in keep]
        gt_timestamps = [gt_timestamps[i] for i in keep]
        action_labels = [action_labels[i] for i in keep]

        caption_tokens = []
        for caption in captions:
            ids = [self.vocab[t] for t in word_tokenize(caption.lower())]
            ids = [self.vocab.bos_idx] + ids[: self.max_caption_len - 2] + [self.vocab.eos_idx]
            caption_tokens.append(ids)

        sample = {
            "key": key,
            "video_feature": self.features.get(key),  # (num_tokens, D)
            "duration": duration,
            "gt_timestamps": gt_timestamps,      # [n, 2] seconds
            "action_labels": action_labels,      # [n]
            "caption_tokens": caption_tokens,    # [n, <=Lc]
            "raw_captions": captions,            # [n]
        }
        if self.audio_features is not None:
            sample["audio_feature"] = self.audio_features.get(key)  # (audio tokens, D)
        return sample


def _pad_and_resize(feats: List[np.ndarray], B: int, n_real: int, rescale_len: int):
    """Features (T_i, D) zero-padded to the longest and masked (True=pad),
    both nearest-resized to ``rescale_len``; rows past the real ones are
    dummies: valid zero features, not fully padded ones (a fully masked row
    divides by a zero valid ratio and softmaxes over nothing, which gives
    NaN gradients although the criterion masks its loss)."""
    x = np.zeros((B, max(f.shape[0] for f in feats), feats[0].shape[1]), dtype=np.float32)
    mask = np.ones(x.shape[:2], dtype=bool)
    mask[n_real:] = False
    for i, f in enumerate(feats):
        x[i, :f.shape[0]] = f
        mask[i, :f.shape[0]] = False
    return nearest_resize(x, rescale_len, axis=1), nearest_resize(mask, rescale_len, axis=1)


def collate_fixed(samples: List[Optional[Dict]], pad_idx: int, video_rescale_len: int = 300,
                  max_gt: int = 10, max_caption_len: int = 20,
                  pad_to_batch: int = 0, audio_rescale_len: int = 0) -> Optional[Dict]:
    """Fixed-shape batch dict of numpy arrays; ``None`` samples are dropped.
    ``pad_to_batch`` pads the batch to that many rows with dummy videos, so
    that every step has the same shapes.

    Each sample: video_feature (T_i, D), duration (s), gt_timestamps [n, 2]
    seconds, action_labels [n], caption_tokens [n lists of ids], key, and
    raw_captions [n strings] (synthetic samples have none).
    Returns video_tensor (B, T, D) f32, video_mask (B, T) bool True=pad,
    durations (B,), batch_valid (B,) (False on dummy rows), gt_segments
    (B, G, 2) (center, length), gt_mask (B, G), gt_labels (B, G) i32,
    cap_tokens (B, G, Lc) i32 (<pad> in unused slots), and the lists
    ``keys``, ``raw_captions`` and ``gt_timestamps`` of the real rows. With
    ``audio_rescale_len`` and samples that hold ``audio_feature``, also
    audio_tensor (B, Ta, D) f32 and audio_mask (B, Ta)."""
    samples = [s for s in samples if s is not None]
    if not samples:
        return None
    n_real = len(samples)
    B = max(n_real, pad_to_batch)
    # pad to the batch max, then nearest-rescale the tensor and the mask
    video, mask = _pad_and_resize([s["video_feature"] for s in samples], B, n_real,
                                  video_rescale_len)
    durations = np.ones((B,), dtype=np.float32)
    gt_segments = np.zeros((B, max_gt, 2), dtype=np.float32)
    gt_mask = np.zeros((B, max_gt), dtype=bool)
    gt_labels = np.zeros((B, max_gt), dtype=np.int32)
    cap_tokens = np.full((B, max_gt, max_caption_len), pad_idx, dtype=np.int32)
    keys, raw_captions, gt_timestamps = [], [], []
    for i, s in enumerate(samples):
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
        raw_captions.append(s.get("raw_captions", []))
        gt_timestamps.append(s["gt_timestamps"])
    batch_valid = np.zeros((B,), dtype=bool)
    batch_valid[:n_real] = True
    audio = {}
    if audio_rescale_len and "audio_feature" in samples[0]:
        audio["audio_tensor"], audio["audio_mask"] = _pad_and_resize(
            [s["audio_feature"] for s in samples], B, n_real, audio_rescale_len)
    return {
        "video_tensor": video, "video_mask": mask, **audio, "durations": durations,
        "batch_valid": batch_valid, "gt_segments": gt_segments, "gt_mask": gt_mask,
        "gt_labels": gt_labels, "cap_tokens": cap_tokens, "keys": keys,
        "raw_captions": raw_captions, "gt_timestamps": gt_timestamps,
    }


def audio_rescale_len(cfg) -> int:
    """The audio length batches are resized to: ``audio_rescale_len`` with
    two input modalities, else 0 (no audio keys)."""
    return cfg.dataset.activity_net.audio_rescale_len if len(cfg.dvc.input_modalities) == 2 \
        else 0


SPLIT_FILES = {
    "train": "train.json",
    "val": "val_data_1_with_action_classes.json",
    "test": "val_data_2.json",
}


def build_dataset(split: str, cfg, vocab: Optional[Vocab] = None):
    """(dataset of ``split``, vocab). Without ``vocab``, it is loaded from
    ``vocab_file_path`` when that file exists, else built from the train
    split's captions and saved there."""
    anet = cfg.dataset.activity_net
    annotation_file = os.path.join(anet.anet_path, SPLIT_FILES[split])

    if vocab is None:
        vpath = anet.vocab_file_path
        if vpath and os.path.exists(vpath):
            vocab = Vocab.load(vpath)
        else:
            with open(os.path.join(anet.anet_path, SPLIT_FILES["train"])) as f:
                train_ann = json.load(f)
            vocab = build_vocab(train_ann, anet.min_freq)
            if vpath:
                vocab.save(vpath)

    features = FeatureBackend(anet.video_features_file, feature_dim=cfg.dvc.detr.feature_dim)
    audio_features = None
    if len(cfg.dvc.input_modalities) == 2:
        # no audio file given: the video features are read as audio, as in
        # the JAX package (the reference ships no audio features)
        audio_features = FeatureBackend(anet.audio_features_file or anet.video_features_file,
                                        feature_dim=cfg.dvc.detr.feature_dim)
    ds = ActivityNetDataset(
        annotation_file,
        features,
        vocab,
        is_training=(split == "train"),
        max_gt_target_segments=anet.max_gt_target_segments,
        max_caption_len=anet.max_caption_len_all,
        invalid_videos_json=anet.invalid_videos_json,
        for_testing=anet.for_testing,
        num_samples=anet.num_samples,
        num_classes=anet.num_classes,
        seed=cfg.seed,
        audio_features=audio_features,
    )
    return ds, vocab


def synthetic_samples(cfg, n: int, vocab_size: int, rng: np.random.Generator,
                      pad_idx: int = 1, bos_idx: int = 2, eos_idx: int = 3) -> List[Dict]:
    """``n`` random videos: features of 120-900 tokens, durations 10-180 s,
    1 to max_gt events of 5-30% of the duration with centres in 20-80%, and
    captions <bos> + 4..(Lc-2) words + <eos>; with two input modalities also
    audio features of 20-150 tokens, drawn after every video, so that the
    videos are those of one modality."""
    anet = cfg.dataset.activity_net
    G, Lc, D = anet.max_gt_target_segments, anet.max_caption_len_all, cfg.dvc.detr.feature_dim
    audio = len(cfg.dvc.input_modalities) == 2
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
    if audio:
        for sample in out:
            Ta = int(rng.integers(20, 151))
            sample["audio_feature"] = rng.normal(size=(Ta, D)).astype(np.float32)
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
                            anet.max_caption_len_all,
                            audio_rescale_len=audio_rescale_len(cfg))
        i += 1
