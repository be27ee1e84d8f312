"""ActivityNet Captions on raw videos (and their audio); the port's copy of
the JAX package's ``data/raw_anet.py``.

The host only decodes: a ``decoder`` callable (key, duration) -> (frames
uint8 (T, H, W, 3), waveform f32, sample rate), resampled to
``video_rescale_len`` frames by nearest index, and the waveform's log-mel
fbank (``data/audio.py``, on the host's CPU). The frames stay uint8 to the
card; the models normalise them there. Annotation, caption and
ground-truth handling is ``ActivityNetDataset``'s; clips whose audio is
empty are dropped when audio is read.

Decoders: ``synthetic_decoder`` (seeded by the key's crc32, bit for bit the
JAX package's) and ``opencv_decoder`` (OpenCV, imported when it is built,
with optional ``<key>.wav`` sidecars read by the standard library's
``wave``); ``build_decoder`` takes the OpenCV one when a raw video folder
is configured and ``cv2`` imports, else the synthetic one.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Callable, Dict, List, Optional

import numpy as np

from .anet import SPLIT_FILES, ActivityNetDataset, FeatureBackend
from .audio import aframes_to_fbank_static
from .video_transforms import temporal_resample_nearest
from .vocab import Vocab, build_vocab


def synthetic_decoder(frame_size: int = 128, fps: float = 4.0, sample_rate: int = 16000):
    """A deterministic stand-in for a video decoder: (key, duration) ->
    (max(int(duration * fps), 2) random uint8 frames (T, frame_size,
    frame_size, 3), a normal waveform * 0.1 of int(duration * sample_rate)
    samples, sample_rate), drawn from ``default_rng(crc32(key))``."""

    def decode(key: str, duration: float):
        # crc32: stable across processes, unlike hash()
        rng = np.random.default_rng(zlib.crc32(key.encode()))
        t = max(int(duration * fps), 2)
        frames = rng.integers(0, 255, size=(t, frame_size, frame_size, 3)).astype(np.uint8)
        wave = rng.normal(size=int(duration * sample_rate)).astype(np.float32) * 0.1
        return frames, wave, sample_rate

    return decode


def _resolve(folder: str, key: str, extensions) -> Optional[str]:
    for ext in extensions:
        path = os.path.join(folder, key + ext)
        if os.path.exists(path):
            return path
    return None


def _read_wav(path: str):
    """(mono f32 samples in [-1, 1), sample rate) of a 8/16/32-bit PCM WAV."""
    import wave as wave_mod

    with wave_mod.open(path, "rb") as w:
        sr = w.getframerate()
        width = w.getsampwidth()
        channels = w.getnchannels()
        data = w.readframes(w.getnframes())
    if width == 2:
        raw = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 1:  # 8-bit PCM is unsigned
        raw = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 4:
        raw = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"{path}: unsupported WAV sample width {width} bytes "
                         "(supported: 1, 2, 4)")
    if channels > 1:
        raw = raw.reshape(-1, channels).mean(axis=1)
    return raw, sr


def opencv_decoder(video_folder: str, audio_folder: str = "",
                   extensions=(".mp4", ".mkv", ".webm", ".avi", ".mov"),
                   max_frames: int = 0):
    """A decoder over ``video_folder/<key>.<ext>`` through OpenCV: every
    frame (at most ``max_frames`` when > 0) as RGB uint8. OpenCV reads no
    audio track, so the waveform comes from ``audio_folder/<key>.wav`` when
    there is one, else it is empty (which drops the clip where audio is
    read). Raises ``ImportError`` when ``cv2`` is absent."""
    import cv2

    def decode(key: str, duration: float):
        path = _resolve(video_folder, key, extensions)
        if path is None:
            raise FileNotFoundError(f"no video file for {key!r} in {video_folder}")
        cap = cv2.VideoCapture(path)
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame[..., ::-1])  # BGR -> RGB
            if max_frames and len(frames) >= max_frames:
                break
        cap.release()
        if not frames:
            raise IOError(f"decoded 0 frames from {path}")
        wave, sr = np.zeros((0,), dtype=np.float32), 16000
        if audio_folder:
            wav_path = _resolve(audio_folder, key, (".wav",))
            if wav_path is not None:
                wave, sr = _read_wav(wav_path)
        return np.stack(frames).astype(np.uint8), wave, sr

    return decode


def build_decoder(cfg_anet, with_audio: bool) -> Callable:
    """The OpenCV decoder when ``raw_video_folder`` is set and ``cv2``
    imports, else the synthetic one (``with_audio`` is not read, as in
    JAX)."""
    if cfg_anet.raw_video_folder:
        try:
            return opencv_decoder(cfg_anet.raw_video_folder,
                                  audio_folder=cfg_anet.raw_audio_folder)
        except ImportError:
            pass
    return synthetic_decoder()


class RawActivityNetDataset(ActivityNetDataset):
    """``ActivityNetDataset``'s samples with ``raw_frames`` (video_rescale_len,
    H, W, 3) uint8 and, ``with_audio``, ``audio_feature`` (audio_target_length,
    num_mel_bins) f32 in place of the video features. As in JAX, the base
    sample's (64, 1) synthetic feature is still made and then dropped."""

    def __init__(self, annotation_file: str, decoder: Callable, vocab, is_training: bool,
                 video_rescale_len: int = 300, num_mel_bins: int = 128,
                 audio_target_length: int = 64, with_audio: bool = True, **kwargs):
        super().__init__(annotation_file, FeatureBackend("", feature_dim=1), vocab,
                         is_training, **kwargs)
        self.decoder = decoder
        self.video_rescale_len = video_rescale_len
        self.num_mel_bins = num_mel_bins
        self.audio_target_length = audio_target_length
        self.with_audio = with_audio

    def __getitem__(self, idx: int) -> Optional[Dict]:
        base = super().__getitem__(idx)
        if base is None:
            return None
        frames, wave, sr = self.decoder(base["key"], base["duration"])
        if self.with_audio and (wave is None or len(wave) == 0):
            return None  # clips with empty audio are dropped
        sample = dict(base)
        del sample["video_feature"]
        sample["raw_frames"] = temporal_resample_nearest(frames, self.video_rescale_len)
        if self.with_audio:
            sample["audio_feature"] = aframes_to_fbank_static(
                np.asarray(wave), float(sr), self.num_mel_bins, self.audio_target_length)
        return sample


def collate_raw(samples: List[Optional[Dict]], pad_idx: int, max_gt: int = 10,
                max_caption_len: int = 20) -> Optional[Dict]:
    """A batch of the real samples (``None`` dropped, no dummy rows):
    video_tensor (B, T, H, W, 3) uint8, an all-false video_mask (B, T), and,
    with audio, audio_tensor (B, La, mel) f32 with an all-false audio_mask;
    the ground truth and captions as ``collate_fixed`` makes them, with
    gt_labels all 0."""
    samples = [s for s in samples if s is not None]
    if not samples:
        return None
    B = len(samples)
    frames = np.stack([s["raw_frames"] for s in samples])
    durations = np.array([s["duration"] for s in samples], dtype=np.float32)
    gt_segments = np.zeros((B, max_gt, 2), dtype=np.float32)
    gt_mask = np.zeros((B, max_gt), dtype=bool)
    cap_tokens = np.full((B, max_gt, max_caption_len), pad_idx, dtype=np.int32)
    keys, raw_captions, gt_timestamps = [], [], []
    for i, s in enumerate(samples):
        for j, ts in enumerate(s["gt_timestamps"]):
            gt_segments[i, j] = ((ts[1] + ts[0]) / (2 * s["duration"]),
                                 (ts[1] - ts[0]) / s["duration"])
        gt_mask[i, :len(s["gt_timestamps"])] = True
        for j, ids in enumerate(s["caption_tokens"]):
            cap_tokens[i, j, :len(ids)] = ids
        keys.append(s["key"])
        raw_captions.append(s["raw_captions"])
        gt_timestamps.append(s["gt_timestamps"])
    out = {
        "video_tensor": frames,
        "video_mask": np.zeros(frames.shape[:2], dtype=bool),
        "durations": durations,
        "batch_valid": np.ones((B,), dtype=bool),
        "gt_segments": gt_segments,
        "gt_mask": gt_mask,
        "gt_labels": np.zeros((B, max_gt), dtype=np.int32),
        "cap_tokens": cap_tokens,
        "keys": keys,
        "raw_captions": raw_captions,
        "gt_timestamps": gt_timestamps,
    }
    if "audio_feature" in samples[0]:
        out["audio_tensor"] = np.stack([s["audio_feature"] for s in samples])
        out["audio_mask"] = np.zeros(out["audio_tensor"].shape[:2], dtype=bool)
    return out


def build_raw_dataset(split: str, cfg, vocab: Optional[Vocab] = None):
    """(raw dataset of ``split``, vocab), as ``data.anet.build_dataset``
    resolves the annotation file and the vocab, with the configured
    decoder; audio is read with two input modalities."""
    anet = cfg.dataset.activity_net
    if vocab is None:
        vpath = anet.vocab_file_path
        if vpath and os.path.exists(vpath):
            vocab = Vocab.load(vpath)
        else:
            with open(os.path.join(anet.anet_path, SPLIT_FILES["train"])) as f:
                vocab = build_vocab(json.load(f), anet.min_freq)
            if vpath:
                vocab.save(vpath)
    with_audio = len(cfg.dvc.input_modalities) == 2
    ds = RawActivityNetDataset(
        os.path.join(anet.anet_path, SPLIT_FILES[split]),
        build_decoder(anet, with_audio), vocab, is_training=(split == "train"),
        video_rescale_len=anet.video_rescale_len, num_mel_bins=anet.num_mel_bins,
        audio_target_length=anet.audio_target_length, with_audio=with_audio,
        max_gt_target_segments=anet.max_gt_target_segments,
        max_caption_len=anet.max_caption_len_all,
        invalid_videos_json=anet.invalid_videos_json, for_testing=anet.for_testing,
        num_samples=anet.num_samples, num_classes=anet.num_classes, seed=cfg.seed)
    return ds, vocab
