"""Raw ingest of the port (``data/raw_anet.py``, the loader's
``collate_fn``) against the JAX package's ``data/raw_anet.py``: the
synthetic decoder bit for bit, the raw dataset and ``collate_raw`` on one
annotation file (frames and ground truth equal; the log-mel spectrograms
to ``test_torch_raw_frontend.py``'s tolerance), the OpenCV decoder on clips
written here, the decoder resolution, and the raw loader keeping the frames
uint8."""

from __future__ import annotations

import ast
import json
import wave as wave_mod
from pathlib import Path

import numpy as np
import pytest

from multimodal_feature_learning_tpu.data import raw_anet as jraw
from multimodal_feature_learning_tpu.data.vocab import build_vocab as jax_build_vocab
from multimodal_feature_learning_tpu_torch.config import Config
from multimodal_feature_learning_tpu_torch.data import raw_anet as traw
from multimodal_feature_learning_tpu_torch.data.loader import DataLoader
from multimodal_feature_learning_tpu_torch.data.vocab import build_vocab
from test_torch_raw_frontend import assert_fbank_close

ANN = {
    "v_a": {"duration": 10.0, "timestamps": [[1.0, 4.0], [5.0, 9.0], [2.0, 3.0]],
            "sentences": ["a man is running", "the dog jumps high", "a man jumps"]},
    "v_b": {"duration": 3.4, "timestamps": [[0.5, 2.0]], "sentences": ["the dog is running"]},
    "v_c": {"duration": 7.25, "timestamps": [[2.0, 1.0]], "sentences": ["degenerate"]},
    "v_d": {"duration": 0.3, "timestamps": [[0.0, 0.2]], "sentences": ["a short clip"]},
}
KW = dict(video_rescale_len=6, num_mel_bins=16, audio_target_length=12,
          max_gt_target_segments=2, max_caption_len=8)


@pytest.fixture(scope="module")
def ann_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("raw") / "ann.json"
    path.write_text(json.dumps(ANN))
    return path


@pytest.mark.parametrize("key,duration,size", [("v_a", 10.0, 128), ("v_x", 0.2, 16),
                                               ("v_y", 33.3, 32)])
def test_synthetic_decoder_equals_jax_bit_for_bit(key, duration, size):
    got = traw.synthetic_decoder(frame_size=size)(key, duration)
    ref = jraw.synthetic_decoder(frame_size=size)(key, duration)
    assert got[2] == ref[2] == 16000
    for g, r in zip(got[:2], ref[:2]):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)
    assert got[0].shape[0] == max(int(duration * 4), 2)


@pytest.mark.parametrize("training,with_audio", [(False, True), (True, True), (False, False)])
def test_raw_dataset_and_collate_equal_jax(ann_path, training, with_audio):
    """Samples (the degenerate video is None on both sides) and the batch:
    uint8 frames, all-false masks, ground truth and tokens equal; the
    spectrograms within the fbank tolerance, zero past each clip's frames."""
    vocab, jvocab = build_vocab(ANN, min_freq=1), jax_build_vocab(ANN, min_freq=1)
    assert vocab.itos == jvocab.itos
    kw = dict(KW, with_audio=with_audio, seed=3)
    ds = traw.RawActivityNetDataset(str(ann_path), traw.synthetic_decoder(frame_size=16), vocab,
                                    training, **kw)
    jds = jraw.RawActivityNetDataset(str(ann_path), jraw.synthetic_decoder(frame_size=16),
                                     jvocab, training, **kw)
    samples, jsamples = [ds[i] for i in range(len(ds))], [jds[i] for i in range(len(jds))]
    assert [s is None for s in samples] == [s is None for s in jsamples]
    assert sum(s is None for s in samples) == 1
    batch = traw.collate_raw(samples, vocab.pad_idx, max_gt=2, max_caption_len=8)
    ref = jraw.collate_raw(jsamples, jvocab.pad_idx, max_gt=2, max_caption_len=8)
    assert set(batch) == set(ref)
    assert batch["video_tensor"].dtype == np.uint8 and batch["video_tensor"].shape == (3, 6, 16,
                                                                                    16, 3)
    for k in ref:
        if k == "audio_tensor":
            assert batch[k].shape == ref[k].shape == (3, 12, 16)
            for g, r in zip(batch[k], ref[k]):
                n = int((r != 0).any(axis=1).sum())
                assert (g[n:] == 0).all()
                assert_fbank_close(g[:n], r[:n])
            continue
        if isinstance(ref[k], np.ndarray):
            assert batch[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(batch[k], ref[k], err_msg=k)
        else:
            assert batch[k] == ref[k], k
    # a 0.3 s clip: 4800 samples, 28 frames of 25 ms, cut to 12; none dropped
    assert (batch["audio_tensor"][-1] != 0).any() if with_audio else "audio_tensor" not in batch


def test_empty_audio_drops_the_clip_only_when_audio_is_read(ann_path):
    vocab = build_vocab(ANN, min_freq=1)

    def silent(key, duration):
        frames, _, sr = traw.synthetic_decoder(frame_size=16)(key, duration)
        return frames, np.zeros((0,), np.float32), sr

    with_audio = traw.RawActivityNetDataset(str(ann_path), silent, vocab, False, **KW)
    without = traw.RawActivityNetDataset(str(ann_path), silent, vocab, False,
                                         **dict(KW, with_audio=False))
    assert with_audio[0] is None and without[0]["raw_frames"].shape == (6, 16, 16, 3)


def test_loader_keeps_raw_batches_uint8_and_unpadded(ann_path):
    """``collate_fn`` replaces the fixed collate: batches of the real
    samples (no dummy rows), frames uint8, in the loader's order."""
    import functools

    vocab = build_vocab(ANN, min_freq=1)
    ds = traw.RawActivityNetDataset(str(ann_path), traw.synthetic_decoder(frame_size=16), vocab,
                                    False, **KW)
    collate = functools.partial(traw.collate_raw, pad_idx=vocab.pad_idx, max_gt=2,
                                max_caption_len=8)
    batches = list(DataLoader(ds, 3, vocab.pad_idx, shuffle=False, collate_fn=collate))
    assert [b["keys"] for b in batches] == [["v_a", "v_b"], ["v_d"]]
    assert all(b["video_tensor"].dtype == np.uint8 for b in batches)
    assert [len(b["durations"]) for b in batches] == [2, 1]


def test_build_decoder_resolution(monkeypatch, tmp_path):
    """The OpenCV decoder when a folder is set and cv2 imports; the
    synthetic one without a folder or when cv2 fails to import."""
    anet = Config().dataset.activity_net
    key = ("v_a", 2.0)
    assert np.array_equal(traw.build_decoder(anet, True)(*key)[0],
                          traw.synthetic_decoder()(*key)[0])
    anet.raw_video_folder = str(tmp_path)

    def no_cv2(*args, **kwargs):
        raise ImportError("no cv2")

    monkeypatch.setattr(traw, "opencv_decoder", no_cv2)
    assert np.array_equal(traw.build_decoder(anet, True)(*key)[0],
                          traw.synthetic_decoder()(*key)[0])


def test_cv2_is_imported_only_inside_opencv_decoder():
    """The card's machine may lack OpenCV: no module of the port imports
    ``cv2`` but the body of ``opencv_decoder``."""
    root = Path(traw.__file__).resolve().parents[1]
    places = []
    for path in root.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for fn in [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)] + [tree]:
            body = fn.body if fn is not tree else [n for n in tree.body
                                                   if not isinstance(n, ast.FunctionDef)]
            for node in (n for b in body for n in ast.walk(b)):
                if isinstance(node, ast.Import) and any(a.name == "cv2" for a in node.names):
                    places.append((path.name, getattr(fn, "name", "<module>")))
    assert set(places) == {("raw_anet.py", "opencv_decoder")}


# -- the OpenCV decoder on clips written here ----------------------------------


def write_media(tmp_path, cv2):
    vdir, adir = tmp_path / "videos", tmp_path / "audio"
    vdir.mkdir()
    adir.mkdir()
    for i, key in enumerate(("v_a", "v_b")):
        w = cv2.VideoWriter(str(vdir / f"{key}.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 4.0,
                            (48, 32))
        assert w.isOpened()
        for f in range(6 + i):
            w.write(np.full((32, 48, 3), (f * 30, 10, 200), np.uint8))
        w.release()
        t = np.arange(16000 * 2) / 16000
        for width, dtype, scale in ((2, "<i2", 32767),):
            pcm = (np.sin(2 * np.pi * 440 * t) * 0.3 * scale).astype(dtype)
            with wave_mod.open(str(adir / f"{key}.wav"), "wb") as f:
                f.setnchannels(1)
                f.setsampwidth(width)
                f.setframerate(16000)
                f.writeframes(pcm.tobytes())
    return vdir, adir


def test_opencv_decoder_equals_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    vdir, adir = write_media(tmp_path, cv2)
    for audio in (str(adir), ""):
        got = traw.opencv_decoder(str(vdir), audio_folder=audio)("v_b", 2.0)
        ref = jraw.opencv_decoder(str(vdir), audio_folder=audio)("v_b", 2.0)
        assert got[0].shape == (7, 32, 48, 3) and got[0].dtype == np.uint8
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[2] == ref[2] == 16000
        assert (len(got[1]) == 32000) == bool(audio)
    with pytest.raises(FileNotFoundError, match="v_nope"):
        traw.opencv_decoder(str(vdir))("v_nope", 1.0)
    assert traw.opencv_decoder(str(vdir), max_frames=3)("v_a", 2.0)[0].shape[0] == 3


@pytest.mark.parametrize("width,channels", [(1, 1), (2, 2), (4, 1)])
def test_wav_sidecars_equal_jax(tmp_path, width, channels):
    cv2 = pytest.importorskip("cv2")
    vdir, adir = write_media(tmp_path, cv2)
    rng = np.random.default_rng(width)
    n = 1000 * channels
    data = {1: rng.integers(0, 256, n).astype(np.uint8),
            2: rng.integers(-2 ** 15, 2 ** 15, n).astype("<i2"),
            4: rng.integers(-2 ** 31, 2 ** 31, n).astype("<i4")}[width]
    with wave_mod.open(str(adir / "v_a.wav"), "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(width)
        f.setframerate(8000)
        f.writeframes(data.tobytes())
    got = traw.opencv_decoder(str(vdir), audio_folder=str(adir))("v_a", 1.0)
    ref = jraw.opencv_decoder(str(vdir), audio_folder=str(adir))("v_a", 1.0)
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[2] == ref[2] == 8000 and len(got[1]) == 1000
