"""The port's feature reader, dataset, collate, loader and vocabulary against
the JAX package's, on files the tests write.

The world: an annotations JSON per split (a video with a degenerate
timestamp, one listed as invalid, videos with more events than
``max_gt_target_segments``, captions with punctuation and contractions), an
``invalid_videos_json`` and a directory of ``<key>.npy`` features holding
the JAX package's synthetic features of every key. The JAX side reads its
synthetic generator, the port the files. Everything is held equal, exactly:
features, chosen events, token ids, raw captions, every collated array and
both metadata lists, batch order over two shuffled epochs; with two input
modalities, the audio features (the video features read as audio, as JAX's
dataset does without an audio file) through the collate and the loader."""

from __future__ import annotations

import json

import numpy as np
import pytest

from multimodal_feature_learning_tpu.data import anet as janet
from multimodal_feature_learning_tpu.data import loader as jloader
from multimodal_feature_learning_tpu.data import vocab as jvocab
from multimodal_feature_learning_tpu_torch.config import Config
from multimodal_feature_learning_tpu_torch.data import anet as tanet
from multimodal_feature_learning_tpu_torch.data import loader as tloader
from multimodal_feature_learning_tpu_torch.data import vocab as tvocab

D, MAX_GT, LC, T_RESCALE = 16, 4, 8, 12
WORDS = ["a", "man", "isn't", "playing", "guitar,", "the", "dog's", "runs", "across.",
         "field", "person", "rides", "bike", "crowd", "cheers!", "(slowly)"]
N_VIDEOS = 11


def write_split(path, rng, n, prefix):
    ann = {}
    for i in range(n):
        dur = float(rng.uniform(10, 120))
        k = int(rng.integers(1, 8))
        stamps = []
        for _ in range(k):
            s = float(rng.uniform(0, dur * 0.7))
            stamps.append([s, float(rng.uniform(s + 1.0, dur))])
        ann[f"{prefix}_{i:03d}"] = {
            "duration": dur, "timestamps": stamps,
            "sentences": [" ".join(rng.choice(WORDS, size=int(rng.integers(3, 12))))
                          for _ in range(k)]}
    return ann


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("anet")
    rng = np.random.default_rng(7)
    train = write_split(root, rng, 24, "tr")
    val = write_split(root, rng, N_VIDEOS, "va")
    first = next(iter(val))
    val[first]["timestamps"][0] = [5.0, 5.0]  # degenerate: the item is None
    with open(root / "train.json", "w") as f:
        json.dump(train, f)
    with open(root / "val_data_1_with_action_classes.json", "w") as f:
        json.dump(val, f)
    with open(root / "invalid.json", "w") as f:
        json.dump([list(val)[3]], f)
    feat = root / "features"
    feat.mkdir()
    synth = janet.FeatureBackend("", feature_dim=D)
    for key in list(train) + list(val):
        np.save(feat / f"{key}.npy", synth.get(key))
    return root


def jax_cfg(root):
    from multimodal_feature_learning_tpu.config import load_config_train

    cfg = load_config_train()
    anet = cfg.dataset.activity_net
    anet.anet_path = str(root)
    anet.video_features_file = ""
    anet.invalid_videos_json = str(root / "invalid.json")
    anet.vocab_file_path = str(root / "vocab_jax.pkl")
    anet.max_gt_target_segments = MAX_GT
    anet.max_caption_len_all = LC
    anet.video_rescale_len = T_RESCALE
    cfg.dvc.detr.feature_dim = D
    return cfg


def port_cfg(root):
    cfg = Config()
    anet = cfg.dataset.activity_net
    anet.anet_path = str(root)
    anet.video_features_file = str(root / "features")
    anet.invalid_videos_json = str(root / "invalid.json")
    anet.vocab_file_path = str(root / "vocab_port.pkl")
    anet.max_gt_target_segments = MAX_GT
    anet.max_caption_len_all = LC
    anet.video_rescale_len = T_RESCALE
    cfg.dvc.detr.feature_dim = D
    return cfg


@pytest.fixture(scope="module")
def datasets(world):
    """{split: (jax dataset, port dataset)}, the vocab built by each side."""
    out = {}
    jds, jv = janet.build_dataset("val", jax_cfg(world))
    tds, tv = tanet.build_dataset("val", port_cfg(world))
    out["val"] = (jds, tds)
    out["train"] = (janet.build_dataset("train", jax_cfg(world), jv)[0],
                    tanet.build_dataset("train", port_cfg(world), tv)[0])
    return out


def assert_samples_equal(r, g):
    assert (r is None) == (g is None)
    if r is None:
        return
    assert set(r) == set(g)
    for k in r:
        if k == "video_feature":
            assert g[k].dtype == np.float32
            np.testing.assert_array_equal(g[k], r[k])
        else:
            assert g[k] == r[k], k


def test_synthetic_features_equal_jax_bit_for_bit():
    jb, tb = janet.FeatureBackend("", feature_dim=D), tanet.FeatureBackend("", feature_dim=D)
    for key in ("v_a", "v_b", "tr_000", "synthetic_000001"):
        assert key in tb
        got, ref = tb.get(key), jb.get(key)
        assert got.dtype == ref.dtype == np.float32 and got.shape == (64, D)
        np.testing.assert_array_equal(got, ref)


def test_npy_backend_returns_the_written_arrays(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {"v1": rng.normal(size=(5, D)).astype(np.float32),
              "v2": rng.normal(size=(9, D)).astype(np.float16)}
    for k, a in arrays.items():
        np.save(tmp_path / f"{k}.npy", a)
    (tmp_path / "notes.txt").write_text("not a feature file")
    fb = tanet.FeatureBackend(str(tmp_path), feature_dim=D)
    assert "v1" in fb and "v2" in fb and "v3" not in fb and "notes" not in fb
    for k, a in arrays.items():
        got = fb.get(k)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, a.astype(np.float32))


def test_h5_path_raises(tmp_path):
    with pytest.raises(ValueError, match="npy"):
        tanet.FeatureBackend(str(tmp_path / "features.h5"))


def test_vocab_built_from_train_equals_jax(world, datasets):
    jv = jvocab.Vocab.load(str(world / "vocab_jax.pkl"))
    tv = tvocab.Vocab.load(str(world / "vocab_port.pkl"))
    assert tv.itos == jv.itos and len(tv) > 10
    assert tv.itos[:4] == ["<unk>", "<pad>", "<bos>", "<eos>"]


@pytest.mark.parametrize("split", ["val", "train"])
def test_dataset_items_equal_jax(datasets, split):
    """Eval: per-key subsets; train: the subsets of a seeded stream over two
    passes in order."""
    jds, tds = datasets[split]
    assert tds.keys == jds.keys and len(tds) == len(jds)
    passes = 2 if split == "train" else 1
    n_capped = 0
    for _ in range(passes):
        for i in range(len(jds)):
            r, g = jds[i], tds[i]
            assert_samples_equal(r, g)
            if g is not None:
                n_capped += len(tds.annotation[g["key"]]["timestamps"]) > MAX_GT
                assert len(g["raw_captions"]) == len(g["caption_tokens"]) <= MAX_GT
    assert n_capped > 0  # the subset choice was exercised
    if split == "val":
        assert jds[0] is None  # the degenerate timestamp
        assert list(jds.annotation)[3] not in tds.keys  # the invalid video


def test_eval_subsets_do_not_depend_on_order(datasets):
    _, tds = datasets["val"]
    forward = [tds[i] for i in range(len(tds))]
    backward = [tds[i] for i in reversed(range(len(tds)))][::-1]
    for a, b in zip(forward, backward):
        assert_samples_equal(a, b)


@pytest.mark.parametrize("pad_to_batch", [0, 4, 7])
def test_collate_equals_jax(datasets, pad_to_batch):
    jds, tds = datasets["val"]
    samples = [tds[i] for i in range(1, 4)] + [None]
    ref = janet.collate_fixed([jds[i] for i in range(1, 4)] + [None], 1, T_RESCALE, MAX_GT,
                              LC, pad_to_batch=pad_to_batch)
    got = tanet.collate_fixed(samples, 1, T_RESCALE, MAX_GT, LC, pad_to_batch=pad_to_batch)
    assert set(got) == set(ref)
    for k, r in ref.items():
        if isinstance(r, np.ndarray):
            assert got[k].dtype == r.dtype and got[k].shape == r.shape, k
            np.testing.assert_array_equal(got[k], r, err_msg=k)
        else:
            assert got[k] == r, k
    B = max(3, pad_to_batch)
    assert got["video_tensor"].shape[0] == B and len(got["keys"]) == 3
    assert got["batch_valid"].tolist() == [True] * 3 + [False] * (B - 3)
    assert not got["gt_mask"][3:].any() and not got["video_mask"][3:].any()


@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_order_over_two_epochs_equals_jax(datasets, drop_last):
    jds, tds = datasets["val"]
    kw = dict(video_rescale_len=T_RESCALE, max_gt=MAX_GT, max_caption_len=LC, shuffle=True,
              seed=3, drop_last=drop_last)
    jl = jloader.DataLoader(jds, 3, 1, **kw)
    tl = tloader.DataLoader(tds, 3, 1, **kw)
    assert len(tl) == len(jl)
    orders = []
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        ref, got = list(jl), list(tl)
        assert len(got) == len(ref) > 0
        for r, g in zip(ref, got):
            rarr, rmeta = jloader.split_batch(r)
            garr, gmeta = tloader.split_batch(g)
            assert set(garr) == set(rarr) and gmeta == rmeta
            for k in rarr:
                np.testing.assert_array_equal(garr[k], rarr[k], err_msg=k)
            assert garr["video_tensor"].shape[0] == 3  # padded to the batch
        orders.append([k for g in got for k in g["keys"]])
    assert orders[0] != orders[1]
    n_valid = sum(tds[i] is not None for i in range(len(tds)))
    if not drop_last:
        assert sorted(orders[0]) == sorted(orders[1]) and len(orders[0]) == n_valid


A_RESCALE = 6  # the audio length of the two-modality cases


@pytest.fixture(scope="module")
def mm_datasets(world):
    """(jax val dataset, port val dataset) with two input modalities: no
    audio file, so each side reads its video features as audio (JAX
    ``data/anet.py``'s aliasing)."""
    jcfg, tcfg = jax_cfg(world), port_cfg(world)
    jcfg.dvc.input_modalities = ["video", "audio"]
    tcfg.dvc.input_modalities = ["video", "audio"]
    jds, jv = janet.build_dataset("val", jcfg)
    tds, _ = tanet.build_dataset("val", tcfg, tvocab.Vocab(jv.itos))
    assert tds.audio_features.path == tcfg.dataset.activity_net.video_features_file
    return jds, tds


@pytest.mark.parametrize("pad_to_batch", [0, 5])
def test_audio_collate_equals_jax(mm_datasets, pad_to_batch):
    """The audio keys: padded to the longest, masked, nearest-resized to
    audio_rescale_len, dummy rows valid zero audio; every array equal to
    JAX's, and no audio keys without audio_rescale_len."""
    jds, tds = mm_datasets
    got = tanet.collate_fixed([tds[i] for i in range(1, 4)], 1, T_RESCALE, MAX_GT, LC,
                              pad_to_batch=pad_to_batch, audio_rescale_len=A_RESCALE)
    ref = janet.collate_fixed([jds[i] for i in range(1, 4)], 1, T_RESCALE, MAX_GT, LC,
                              pad_to_batch=pad_to_batch, audio_rescale_len=A_RESCALE)
    assert set(got) == set(ref) and "audio_tensor" in got
    for k, r in ref.items():
        if isinstance(r, np.ndarray):
            assert got[k].dtype == r.dtype and got[k].shape == r.shape, k
            np.testing.assert_array_equal(got[k], r, err_msg=k)
    assert got["audio_tensor"].shape == (max(3, pad_to_batch), A_RESCALE, D)
    assert not got["audio_mask"][3:].any() and not got["audio_tensor"][3:].any()
    plain = tanet.collate_fixed([tds[1]], 1, T_RESCALE, MAX_GT, LC)
    assert "audio_tensor" not in plain and "audio_mask" not in plain


def test_audio_loader_equals_jax(mm_datasets):
    """Both loaders with audio_rescale_len: the same batches, the audio keys
    among the arrays ``split_batch`` takes."""
    jds, tds = mm_datasets
    assert set(tloader.ARRAY_KEYS) == set(jloader.ARRAY_KEYS)
    kw = dict(video_rescale_len=T_RESCALE, max_gt=MAX_GT, max_caption_len=LC, shuffle=True,
              seed=3, audio_rescale_len=A_RESCALE)
    ref = list(jloader.DataLoader(jds, 3, 1, **kw))
    got = list(tloader.DataLoader(tds, 3, 1, **kw))
    assert len(got) == len(ref) > 0
    for r, g in zip(ref, got):
        rarr, garr = jloader.split_batch(r)[0], tloader.split_batch(g)[0]
        assert set(garr) == set(rarr) and "audio_mask" in garr
        for k in rarr:
            np.testing.assert_array_equal(garr[k], rarr[k], err_msg=k)


def test_synthetic_batches_carry_audio_for_two_modalities():
    """``synthetic_batches`` adds audio for two input modalities and leaves
    the one-modality stream as it was."""
    cfg = Config()
    cfg.dvc.detr.feature_dim = D
    one = next(tanet.synthetic_batches(cfg, 3, 20, seed=5))
    cfg.dvc.input_modalities = ["video", "audio"]
    cfg.dataset.activity_net.audio_rescale_len = A_RESCALE
    two = next(tanet.synthetic_batches(cfg, 3, 20, seed=5))
    assert "audio_tensor" not in one and two["audio_tensor"].shape == (3, A_RESCALE, D)
    for k in ("video_tensor", "video_mask", "gt_segments", "cap_tokens"):
        np.testing.assert_array_equal(two[k], one[k])


def test_loader_raises_a_worker_error_and_stops_early():
    class Broken:
        def __len__(self):
            return 6

        def __getitem__(self, i):
            if i == 4:
                raise KeyError("no such video")
            return {"key": f"k{i}", "video_feature": np.zeros((3, D), np.float32),
                    "duration": 10.0, "gt_timestamps": [[1.0, 2.0]], "action_labels": [0],
                    "caption_tokens": [[2, 5, 3]], "raw_captions": ["x"]}

    loader = tloader.DataLoader(Broken(), 2, 1, video_rescale_len=4, max_gt=2,
                                max_caption_len=4, shuffle=False, num_prefetch=1)
    it = iter(loader)
    assert next(it)["keys"] == ["k0", "k1"]
    assert next(it)["keys"] == ["k2", "k3"]
    with pytest.raises(KeyError, match="no such video"):
        next(it)
    # leaving a loop early stops the worker thread
    import threading

    for batch in loader:
        break
    assert not any(t.name == "DataLoader" and t.is_alive() for t in threading.enumerate())


def test_vocab_pickles_load_across_packages(tmp_path):
    itos = ["<unk>", "<pad>", "<bos>", "<eos>", "man", "n't", "guitar"]
    jvocab.Vocab(itos).save(str(tmp_path / "j.pkl"))
    tvocab.Vocab(itos).save(str(tmp_path / "t.pkl"))
    t_from_j = tvocab.Vocab.load(str(tmp_path / "j.pkl"))
    j_from_t = jvocab.Vocab.load(str(tmp_path / "t.pkl"))
    assert t_from_j.itos == j_from_t.itos == itos
    assert t_from_j["guitar"] == 6 and t_from_j["zebra"] == t_from_j.unk_idx == 0
    assert "man" in t_from_j and "zebra" not in t_from_j
    assert t_from_j.lookup_tokens([4, 5]) == ["man", "n't"]
    assert (t_from_j.pad_idx, t_from_j.bos_idx, t_from_j.eos_idx) == (1, 2, 3)


def test_vocab_load_refuses_a_pickle_that_names_a_class(tmp_path):
    import pickle

    with open(tmp_path / "bad.pkl", "wb") as f:
        pickle.dump(["<unk>", np.float32(1.0)], f)
    with pytest.raises(pickle.UnpicklingError):
        tvocab.Vocab.load(str(tmp_path / "bad.pkl"))
