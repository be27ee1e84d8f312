"""The port's native collate (``native.py``, ``csrc/collate.cpp`` built with
the host compiler) against the JAX package's ``native.py`` and numpy: the
nearest resize of f32 batches and bool masks and the fused pad-and-resize,
bit for bit (the library only copies); and a batch of the port's loader is
the same with the library and under ``MFL_DISABLE_NATIVE``."""

from __future__ import annotations

import numpy as np
import pytest

from multimodal_feature_learning_tpu import native as jnative
from multimodal_feature_learning_tpu_torch import native
from multimodal_feature_learning_tpu_torch.config import Config
from multimodal_feature_learning_tpu_torch.data.anet import nearest_resize, synthetic_samples
from multimodal_feature_learning_tpu_torch.data.loader import DataLoader
from multimodal_feature_learning_tpu_torch.ops import build


def test_the_library_is_built_from_the_port_s_source():
    assert native.available()
    lib = build.library_path("collate.cpp")
    assert lib.exists() and lib.parent == build.BUILD_DIR
    assert "collate.cpp" in build.HOST_SOURCES


@pytest.mark.parametrize("t_in,t_out", [(37, 11), (11, 37), (300, 300), (1, 5)])
def test_resize_equals_jax_and_numpy(t_in, t_out):
    rng = np.random.default_rng(t_in)
    x = rng.normal(size=(3, t_in, 5)).astype(np.float32)
    mask = rng.random((3, t_in)) > 0.5
    for a in (x, mask):
        got = native.resize_nearest(a, t_out)
        assert got.dtype == a.dtype and got.shape[:2] == (3, t_out)
        np.testing.assert_array_equal(got, nearest_resize(a, t_out, axis=1))
        np.testing.assert_array_equal(got, jnative.resize_nearest(a, t_out))
    ints = rng.integers(0, 9, size=(2, t_in))  # neither f32 nor bool: numpy in both
    np.testing.assert_array_equal(native.resize_nearest(ints, t_out),
                                  jnative.resize_nearest(ints, t_out))


@pytest.mark.parametrize("t_out", [16, 7])
def test_pad_resize_batch_equals_jax_and_numpy(t_out):
    rng = np.random.default_rng(t_out)
    feats = [rng.normal(size=(n, 4)).astype(np.float32) for n in (9, 3, 12)]
    got_x, got_m = native.pad_resize_batch(feats, t_out)
    ref_x, ref_m = jnative.pad_resize_batch(feats, t_out)
    np.testing.assert_array_equal(got_x, ref_x)
    np.testing.assert_array_equal(got_m, ref_m)
    padded = np.zeros((3, 12, 4), np.float32)
    mask = np.ones((3, 12), bool)
    for i, f in enumerate(feats):
        padded[i, :len(f)], mask[i, :len(f)] = f, False
    np.testing.assert_array_equal(got_x, nearest_resize(padded, t_out, axis=1))
    np.testing.assert_array_equal(got_m, nearest_resize(mask, t_out, axis=1))


# output bytes on each side of the library's kParallelBytes (64 MB): copied on
# the calling thread, and across threads
@pytest.mark.parametrize("dim", [64, 8192])
def test_serial_and_threaded_copies_equal_numpy(dim):
    rng = np.random.default_rng(dim)
    feats = [rng.normal(size=(n, dim)).astype(np.float32)
             for n in (100, 61, 87, 100, 5, 99, 100, 42)]
    got_x, got_m = native.pad_resize_batch(feats, 300)
    padded = np.zeros((8, 100, dim), np.float32)
    mask = np.ones((8, 100), bool)
    for i, f in enumerate(feats):
        padded[i, :len(f)], mask[i, :len(f)] = f, False
    ref_x = nearest_resize(padded, 300, axis=1)
    assert (ref_x.nbytes >= 64 << 20) == (dim == 8192)
    np.testing.assert_array_equal(got_x, ref_x)
    np.testing.assert_array_equal(got_m, nearest_resize(mask, 300, axis=1))
    np.testing.assert_array_equal(native.resize_nearest(padded, 300), ref_x)


def test_disable_native_opts_out(monkeypatch):
    monkeypatch.setenv("MFL_DISABLE_NATIVE", "1")
    assert not native.available()
    x = np.arange(24, dtype=np.float32).reshape(2, 4, 3)
    np.testing.assert_array_equal(native.resize_nearest(x, 3), nearest_resize(x, 3, axis=1))
    got_x, got_m = native.pad_resize_batch([x[0], x[1, :2]], 3)
    assert got_x.shape == (2, 3, 3) and got_m.tolist() == [[False] * 3, [False, False, True]]


def loader_batch(cfg) -> dict:
    samples = synthetic_samples(cfg, 6, 30, np.random.default_rng(4))
    loader = DataLoader(samples, batch_size=4, pad_idx=1, video_rescale_len=50,
                        shuffle=False, num_prefetch=1)
    return next(iter(loader))


def test_loader_batch_is_the_same_without_the_library(monkeypatch):
    cfg = Config()
    with_lib = loader_batch(cfg)
    monkeypatch.setenv("MFL_DISABLE_NATIVE", "1")
    without = loader_batch(cfg)
    assert with_lib.keys() == without.keys()
    for k, v in with_lib.items():
        if isinstance(v, np.ndarray):
            assert v.dtype == without[k].dtype
            np.testing.assert_array_equal(v, without[k], err_msg=k)
        else:
            assert v == without[k], k
    assert with_lib["video_tensor"].shape[1] == 50 and with_lib["video_mask"][:, -1].any()
