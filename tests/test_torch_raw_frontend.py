"""The raw-ingest frontends of the port (``data/video_transforms.py``,
``data/audio.py``) against the JAX package's on the same numpy inputs from
a seed.

Tolerances: the frame transforms 1e-6 of the largest value (the resize's
weight matrices and normalisation are the same f32 arithmetic, summed in
another order); the mel banks and the nearest resample exactly; the mel
energies within 2e-6 of each frame's largest energy, and their logs within
1e-4 absolute wherever the energy is at least 1e-4 of the frame's largest.
The rfft is f32 in another library: its rounding is about 1e-7 of a frame's
energy, which in the log of a 128-mel bin that holds 1e-9 of the frame's
energy is up to 5e-4 (measured: 4.5e-4 on a 10 s wave, 6.4e-7 of the
frame's largest in energy)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_feature_learning_tpu.data import audio as jaudio
from multimodal_feature_learning_tpu.data import video_transforms as jvt
from multimodal_feature_learning_tpu_torch.data import audio as taudio
from multimodal_feature_learning_tpu_torch.data import video_transforms as tvt

ENERGY_REL, LOG_ATOL, LOG_FLOOR = 2e-6, 1e-4, 1e-4


def assert_fbank_close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    peak = np.exp(ref).max(axis=1, keepdims=True)
    assert (np.abs(np.exp(got) - np.exp(ref)) <= ENERGY_REL * peak).all()
    strong = np.exp(ref) >= LOG_FLOOR * peak
    assert strong.mean() > 0.5
    np.testing.assert_allclose(got[strong], ref[strong], rtol=0, atol=LOG_ATOL)


def frames(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=shape).astype(np.uint8)


def close(got, ref, rel=1e-6):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * float(np.abs(ref).max()))


@pytest.mark.parametrize("out_hw", [(16, 24), (50, 30), (37, 61), (20, 20)])
def test_resize_bilinear_equals_jax(out_hw):
    """Shrinking (antialiased, the kernel widened by the scale), growing,
    mixed and one axis unchanged."""
    x = frames((2, 3, 20, 40, 3))
    close(tvt.resize_bilinear(torch.from_numpy(x), *out_hw),
          jvt.resize_bilinear(jnp.asarray(x, jnp.float32), *out_hw))


def test_short_side_crop_normalize_and_clip_equal_jax():
    x = frames((3, 30, 44, 3), seed=1)
    for size in (24, 40):
        close(tvt.resize_short_side(torch.from_numpy(x), size),
              jvt.resize_short_side(jnp.asarray(x, jnp.float32), size))
    y = frames((3, 44, 30, 3), seed=2)  # the portrait branch
    close(tvt.resize_short_side(torch.from_numpy(y), 24),
          jvt.resize_short_side(jnp.asarray(y, jnp.float32), 24))
    np.testing.assert_array_equal(tvt.center_crop(torch.from_numpy(x), 16).numpy(),
                                  np.asarray(jvt.center_crop(jnp.asarray(x), 16)))
    close(tvt.normalize(torch.from_numpy(x)), jvt.normalize(jnp.asarray(x)))
    assert tvt.normalize(torch.from_numpy(x)).dtype == torch.float32
    close(tvt.preprocess_clip(torch.from_numpy(x), resize_size=24, crop_size=20),
          jvt.preprocess_clip(jnp.asarray(x), resize_size=24, crop_size=20))


def test_random_hflip_flips_the_whole_clip_from_the_generator():
    x = torch.from_numpy(frames((2, 4, 6, 3)))
    flips = {bool((tvt.random_hflip(x, torch.Generator().manual_seed(s)) != x).any())
             for s in range(16)}
    assert flips == {True, False}
    np.testing.assert_array_equal(tvt.random_hflip(x, p=1.0).numpy(), x.numpy()[:, :, ::-1])
    a = tvt.preprocess_clip(x, train=True, generator=torch.Generator().manual_seed(3),
                            resize_size=4, crop_size=4)
    b = tvt.preprocess_clip(x, train=True, generator=torch.Generator().manual_seed(3),
                            resize_size=4, crop_size=4)
    assert torch.equal(a, b)


@pytest.mark.parametrize("T,n", [(9, 5), (720, 300), (7, 300), (300, 300), (2, 1), (301, 64)])
def test_temporal_resample_nearest_equals_jax(T, n):
    x = np.arange(T)[:, None, None, None] * np.ones((1, 2, 2, 3), np.int64)
    np.testing.assert_array_equal(tvt.temporal_resample_nearest(x, n),
                                  np.asarray(jvt.temporal_resample_nearest(jnp.asarray(x), n)))


@pytest.mark.parametrize("bins,padded,sr", [(128, 512, 16000.0), (40, 512, 16000.0),
                                            (23, 256, 8000.0)])
def test_mel_banks_equal_jax(bins, padded, sr):
    np.testing.assert_array_equal(taudio.mel_banks(bins, padded, sr),
                                  jaudio.mel_banks(bins, padded, sr))
    freqs = np.array([20.0, 440.0, 4000.0])
    np.testing.assert_array_equal(taudio.inverse_mel_scale(taudio.mel_scale(freqs)),
                                  jaudio.inverse_mel_scale(jaudio.mel_scale(freqs)))


@pytest.mark.parametrize("n_samples,bins", [(16000, 128), (10720, 16), (4000, 64)])
def test_fbank_equals_jax(n_samples, bins):
    wave = (np.random.default_rng(n_samples).normal(size=n_samples) * 0.1).astype(np.float32)
    ref = np.asarray(jaudio.fbank(jnp.asarray(wave), 16000.0, bins))
    got = taudio.fbank(torch.from_numpy(wave), 16000.0, bins).numpy()
    assert_fbank_close(got, ref)
    for target in (8, 64, 200):  # cut and zero-padded
        ref = np.asarray(jaudio.aframes_to_fbank(jnp.asarray(wave), 16000.0, bins, target))
        got = taudio.aframes_to_fbank(torch.from_numpy(wave), 16000.0, bins, target).numpy()
        n = min(target, 1 + (n_samples - 400) // 160)
        assert_fbank_close(got[:n], ref[:n])
        assert (got[n:] == 0).all() and (ref[n:] == 0).all()


@pytest.mark.parametrize("n_samples", [0, 300, 400, 5000, 10720, 64 * 160 + 240, 32000])
def test_static_fbank_equals_jax_with_zeros_past_the_true_count(n_samples):
    """The fixed-length variant of the loader: frames past the wave's true
    frame count are exactly 0, as JAX's."""
    wave = (np.random.default_rng(7).normal(size=n_samples) * 0.1).astype(np.float32)
    ref = jaudio.aframes_to_fbank_static(wave, 16000.0, 16, 64)
    got = taudio.aframes_to_fbank_static(wave, 16000.0, 16, 64)
    assert got.shape == ref.shape == (64, 16) and got.dtype == np.float32
    valid = min(max(1 + (n_samples - 400) // 160, 0), 64)
    assert (got[valid:] == 0).all() and (ref[valid:] == 0).all()
    if valid:
        assert_fbank_close(got[:valid], ref[:valid])
