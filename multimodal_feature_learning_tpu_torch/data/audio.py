"""Kaldi-compatible log-mel filterbank features; the port's copy of the JAX
package's ``data/audio.py``.

``torchaudio.compliance.kaldi.fbank(htk_compat=True, use_energy=False,
window_type='hanning', dither=0.0, frame_shift=10)`` on a mean-subtracted
waveform, cut or zero-padded to ``target_length`` frames: snip-edges
framing, per-frame DC removal, 0.97 preemphasis, Hanning window, the power
spectrum of an f32 rfft over the window padded to a power of two, triangular
mel banks on mel(f) = 1127 ln(1 + f / 700), natural-log energies floored at
``EPSILON``. It runs on the host, in the loader, on the CPU.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

EPSILON = 1.1920928955078125e-07  # float32 eps, Kaldi's log floor


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


def inverse_mel_scale(mel):
    return 700.0 * (np.exp(mel / 1127.0) - 1.0)


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


@functools.lru_cache(maxsize=8)
def mel_banks(num_bins: int, window_length_padded: int, sample_freq: float,
              low_freq: float = 20.0, high_freq: float = 0.0) -> np.ndarray:
    """(num_bins, num_fft_bins) f32 triangular mel filterbank, Kaldi's
    semantics, computed in float64 point by point as JAX's. Cached: the
    caller must not write to it."""
    num_fft_bins = window_length_padded // 2
    nyquist = 0.5 * sample_freq
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    fft_bin_width = sample_freq / window_length_padded
    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    bins = np.zeros((num_bins, num_fft_bins), dtype=np.float32)
    for b in range(num_bins):
        left = mel_low + b * mel_delta
        center = mel_low + (b + 1) * mel_delta
        right = mel_low + (b + 2) * mel_delta
        for i in range(num_fft_bins):
            mel = mel_scale(fft_bin_width * i)
            if left < mel < right:
                if mel <= center:
                    bins[b, i] = (mel - left) / (center - left)
                else:
                    bins[b, i] = (right - mel) / (right - center)
    bins.setflags(write=False)
    return bins


def fbank(waveform: torch.Tensor, sample_frequency: float = 16000.0,
          num_mel_bins: int = 128, frame_length_ms: float = 25.0,
          frame_shift_ms: float = 10.0, preemphasis_coefficient: float = 0.97,
          remove_dc_offset: bool = True) -> torch.Tensor:
    """Log-mel filterbank energies (num_frames, num_mel_bins) of an f32
    waveform (num_samples,) or (1, num_samples)."""
    waveform = waveform.reshape(-1).float()
    window_size = int(sample_frequency * frame_length_ms / 1000)
    window_shift = int(sample_frequency * frame_shift_ms / 1000)
    padded = _next_pow2(window_size)
    n = waveform.shape[0]
    num_frames = max(1 + (n - window_size) // window_shift, 0)  # snip_edges

    idx = (torch.arange(num_frames)[:, None] * window_shift
           + torch.arange(window_size)[None, :])
    frames = waveform[idx]  # (F, W)
    if remove_dc_offset:
        frames = frames - frames.mean(dim=1, keepdim=True)
    if preemphasis_coefficient:
        prev = torch.cat([frames[:, :1], frames[:, :-1]], dim=1)
        frames = frames - preemphasis_coefficient * prev
    # Kaldi 'hanning': 0.5 - 0.5 cos(2 pi n / (N - 1))
    window = 0.5 - 0.5 * torch.cos(
        2 * math.pi * torch.arange(window_size, dtype=torch.float32) / (window_size - 1))
    frames = torch.nn.functional.pad(frames * window, (0, padded - window_size))
    spectrum = torch.fft.rfft(frames, dim=1).abs() ** 2  # (F, padded // 2 + 1)
    spectrum = spectrum[:, :padded // 2]  # Kaldi drops the Nyquist bin for the mel
    banks = torch.from_numpy(mel_banks(num_mel_bins, padded, float(sample_frequency)).copy())
    return torch.log(torch.clamp(spectrum @ banks.T, min=EPSILON))


def aframes_to_fbank(aframes: torch.Tensor, sample_frequency: float, num_mel_bins: int,
                     target_length: int) -> torch.Tensor:
    """The whole wave's mean subtracted, the fbank, cut or zero-padded to
    ``target_length`` frames: (target_length, num_mel_bins)."""
    aframes = aframes.reshape(-1).float()
    fb = fbank(aframes - aframes.mean(), sample_frequency, num_mel_bins)
    n = fb.shape[0]
    if n >= target_length:
        return fb[:target_length]
    return torch.nn.functional.pad(fb, (0, 0, 0, target_length - n))


def aframes_to_fbank_static(aframes: np.ndarray, sample_frequency: float, num_mel_bins: int,
                            target_length: int) -> np.ndarray:
    """``aframes_to_fbank`` over a wave of fixed length, as JAX's static
    variant: the full wave's mean subtracted on the host, then the wave cut
    or zero-padded to the window + (target_length - 1) shifts that the
    output can see, and the frames past the wave's true frame count set to
    exactly 0. Returns a (target_length, num_mel_bins) f32 numpy array."""
    wave = np.asarray(aframes, dtype=np.float32).reshape(-1)
    window_size = int(sample_frequency * 25.0 / 1000)
    window_shift = int(sample_frequency * 10.0 / 1000)
    n_needed = window_size + (target_length - 1) * window_shift
    n = wave.shape[0]
    num_valid = min(max(1 + (n - window_size) // window_shift, 0), target_length)
    if n:
        wave = wave - wave.mean()
    wave = wave[:n_needed] if n >= n_needed else np.pad(wave, (0, n_needed - n))
    fb = fbank(torch.from_numpy(np.ascontiguousarray(wave)), float(sample_frequency),
               int(num_mel_bins)).numpy()
    fb[num_valid:] = 0.0
    return fb
