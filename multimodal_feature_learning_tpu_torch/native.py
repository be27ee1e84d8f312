"""ctypes bindings of the native collate (``csrc/collate.cpp``); counterpart
of the JAX ``native.py``.

The library is built from the checkout's source with the host's C++
compiler into ``build/kernels/`` at first use (``ops/build.py``); a failed
build raises. ``MFL_DISABLE_NATIVE`` set to a non-empty value opts out, as
in JAX: the numpy versions below run instead. Both give the same arrays bit
for bit (the library only copies).
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Tuple

import numpy as np

from .ops.build import load_library

_lib: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    """The library, built and bound at the first call; None under
    ``MFL_DISABLE_NATIVE``."""
    global _lib
    if os.environ.get("MFL_DISABLE_NATIVE"):
        return None
    if _lib is None:
        lib = load_library("collate.cpp")
        # raw addresses of arrays whose dtype and layout the callers below
        # fix (numpy's checked ndpointer costs more than a mask's copy)
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        lib.resize_nearest_f32.argtypes = [ptr, ptr, i64, i64, i64, i64]
        lib.resize_nearest_u8.argtypes = [ptr, ptr, i64, i64, i64]
        lib.pad_resize_batch_f32.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64, i64]
        for fn in (lib.resize_nearest_f32, lib.resize_nearest_u8, lib.pad_resize_batch_f32):
            fn.restype = None
        _lib = lib
    return _lib


def available() -> bool:
    """Whether the library runs: False under ``MFL_DISABLE_NATIVE``;
    otherwise it is built now if it was not (raising if the build fails)."""
    return _load() is not None


def _take(x: np.ndarray, t_out: int) -> np.ndarray:
    """Nearest resize along axis 1 in numpy: out[:, i] = x[:, i * T // t_out]."""
    return np.take(x, (np.arange(t_out) * x.shape[1]) // t_out, axis=1)


def resize_nearest(x: np.ndarray, t_out: int) -> np.ndarray:
    """Nearest resize along axis 1 of a batch: f32 (B, T, D) and bool
    (B, T) in the library, anything else in numpy."""
    lib = _load()
    if lib is not None and x.ndim == 3 and x.dtype == np.float32:
        x = np.ascontiguousarray(x)
        out = np.empty((x.shape[0], t_out, x.shape[2]), dtype=np.float32)
        lib.resize_nearest_f32(x.ctypes.data, out.ctypes.data, x.shape[0], x.shape[1], t_out,
                               x.shape[2])
        return out
    if lib is not None and x.ndim == 2 and x.dtype == np.bool_:
        xin = np.ascontiguousarray(x).view(np.uint8)
        out = np.empty((x.shape[0], t_out), dtype=np.uint8)
        lib.resize_nearest_u8(xin.ctypes.data, out.ctypes.data, x.shape[0], x.shape[1], t_out)
        return out.view(np.bool_)
    return _take(x, t_out)


def pad_resize_batch(features: List[np.ndarray], t_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """Features (T_i, D) -> (B, t_out, D) f32 and the pad mask (B, t_out)
    bool (True = pad): zero-padded to the longest, then nearest-resized, in
    one pass of the library."""
    B, D = len(features), features[0].shape[1]
    lengths = np.array([f.shape[0] for f in features], dtype=np.int64)
    max_len = int(lengths.max())
    lib = _load()
    if lib is None:
        padded = np.zeros((B, max_len, D), dtype=np.float32)
        mask = np.ones((B, max_len), dtype=bool)
        for i, f in enumerate(features):
            padded[i, :f.shape[0]] = f
            mask[i, :f.shape[0]] = False
        return _take(padded, t_out), _take(mask, t_out)
    concat = np.concatenate(features, dtype=np.float32)  # one copy, C-contiguous
    offsets = np.zeros(B + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    out = np.empty((B, t_out, D), dtype=np.float32)
    out_mask = np.empty((B, t_out), dtype=np.uint8)
    lib.pad_resize_batch_f32(concat.ctypes.data, offsets.ctypes.data, out.ctypes.data,
                             out_mask.ctypes.data, B, max_len, t_out, D)
    return out, out_mask.view(np.bool_)
