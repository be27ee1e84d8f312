"""Host-side feature helpers; the port's copy of what it needs from the JAX
``data/anet.py``."""

from __future__ import annotations

import numpy as np


def nearest_resize(x: np.ndarray, new_size: int, axis: int = 1) -> np.ndarray:
    """``F.interpolate(mode='nearest')`` semantics along ``axis``:
    out[i] = in[floor(i * T_in / T_out)]."""
    t_in = x.shape[axis]
    idx = (np.arange(new_size) * t_in) // new_size
    return np.take(x, idx, axis=axis)
