"""Multi-scale deformable attention: the CUDA kernel's wrapper.

Counterpart of the JAX ``ops/pallas_msda.py::ms_deform_attn_pallas``, which
the model reaches with ``msda_backend="pallas"``. A tensor on the CPU goes to
the plain core (``ms_deform_attn_core``); a tensor on a CUDA device goes to
the hand-written kernel ``csrc/msda_fwd.cu`` or raises. There is no fallback
from the kernel to the plain core.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from .build import load_library
from .ms_deform_attn import ms_deform_attn_core


class MsdaForwardKernel:
    """ctypes binding of ``msda_fwd_launch``. ``launches`` counts the kernel
    launches it made; nothing else changes it but a caller resetting it."""

    source = "msda_fwd.cu"
    # msda_fwd_launch(value, loc, aw, out, B, S, H, Dh, Q, L, P, level_T,
    #                 value_is_bf16, stream)
    argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p]

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _launcher(self):
        if self._fn is None:
            fn = load_library(self.source).msda_fwd_launch
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, value, temporal_shapes, loc, aw):
        shapes = [int(t) for t in temporal_shapes]
        if value.device.type != "cuda":
            raise ValueError(f"the MSDA kernel takes CUDA tensors, got {value.device}")
        if value.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"value must be float32 or bfloat16, got {value.dtype}")
        if value.dim() != 4 or loc.dim() != 5:
            raise ValueError(
                f"expected value (B,S,H,Dh) and loc (B,Q,H,L,P), got "
                f"{tuple(value.shape)} and {tuple(loc.shape)}")
        B, S, H, Dh = value.shape
        _, Q, _, L, P = loc.shape
        if loc.shape != (B, Q, H, len(shapes), P) or aw.shape != loc.shape:
            raise ValueError(
                f"loc {tuple(loc.shape)} / aw {tuple(aw.shape)} do not match "
                f"value {tuple(value.shape)} and {len(shapes)} levels")
        if sum(shapes) != S:
            raise ValueError(f"sum(temporal_shapes)={sum(shapes)} != S={S}")
        for name, t in (("loc", loc), ("aw", aw)):
            if t.dtype != torch.float32:
                raise TypeError(f"{name} must be float32, got {t.dtype}")
            if t.device != value.device:
                raise ValueError(f"{name} is on {t.device}, value on {value.device}")
        if not (value.is_contiguous() and loc.is_contiguous() and aw.is_contiguous()):
            raise ValueError("value, loc and aw must be contiguous")
        if Dh > 1024 or L > 16 or 2 * L * P * max(1, 256 // Dh) * 4 > 48 * 1024:
            raise ValueError(f"unsupported widths Dh={Dh}, L={L}, P={P}")

        out = torch.empty((B, Q, H * Dh), dtype=value.dtype, device=value.device)
        if out.numel() == 0:
            return out
        fn = self._launcher()
        level_T = (ctypes.c_int * L)(*shapes)
        with torch.cuda.device(value.device):
            stream = torch.cuda.current_stream(value.device).cuda_stream
            rc = fn(value.data_ptr(), loc.data_ptr(), aw.data_ptr(), out.data_ptr(),
                    B, S, H, Dh, Q, L, P, level_T,
                    int(value.dtype == torch.bfloat16), stream)
        if rc != 0:
            raise RuntimeError(f"msda_fwd_launch failed with CUDA error {rc}")
        self.launches += 1
        return out


MSDA_FWD = MsdaForwardKernel()


def ms_deform_attn(
    value: torch.Tensor,
    temporal_shapes: Sequence[int],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """Same contract as ``ms_deform_attn_core``: value (B,S,H,Dh), loc and
    aw (B,Q,H,L,P) -> (B,Q,H*Dh)."""
    if value.device.type == "cpu":
        return ms_deform_attn_core(value, temporal_shapes, sampling_locations,
                                   attention_weights)
    return MSDA_FWD(value, temporal_shapes, sampling_locations, attention_weights)
