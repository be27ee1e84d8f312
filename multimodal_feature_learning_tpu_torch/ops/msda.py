"""Multi-scale deformable attention: the CUDA kernels' wrappers and the
autograd Function that joins them.

Counterpart of the JAX ``ops/pallas_msda.py::ms_deform_attn_pallas`` and its
custom VJP, which the model reaches with ``msda_backend="pallas"``. A tensor
on the CPU goes to the plain core and its plain backward
(``ops/ms_deform_attn.py``); a tensor on a CUDA device goes to the
hand-written kernels ``csrc/msda_fwd.cu`` (K1) and ``csrc/msda_bwd.cu`` (K2)
or raises. There is no fallback from a kernel to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from .build import KernelBinding
from .ms_deform_attn import ms_deform_attn_core, ms_deform_attn_core_backward


def _check_msda_args(value, shapes, loc, aw):
    """Shapes, dtypes, devices and contiguity that both kernels take."""
    if value.device.type != "cuda":
        raise ValueError(f"the MSDA kernels take CUDA tensors, got {value.device}")
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
    return B, S, H, Dh, Q, L, P


class MsdaForwardKernel(KernelBinding):
    """``msda_fwd_launch`` (K1)."""

    source, symbol = "msda_fwd.cu", "msda_fwd_launch"
    # msda_fwd_launch(value, loc, aw, out, B, S, H, Dh, Q, L, P, level_T,
    #                 value_is_bf16, stream)
    argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p]

    def __call__(self, value, temporal_shapes, loc, aw):
        """The forward alone: its output carries no autograd history, so it
        refuses inputs that would need one. Differentiable callers go
        through ``ms_deform_attn`` (``MSDeformAttnFunction``)."""
        if torch.is_grad_enabled() and any(t.requires_grad for t in (value, loc, aw)):
            raise RuntimeError(
                "MSDA_FWD was called with inputs that require grad while grad "
                "mode is on; its output would cut the autograd graph. Call "
                "ops.msda.ms_deform_attn, which differentiates through K2")
        shapes = [int(t) for t in temporal_shapes]
        if value.device.type == "cuda" and value.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"value must be float32 or bfloat16, got {value.dtype}")
        B, S, H, Dh, Q, L, P = _check_msda_args(value, shapes, loc, aw)
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


class MsdaBackwardKernel(KernelBinding):
    """``msda_bwd_launch`` (K2); f32 value only."""

    source, symbol = "msda_bwd.cu", "msda_bwd_launch"
    # msda_bwd_launch(value, loc, aw, g, dvalue, dloc, daw, B, S, H, Dh, Q,
    #                 L, P, level_T, stream)
    argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]

    def __call__(self, value, temporal_shapes, loc, aw, grad_out):
        """(dvalue (B,S,H,Dh), dloc, daw (B,Q,H,L,P)), all f32."""
        shapes = [int(t) for t in temporal_shapes]
        if value.device.type == "cuda" and value.dtype != torch.float32:
            raise TypeError(f"the MSDA backward kernel takes float32 value, got {value.dtype}")
        B, S, H, Dh, Q, L, P = _check_msda_args(value, shapes, loc, aw)
        if grad_out.shape != (B, Q, H * Dh) or grad_out.dtype != torch.float32 \
                or grad_out.device != value.device or not grad_out.is_contiguous():
            raise ValueError(
                f"grad_out must be a contiguous float32 ({B}, {Q}, {H * Dh}) tensor on "
                f"{value.device}, got {tuple(grad_out.shape)} {grad_out.dtype} "
                f"on {grad_out.device}")
        if Dh > 256 or L > 16:
            raise ValueError(f"unsupported widths Dh={Dh}, L={L}")

        dvalue = torch.zeros_like(value)
        dloc = torch.empty_like(loc)
        daw = torch.empty_like(aw)
        if loc.numel() == 0:
            return dvalue, dloc, daw
        fn = self._launcher()
        level_T = (ctypes.c_int * L)(*shapes)
        with torch.cuda.device(value.device):
            stream = torch.cuda.current_stream(value.device).cuda_stream
            rc = fn(value.data_ptr(), loc.data_ptr(), aw.data_ptr(), grad_out.data_ptr(),
                    dvalue.data_ptr(), dloc.data_ptr(), daw.data_ptr(),
                    B, S, H, Dh, Q, L, P, level_T, stream)
        if rc != 0:
            raise RuntimeError(f"msda_bwd_launch failed with CUDA error {rc}")
        self.launches += 1
        return dvalue, dloc, daw


MSDA_BWD = MsdaBackwardKernel()


class MSDeformAttnFunction(torch.autograd.Function):
    """MSDA with its backward: K1 and K2 on a CUDA tensor, the plain core and
    the plain backward on the CPU. Saves value, loc and aw."""

    @staticmethod
    def forward(ctx, value, temporal_shapes, loc, aw):
        shapes = tuple(int(t) for t in temporal_shapes)
        ctx.shapes = shapes
        ctx.save_for_backward(value, loc, aw)
        if value.device.type == "cpu":
            return ms_deform_attn_core(value, shapes, loc, aw)
        return MSDA_FWD(value, shapes, loc, aw)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, aw = ctx.saved_tensors
        grad_out = grad_out.contiguous()
        if value.device.type == "cpu":
            dvalue, dloc, daw = ms_deform_attn_core_backward(
                value, ctx.shapes, loc, aw, grad_out)
        else:
            dvalue, dloc, daw = MSDA_BWD(value, ctx.shapes, loc, aw, grad_out)
        return dvalue, None, dloc, daw


def ms_deform_attn(
    value: torch.Tensor,
    temporal_shapes: Sequence[int],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """Same contract as ``ms_deform_attn_core``: value (B,S,H,Dh), loc and
    aw (B,Q,H,L,P) -> (B,Q,H*Dh), differentiable in all three."""
    return MSDeformAttnFunction.apply(value, tuple(temporal_shapes),
                                      sampling_locations, attention_weights)
