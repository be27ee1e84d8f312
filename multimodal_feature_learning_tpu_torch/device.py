"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``.

    The port runs on the GPU unless the caller names the CPU. A CUDA device
    on a host without one raises instead of quietly running on the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def set_f32_numerics(dev: torch.device) -> None:
    """Full-f32 matmuls and convolutions on the GPU.

    cuDNN's default is TF32 for f32 convolutions, which keeps about three
    decimal digits; the f32 path of the port is held against an f32
    reference, so TF32 is switched off for matmuls and convolutions alike.
    """
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def to_host(*tensors: torch.Tensor) -> List[np.ndarray]:
    """Copies of ``tensors`` on the host as numpy arrays, behind one
    synchronisation of the current CUDA stream."""
    host = [t.to("cpu", non_blocking=True, copy=True) for t in tensors]
    for dev in {t.device for t in tensors if t.is_cuda}:
        torch.cuda.current_stream(dev).synchronize()
    return [h.numpy() for h in host]


def host_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A small tensor of host ``values`` on ``device`` without a host
    synchronisation: on the card it crosses from pinned memory with an
    asynchronous copy (a copy from pageable memory waits for the stream),
    so a train step that builds one can be queued ahead of the device."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.tensor(values, dtype=dtype, pin_memory=True).to(device, non_blocking=True)
    return torch.tensor(values, dtype=dtype, device=device)
