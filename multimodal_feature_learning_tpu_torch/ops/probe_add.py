"""``x + 1``: the kernel of the per-op overhead probe (K5), its wrapper and
its plain version.

Counterpart of ``add_kernel`` / ``pallas_add`` of the JAX repository's
``tools/probe_op_overhead.py``, a Pallas kernel that maps the whole array to
one block. Here ``csrc/probe_add.cu``, bound with ``ctypes`` like the other
kernels of the port, so that the probe times a launch through the port's own
binding route. A tensor on the CPU takes ``probe_add_plain``; a CUDA tensor
goes to the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .build import KernelBinding


def probe_add_plain(x: torch.Tensor) -> torch.Tensor:
    """``x + 1`` in x's dtype (bf16 adds in f32 and rounds to nearest even)."""
    return x + 1


class ProbeAddKernel(KernelBinding):
    """``probe_add_launch`` (K5): float32 or bfloat16, any shape."""

    source, symbol = "probe_add.cu", "probe_add_launch"
    replaces = "tools/probe_op_overhead.py:59"
    # probe_add_launch(x, out, n, is_bf16, stream)
    argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_void_p]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type != "cuda":
            raise ValueError(f"the probe_add kernel takes CUDA tensors, got {x.device}")
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"probe_add takes float32 or bfloat16, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError("probe_add takes a contiguous tensor")
        out = torch.empty_like(x)
        if x.numel() == 0:
            return out
        fn = self._launcher()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = fn(x.data_ptr(), out.data_ptr(), x.numel(), int(x.dtype == torch.bfloat16),
                    stream)
        if rc != 0:
            raise RuntimeError(f"probe_add_launch failed with CUDA error {rc}")
        self.launches += 1
        return out


PROBE_ADD = ProbeAddKernel()


def probe_add(x: torch.Tensor) -> torch.Tensor:
    """``x + 1``: the kernel for a CUDA tensor, the plain version for a CPU
    tensor."""
    if x.device.type == "cpu":
        return probe_add_plain(x)
    return PROBE_ADD(x)
