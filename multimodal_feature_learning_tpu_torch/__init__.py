"""PyTorch/CUDA port of the dense-video-captioning system.

Mirrors the layout of the JAX package ``multimodal_feature_learning_tpu``
(``config/``, ``ops/``, ``models/``, ``engine/``, ``data/``, ``serve.py``) so
each counterpart is easy to find. It imports torch, numpy and the standard
library only; every entry point runs on ``device="cuda"`` unless the caller
asks for the CPU.

The TPU's Pallas kernels become hand-written CUDA kernels under ``csrc/``,
compiled with ``nvcc`` for ``sm_90a`` at first use (``ops/build.py``).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
