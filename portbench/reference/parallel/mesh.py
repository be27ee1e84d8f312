"""The port's ``parallel/mesh.py`` as one process without a mesh sees it:
the plain reference runs on one device, so every collective is the
identity."""

from __future__ import annotations

import torch


def batch_shard():
    """The data axis' (rank, size) inside ``data_parallel``: never here."""
    return None


def global_sum(t: torch.Tensor) -> torch.Tensor:
    return t


def global_min(x: torch.Tensor) -> torch.Tensor:
    return x.min()
