"""MSDA of the plain reference: the plain core of the port's
``ops/ms_deform_attn.py`` (frozen beside this file), differentiated by
autograd. No kernel."""

from __future__ import annotations

from typing import Sequence

import torch

from .ms_deform_attn import ms_deform_attn_core


def check_msda_backend(name: str) -> None:
    """Every backend name computes the same function here."""


def ms_deform_attn(value: torch.Tensor, temporal_shapes: Sequence[int],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """value (B,S,H,Dh), loc and aw (B,Q,H,L,P) -> (B,Q,H*Dh)."""
    return ms_deform_attn_core(value, tuple(temporal_shapes), sampling_locations,
                               attention_weights)
