"""Weights made from the run's seed, on the model's device: one draw of
normal numbers for every parameter at once, from a ``torch.Generator`` on
that device, then each parameter takes its slice, in the order of the
parameters' names, at the scale a trained layer of its kind has. The same
seed gives the same weights to every module tree with the same names and
shapes: the port's model and the plain reference's."""

from __future__ import annotations

import torch
from torch import nn

NORMS = (nn.LayerNorm, nn.GroupNorm)


@torch.no_grad()
def fill_seeded(model: nn.Module, seed: int) -> None:
    """Overwrite every float parameter of ``model``: a matrix or a
    convolution N(0, 1 / fan_in), fan_in the elements of one output row; a
    normalisation's scale 1 + N(0, 0.02^2); every other vector (biases,
    normalisation shifts) N(0, 0.02^2)."""
    norm_params = {f"{m_name}.{p_name}" if m_name else p_name
                   for m_name, module in model.named_modules() if isinstance(module, NORMS)
                   for p_name, _ in module.named_parameters(recurse=False)}
    params = sorted((name, p) for name, p in model.named_parameters() if p.is_floating_point())
    device = params[0][1].device
    total = sum(p.numel() for _, p in params)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    draw = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    start = 0
    for name, p in params:
        z = draw[start:start + p.numel()].view(p.shape)
        start += p.numel()
        if p.dim() >= 2:
            z = z * p[0].numel() ** -0.5
        elif name in norm_params and name.endswith("weight"):
            z = 1.0 + 0.02 * z
        else:
            z = 0.02 * z
        p.copy_(z.to(p.dtype))
