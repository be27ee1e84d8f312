"""Mixed-precision policy; counterpart of the JAX ``utils/precision.py``.

With ``cfg.compute_dtype = "bfloat16"`` the master parameters and the
optimizer state stay float32 (unless ``cfg.master_dtype = "bfloat16"`` folds
them), and every forward runs over bf16 copies of the float parameters and
of the features: each matmul takes bf16 operands, accumulates in f32 and
rounds to bf16. Attention logits and softmaxes, normalisation statistics,
the caption head's log-softmax, the matcher and the criterion stay f32; the
cast sites are in the model code (``models/dvc.py``, ``models/layers.py``,
``models/caption_decoder.py``, ``ops/fused_decode.py``).

``params_in`` is the port's ``_cast_params``: inside it, each float
parameter of a module reads as its cast copy, made by a differentiable
``Tensor.to``, so gradients reach the masters in the masters' dtype.
``torch.autocast`` is not used: it chooses its own f32 and bf16 operations,
which are not the JAX package's cast sites.
"""

from __future__ import annotations

import contextlib
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float32": torch.float32, "f32": torch.float32, "": torch.float32}


def resolve_dtype(name: str) -> torch.dtype:
    """'bfloat16' | 'float32' (or 'bf16' | 'f32' | '') -> torch dtype;
    anything else raises."""
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}: one of 'float32', 'bfloat16'")
    return _DTYPES[name]


def cast_floating(obj: Any, dtype: torch.dtype) -> Any:
    """Every floating-point tensor in ``obj`` (a tensor, or dicts, lists and
    tuples of them, such as a state dict or an optimizer state) cast to
    ``dtype``; integer and bool tensors and other leaves pass through."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dtype) if obj.is_floating_point() else obj
    if isinstance(obj, dict):
        return type(obj)((k, cast_floating(v, dtype)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(cast_floating(v, dtype) for v in obj)
    return obj


@contextlib.contextmanager
def params_in(module: nn.Module, dtype: torch.dtype):
    """Inside the block each float parameter of ``module`` whose dtype is
    not ``dtype`` reads as ``param.to(dtype)``; on exit the parameters are
    put back. A parameter already in ``dtype`` (f32 compute, or folded bf16
    masters) is left as it is, so the f32 path runs exactly as without it.

    With gradients off (serving, evaluation) the cast copies are kept on
    ``module`` and reused while a parameter is unchanged (same tensor,
    storage and version counter, which every in-place update advances), so
    a server casts its weights once, not once a request; with gradients on
    each forward casts anew, on the autograd graph."""
    swapped = []
    cache = module.__dict__.setdefault("_compute_dtype_copies", {}) \
        if not torch.is_grad_enabled() else None
    try:
        for prefix, mod in module.named_modules():
            for name, p in list(mod._parameters.items()):
                if p is None or not p.is_floating_point() or p.dtype == dtype:
                    continue
                if cache is None:
                    cast = p.to(dtype)
                else:
                    key = (prefix, name, dtype)
                    hit = cache.get(key)
                    if hit is None or hit[0] is not p or hit[1] != (p._version, p.data_ptr()):
                        hit = cache[key] = (p, (p._version, p.data_ptr()), p.detach().to(dtype))
                    cast = hit[2]
                del mod._parameters[name]
                object.__setattr__(mod, name, cast)
                swapped.append((mod, name, p))
        yield module
    finally:
        for mod, name, p in reversed(swapped):
            object.__delattr__(mod, name)
            mod._parameters[name] = p


def linear_promoted(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)`` computed in the promoted dtype of ``x`` and the layer's
    weight, as flax's ``Dense`` computes an f32 input against bf16
    parameters (in f32); torch's own Linear refuses mixed dtypes."""
    dt = torch.promote_types(x.dtype, layer.weight.dtype)
    bias = None if layer.bias is None else layer.bias.to(dt)
    return F.linear(x.to(dt), layer.weight.to(dt), bias)
