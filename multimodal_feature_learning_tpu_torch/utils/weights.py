"""Carry flax parameters into the port's modules.

Counterpart of the JAX ``utils/ref_bridge.py::transplant``, in the other
direction: a flat ``{"a||b||c": np.ndarray}`` dict of flax params, as
``tools/snapshot_ckpt.py`` writes it (``snapshots/*.npz``) or as a test
flattens a params tree, becomes the port's state_dict and is loaded with
``strict=True``, so a key left over on either side raises.

Key mapping: the collection key ``params`` is dropped (it comes first in a
module's own tree, second under the model's trees: ``proposal``,
``caption``, ``context_mask``, the multimodal family's ``bimodal``,
``video_context_mask``, ``audio_context_mask``, and the raw multimodal
family's ``video_backbone``, ``audio_backbone``); list members
``enc_layers_3`` (also ``enc_layers_mod_3``, ``dec_layers_mod_3``,
``decoder_3``, and the backbones' ``encoder_3``, ``spatial_encoder_3``,
``temporal_encoder_3``) become ``enc_layers.3``; the BiModalEncoder's
``layer_0`` and flax's automatic names inside a module (``LayerNorm_0``,
``MLP_0``) stay names, as the port's modules are named; ``Embed_0`` becomes
``embed``. Leaves: a Dense ``kernel`` (in, out) becomes ``weight`` (out,
in), a Conv ``kernel`` (k..., in, out) of rank 3, 4 or 5 becomes ``weight``
(out, in, k...), a norm ``scale`` and an ``embedding`` become ``weight``;
other params (``pos_embedding``, ``cls``, ``query_embedding``) keep their
names and layouts. ``BF16||``-prefixed uint16 leaves hold the
upper halves of bf16 values and are expanded to f32; ``__epoch__`` is skipped.

``export_flax_params`` goes the other way, so that parameters, gradients or
updated weights of the port can be compared with the JAX package's leaf by
leaf under flax names.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

SEP = "||"
BF16_PREFIX = "BF16" + SEP
_LISTS = ("enc_layers", "dec_layers", "enc_layers_mod", "dec_layers_mod", "decoder",
          "layers", "input_proj", "gn", "encoder", "spatial_encoder", "temporal_encoder")
_LIST_MEMBER = re.compile(r"^(" + "|".join(_LISTS) + r")_(\d+)$")
# the model's top-level trees, each a flax module tree of its own
_TREES = ("proposal", "caption", "context_mask", "bimodal", "video_context_mask",
          "audio_context_mask", "video_backbone", "audio_backbone")
# flax Conv kernels (k..., in, out) -> torch (out, in, k...), by rank
_TO_TORCH = {3: (2, 1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
_TO_FLAX = {3: (2, 1, 0), 4: (2, 3, 1, 0), 5: (2, 3, 4, 1, 0)}


def expand_bf16(u: np.ndarray) -> np.ndarray:
    """uint16 upper halves of bf16 values -> float32."""
    return (u.astype(np.uint32) << 16).view(np.float32)


def torch_key(flax_key: str) -> str:
    parts = flax_key.split(SEP)
    if "params" not in parts[:2] or len(parts) < 2:
        raise KeyError(f"not a flax params key: {flax_key!r}")
    parts.remove("params")
    out = []
    for p in parts[:-1]:
        m = _LIST_MEMBER.match(p)
        if m:
            out += [m.group(1), m.group(2)]
        elif p == "Embed_0":
            out.append("embed")
        else:
            out.append(p)
    leaf = parts[-1]
    out.append("weight" if leaf in ("kernel", "scale", "embedding") else leaf)
    return ".".join(out)


def _to_torch_layout(flax_key: str, arr: np.ndarray) -> np.ndarray:
    if flax_key.endswith(SEP + "kernel"):
        if arr.ndim == 2:
            return arr.T
        if arr.ndim in _TO_TORCH:
            return arr.transpose(_TO_TORCH[arr.ndim])
        raise ValueError(f"kernel of rank {arr.ndim} at {flax_key!r}")
    return arr


def flax_to_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat flax params (plain or ``BF16||`` keys) -> state_dict of f32 tensors."""
    sd = {}
    for key, arr in flat.items():
        if key == "__epoch__":
            continue
        arr = np.asarray(arr)
        if key.startswith(BF16_PREFIX):
            key = key[len(BF16_PREFIX):]
            arr = expand_bf16(arr)
        name = torch_key(key)
        if name in sd:
            raise KeyError(f"two flax keys map to {name!r}")
        sd[name] = torch.from_numpy(
            np.ascontiguousarray(_to_torch_layout(key, arr), dtype=np.float32))
    return sd


def load_flax_params(model: nn.Module, flat: Mapping[str, np.ndarray]) -> None:
    """Load flat flax params into ``model`` strictly: every key of both sides
    must be consumed and every shape must match, or this raises."""
    sd = flax_to_state_dict(flat)
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    if missing or unexpected:
        raise KeyError(f"weight carry: missing {missing[:8]} ({len(missing)}), "
                       f"unexpected {unexpected[:8]} ({len(unexpected)})")
    model.load_state_dict(sd, strict=True)


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """All arrays of a ``tools/snapshot_ckpt.py`` snapshot."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def flax_key(name: str, ndim: int) -> str:
    """Inverse of ``torch_key``: a state_dict name and the rank of its
    tensor -> the flax key (without the ``BF16||`` prefix). A ``weight`` of
    ``embed`` is an ``embedding``, of rank 1 a norm ``scale``, otherwise a
    ``kernel``."""
    parts = name.split(".")
    out = []
    i = 0
    while i < len(parts) - 1:
        p = parts[i]
        if p in _LISTS and i + 1 < len(parts) - 1 and parts[i + 1].isdigit():
            out.append(f"{p}_{parts[i + 1]}")
            i += 2
            continue
        out.append("Embed_0" if p == "embed" else p)
        i += 1
    leaf = parts[-1]
    if leaf == "weight":
        leaf = "embedding" if parts[-2] == "embed" else ("scale" if ndim == 1 else "kernel")
    out.append(leaf)
    out.insert(1 if out[0] in _TREES else 0, "params")
    return SEP.join(out)


def _to_flax_layout(arr: np.ndarray, key: str) -> np.ndarray:
    if key.endswith(SEP + "kernel"):
        return arr.T if arr.ndim == 2 else arr.transpose(_TO_FLAX[arr.ndim])
    return arr


def export_flax_params(source: Union[nn.Module, Mapping[str, torch.Tensor]]
                       ) -> Dict[str, np.ndarray]:
    """A module's state_dict, or any {state_dict name: tensor} mapping (a
    state_dict, or gradients by parameter name), as flat flax params
    {"a||b||c": f32 np.ndarray}: kernels transposed back to (in, out) or
    (k..., in, out). Inverse of ``flax_to_state_dict`` on plain f32 keys."""
    tensors = source.state_dict() if isinstance(source, nn.Module) else source
    out = {}
    for name, t in tensors.items():
        arr = t.detach().float().cpu().numpy()
        key = flax_key(name, arr.ndim)
        # a copy: the arrays must not follow the module's later updates
        out[key] = np.array(_to_flax_layout(arr, key), order="C", copy=True)
    return out
