"""Tensor-parallel placement of the parameters over the mesh's "model"
axis; counterpart of the JAX ``parallel/tp.py``, with its rules, matched on
the last two names of each parameter path:

  column-parallel (output features split over "model"):
    linear1, fully_connected_1 (FFN up-projection), q/k/v_linear,
    head (caption vocabulary)       weight Shard(0), bias Shard(0)
  row-parallel (input features split, partial products summed):
    linear2, fully_connected_2, projection_layer
                                    weight Shard(1), bias Replicate()
  everything else, MSDA's projections included: Replicate().

(torch keeps a weight as (out, in), so flax's kernel ``P(None, ax)`` is
dim 0 here and ``P(ax, None)`` dim 1.)

JAX places the parameters and GSPMD inserts the collectives; here each
matching ``Linear`` becomes a ``ColumnParallelLinear`` or
``RowParallelLinear`` holding its slice of the same ``Parameter`` (the
optimizer's references stay valid). A module that names its feed-forward
block in ``tp_ffn`` (column layer, hidden dropout, row layer) gets the
Megatron pairing: the column layer keeps its slice of the hidden features,
its dropout draws the full mask and keeps the same columns, and the row
layer multiplies that slice, so the block costs one all-reduce forward and
one backward. Elsewhere a column-parallel layer gathers its output over the
group (``output_layouts=Replicate()``) and a row-parallel one takes its
slice of a replicated input and sums the partial products with one
all-reduce, so every module outside these layers sees the tensors of the
one-process model: the attention keeps its global head count, and the
caption head's log-softmax and argmax read the whole vocabulary row.
Uneven splits (the 6563-word vocabulary over 2) give the lower ranks one
more row. Checkpoints hold the gathered, unsharded state
(``engine/state.py``).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .mesh import (MODEL, _all_gather_cat, axis_group, copy_to_group, gather_from_group,
                   reduce_from_group, split_sizes, split_to_group)

_COL = ("linear1", "fully_connected_1", "q_linear", "k_linear", "v_linear", "head")
_ROW = ("linear2", "fully_connected_2", "projection_layer")


def _rule(module_name: str, module: nn.Module):
    """"col", "row" or None for a module at ``module_name``."""
    last = module_name.rsplit(".", 1)[-1]
    if not isinstance(module, nn.Linear):
        return None
    if last in _COL:
        return "col"
    if last in _ROW:
        return "row"
    return None


def tp_param_specs(model: nn.Module) -> Dict[str, object]:
    """{parameter name: its DTensor placement on the "model" axis} under
    the rules above."""
    from torch.distributed.tensor import Replicate, Shard

    specs = {name: Replicate() for name, _ in model.named_parameters()}
    for mname, module in model.named_modules():
        rule = _rule(mname, module)
        if rule == "col":
            specs[f"{mname}.weight"] = Shard(0)
            if module.bias is not None:
                specs[f"{mname}.bias"] = Shard(0)
        elif rule == "row":
            specs[f"{mname}.weight"] = Shard(1)
    return specs


def _mark(p: nn.Parameter, dim: int, group, sizes) -> None:
    p._mfl_tp = (dim, group, list(sizes))


def tp_shard_info(p: torch.Tensor):
    """(dim, group, sizes) of a tensor-parallel parameter, else None."""
    return getattr(p, "_mfl_tp", None)


def _narrow_(p: nn.Parameter, dim: int, group, sizes) -> None:
    r = dist.get_rank(group)
    with torch.no_grad():
        p.data = p.data.narrow(dim, sum(sizes[:r]), sizes[r]).clone()
    _mark(p, dim, group, sizes)


def _linear(x, weight, bias):
    """``models.layers.Linear``'s rounding: outside f32 the product is
    rounded before the bias is added."""
    if x.dtype == torch.float32 or bias is None:
        return F.linear(x, weight, bias)
    return F.linear(x, weight) + bias


class ColumnParallelLinear(nn.Module):
    """A ``Linear`` whose output features are split over ``group``. With
    ``gather`` the output is gathered, so the layer's caller sees the full
    features; without, the caller gets this rank's slice of them."""

    def __init__(self, linear: nn.Linear, group, gather: bool = True):
        super().__init__()
        self.in_features, self.out_features = linear.in_features, linear.out_features
        self.group, self.gather = group, gather
        self.sizes = split_sizes(linear.out_features, dist.get_world_size(group))
        _narrow_(linear.weight, 0, group, self.sizes)
        if linear.bias is not None:
            _narrow_(linear.bias, 0, group, self.sizes)
        self.weight, self.bias = linear.weight, linear.bias

    def forward(self, x):
        y = _linear(copy_to_group(x, self.group), self.weight, self.bias)
        return gather_from_group(y, self.group, -1, self.sizes) if self.gather else y


class RowParallelLinear(nn.Module):
    """A ``Linear`` whose input features are split over ``group``: each
    rank multiplies its slice of the input, one all-reduce sums the
    products, and the bias is added once. With ``split`` the input is
    replicated and the rank takes its slice; without, the input is the
    slice already (a paired column layer's output)."""

    def __init__(self, linear: nn.Linear, group, split: bool = True):
        super().__init__()
        self.in_features, self.out_features = linear.in_features, linear.out_features
        self.group, self.split = group, split
        self.sizes = split_sizes(linear.in_features, dist.get_world_size(group))
        _narrow_(linear.weight, 1, group, self.sizes)
        self.weight, self.bias = linear.weight, linear.bias

    def forward(self, x):
        if self.split:
            x = split_to_group(x, self.group, -1, self.sizes)
        y = reduce_from_group(F.linear(x, self.weight), self.group)
        return y if self.bias is None else y + self.bias


def _ffn_pairs(model: nn.Module) -> Dict[str, str]:
    """{column layer: hidden dropout} and {row layer: ""} of the ``tp_ffn``
    blocks (the rules make their first layer column-parallel and their
    second row-parallel)."""
    paired = {}
    for mname, module in model.named_modules():
        ffn = getattr(module, "tp_ffn", None)
        if ffn is not None:
            col, drop, row = (f"{mname}.{n}" if mname else n for n in ffn)
            paired[col], paired[row] = drop, ""
    return paired


def shard_params_tp(model: nn.Module, mesh, axis: str = MODEL) -> nn.Module:
    """Place ``model``'s parameters tensor-parallel over ``axis`` in place,
    as ``tp_param_specs`` places them (every rank keeps its slice of each
    matching layer); the other parameters stay as they are, replicated. The
    fused decode reads the caption layers' weights whole and is refused
    here."""
    from torch.distributed.tensor import Shard

    if getattr(model, "decode_impl", "xla") == "fused":
        raise ValueError("the fused decode reads whole caption weights: "
                         "tensor parallelism takes decode_impl='xla'")
    group = axis_group(mesh, axis)
    if dist.get_world_size(group) == 1:
        return model
    specs = tp_param_specs(model)
    paired = _ffn_pairs(model)
    for mname, module in list(model.named_modules()):
        spec = specs.get(f"{mname}.weight")
        if spec not in (Shard(0), Shard(1)):
            continue
        parent_name, _, last = mname.rpartition(".")
        parent = model.get_submodule(parent_name) if parent_name else model
        if spec == Shard(0):
            layer = ColumnParallelLinear(module, group, gather=mname not in paired)
            if paired.get(mname):
                r = dist.get_rank(group)
                model.get_submodule(paired[mname]).feature_split = (
                    sum(layer.sizes[:r]), module.out_features)
        else:
            layer = RowParallelLinear(module, group, split=mname not in paired)
        setattr(parent, last, layer)
    return model


def shard_tensor_like(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """This rank's slice of a full tensor shaped as ``p`` was before the
    placement (an AdamW moment), as ``p``'s own slice."""
    info = tp_shard_info(p)
    if info is None:
        return t
    dim, group, sizes = info
    r = dist.get_rank(group)
    return t.narrow(dim, sum(sizes[:r]), sizes[r]).clone()


def gather_tensor_like(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The full tensor of which ``t`` is this rank's slice, sliced as the
    tensor-parallel ``p`` is (a collective of ``p``'s group); ``t`` as it is
    for a replicated ``p``."""
    info = tp_shard_info(p)
    if info is None:
        return t
    dim, group, sizes = info
    return _all_gather_cat(t, dim, sizes, group)


def sharded_sq_norm(tensors_and_params) -> torch.Tensor | None:
    """Sum of squares over the tensor-parallel (tensor, param) pairs, summed
    over their groups; None when there are none."""
    total, group = None, None
    for t, p in tensors_and_params:
        info = tp_shard_info(p)
        if info is None:
            continue
        group = info[1]
        sq = t.float().pow(2).sum()
        total = sq if total is None else total + sq
    if total is None:
        return None
    dist.all_reduce(total, group=group)
    return total
