"""Process groups, the ("data", "model") mesh and the collectives of the
port's parallel paths; counterpart of the JAX ``parallel/mesh.py``.

JAX runs one program over a global mesh and lets GSPMD insert the
collectives. Here every process runs its own eager program on its rows of
the global batch, and the collectives are explicit:

- ``maybe_initialize_distributed`` joins the process group that torchrun's
  environment describes (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``, ``MASTER_PORT``): gloo on the CPU, NCCL on the card with
  one rank to a device, gloo over CUDA tensors when ranks share a device
  (NCCL refuses two ranks on one device). Without that environment nothing
  is initialised and the port runs its plain one-process path.
- ``make_mesh`` lays the ranks out as a ``DeviceMesh`` with dims ("data",
  "model"). Ranks of one "model" group hold the same rows of the batch; the
  "data" axis splits the batch.
- Under ``data_parallel(mesh)`` the model and the criterion see the rank's
  rows as rows of the global batch: ``global_sum`` makes a criterion's
  normaliser the global one, ``global_min`` a batch-wide minimum, and
  ``batch_shard`` tells ``models.layers.Dropout`` to draw the global mask
  and keep the rank's rows. The gradients are then summed over the data
  axis (``sync_grads``), so every rank holds the global batch's gradient.
- ``copy_to_group`` / ``reduce_from_group`` / ``gather_from_group`` /
  ``split_to_group`` are the autograd pairs of the model axis (the
  tensor-parallel layers of ``parallel/tp.py`` and the token-axis split of
  ``models/dvc.py``). A consumer after a gather is replicated, so the
  gather's backward keeps the rank's slice of the (identical) gradient
  rather than summing it.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA, MODEL = "data", "model"

_DATA_SHARD = contextvars.ContextVar("data_shard", default=None)


def maybe_initialize_distributed(device: str | torch.device = "cuda") -> bool:
    """Join the process group torchrun's environment describes; returns
    whether the process is one of a group. Gloo on the CPU; on the card
    NCCL when every local rank has a device of its own, else gloo over CUDA
    tensors. The rank prints the backend it took."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return dist.is_initialized()
    if dist.is_initialized():
        return True
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = "gloo"
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA device was requested but torch.cuda.is_available() "
                               "is False; pass device='cpu' to run on the CPU")
        n_dev = torch.cuda.device_count()
        torch.cuda.set_device(local_rank % n_dev)
        if local_world <= n_dev:
            backend = "nccl"
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    where = f"cuda:{torch.cuda.current_device()}" if torch.device(device).type == "cuda" \
        else "cpu"
    print(f"[rank {rank}/{world}] torch.distributed backend {backend} on {where}", flush=True)
    return True


def make_mesh(num_data: int = -1, num_model: int = 1, axis_names=(DATA, MODEL)):
    """A ``DeviceMesh`` over every rank with dims ``axis_names`` (the data
    axis, then the model axis), ranks laid out data-major (rank = d *
    num_model + m); ``num_data`` -1 takes the world over ``num_model``.
    None when no process group is initialised: one process, the plain
    path."""
    if not dist.is_initialized():
        if num_model > 1 or num_data > 1:
            raise ValueError(f"a mesh of {num_data} x {num_model} needs a process group "
                             "(launch with torchrun)")
        return None
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if num_data == -1:
        num_data = world // num_model
    if num_data * num_model != world:
        raise ValueError(f"mesh {num_data} x {num_model} does not cover the world of {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (num_data, num_model),
                            mesh_dim_names=tuple(axis_names))


def _axis(mesh, axis: str) -> str:
    """The mesh's own name of ``axis`` (DATA: its first dim, MODEL: its
    second), or ``axis`` itself."""
    return {DATA: mesh.mesh_dim_names[0], MODEL: mesh.mesh_dim_names[1]}.get(axis, axis)


def axis_rank_size(mesh, axis: str = DATA):
    """(this rank's index along ``axis``, its size); (0, 1) without a mesh."""
    if mesh is None:
        return 0, 1
    axis = _axis(mesh, axis)
    return mesh.get_local_rank(axis), mesh.size(mesh.mesh_dim_names.index(axis))


def axis_group(mesh, axis: str):
    return mesh.get_group(_axis(mesh, axis))


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


@contextlib.contextmanager
def main_process_first():
    """Rank 0 runs the block first and the others after it (a vocab or a
    synthetic world written once, then read)."""
    if not dist.is_initialized():
        yield
        return
    if dist.get_rank() != 0:
        dist.barrier()
    yield
    if dist.get_rank() == 0:
        dist.barrier()


def cast_floats(batch_arrays: Dict, float_dtype) -> Dict:
    """Host-side cast of the float32 arrays to ``float_dtype`` ("bfloat16"
    or a torch dtype) before transfer; integer and bool arrays untouched."""
    dt = getattr(torch, float_dtype) if isinstance(float_dtype, str) else float_dtype
    out = {}
    for k, v in batch_arrays.items():
        t = torch.from_numpy(v) if isinstance(v, np.ndarray) else v
        out[k] = t.to(dt) if t.dtype == torch.float32 else t
    return out


def shard_batch(batch_arrays: Dict, mesh, stacked: bool = False, float_dtype=None) -> Dict:
    """This rank's rows of a global batch: the rows split in contiguous
    blocks over "data" (JAX's ``P("data")``), on dim 1 with ``stacked`` (a
    (K, B, ...) stack of K batches). Ranks of one "model" group get the same
    rows. ``float_dtype``: as ``cast_floats``. Arrays that are not numpy or
    tensors are dropped."""
    if float_dtype is not None:
        batch_arrays = cast_floats(batch_arrays, float_dtype)
    rank, size = axis_rank_size(mesh, DATA)
    dim = 1 if stacked else 0
    out = {}
    for k, v in batch_arrays.items():
        if not isinstance(v, (np.ndarray, torch.Tensor)):
            continue
        n = v.shape[dim]
        if n % size:
            raise ValueError(f"{k}: {n} rows do not split over {size} data ranks")
        per = n // size
        out[k] = v[rank * per:(rank + 1) * per] if dim == 0 \
            else v[:, rank * per:(rank + 1) * per]
    return out


def replicate_params(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank, in place."""
    if mesh is None:
        return model
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t.data, src=0)
    return model


# -- the data axis: global normalisers, the batch-wide minimum, dropout --------


@contextlib.contextmanager
def data_parallel(mesh):
    """Inside the block the model and the criterion treat this rank's rows
    as rows of the global batch over the mesh's "data" axis. Without a mesh
    it does nothing."""
    if mesh is None:
        yield
        return
    rank, size = axis_rank_size(mesh, DATA)
    token = _DATA_SHARD.set((axis_group(mesh, DATA), rank, size))
    try:
        yield
    finally:
        _DATA_SHARD.reset(token)


def batch_shard():
    """(rank, size) of the data axis inside ``data_parallel``, else None."""
    shard = _DATA_SHARD.get()
    return None if shard is None else shard[1:]


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the data axis inside ``data_parallel`` (a count or
    a normaliser: no gradient flows through it); ``t`` itself outside."""
    shard = _DATA_SHARD.get()
    if shard is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=shard[0])
    return t


class _GlobalMin(torch.autograd.Function):
    """The minimum over the data axis of every element of ``x``. The
    backward spreads the gradient evenly over every element equal to the
    minimum on every rank, as ``torch.min``'s backward does within one
    tensor."""

    @staticmethod
    def forward(ctx, x, group):
        m = x.detach().min()
        dist.all_reduce(m, op=dist.ReduceOp.MIN, group=group)
        mask = x == m
        count = mask.sum()
        dist.all_reduce(count, op=dist.ReduceOp.SUM, group=group)
        ctx.save_for_backward(mask, count)
        ctx.group = group
        return m

    @staticmethod
    def backward(ctx, grad):
        mask, count = ctx.saved_tensors
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return mask * (grad / count), None


def global_min(x: torch.Tensor) -> torch.Tensor:
    """``x.min()`` over the global batch inside ``data_parallel``."""
    shard = _DATA_SHARD.get()
    if shard is None:
        return x.min()
    return _GlobalMin.apply(x, shard[0])


# -- the model axis: autograd pairs --------------------------------------------


def split_sizes(n: int, parts: int) -> List[int]:
    """Sizes of ``n`` split over ``parts`` ranks, the larger first
    (``torch.tensor_split``'s)."""
    return [n // parts + (1 if i < n % parts else 0) for i in range(parts)]


def _all_gather_cat(t: torch.Tensor, dim: int, sizes: Sequence[int], group) -> torch.Tensor:
    """Every rank's ``t`` (``sizes[r]`` long on ``dim``) concatenated in
    rank order; uneven parts are padded for the collective."""
    t = t.contiguous()
    pad = max(sizes) - t.shape[dim]
    if pad:
        shape = list(t.shape)
        shape[dim] = pad
        t = torch.cat([t, t.new_zeros(shape)], dim=dim)
    parts = [torch.empty_like(t) for _ in sizes]
    dist.all_gather(parts, t, group=group)
    return torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, sizes)], dim=dim)


def _own_slice(t: torch.Tensor, dim: int, sizes: Sequence[int], group) -> torch.Tensor:
    r = dist.get_rank(group)
    return t.narrow(dim, sum(sizes[:r]), sizes[r]).contiguous()


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, sizes):
        ctx.group, ctx.dim, ctx.sizes = group, dim, sizes
        return _all_gather_cat(x, dim, sizes, group)

    @staticmethod
    def backward(ctx, grad):
        return _own_slice(grad, ctx.dim, ctx.sizes, ctx.group), None, None, None


class _SplitToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, sizes):
        ctx.group, ctx.dim, ctx.sizes = group, dim, sizes
        return _own_slice(x, dim, sizes, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather_cat(grad, ctx.dim, ctx.sizes, ctx.group), None, None, None


def copy_to_group(x, group):
    """Identity forward; the backward sums the gradient over ``group`` (the
    input of a column-parallel product, whose ranks each hold a part of
    its gradient)."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    """Sum over ``group`` forward (the partial products of a row-parallel
    layer); identity backward."""
    return _ReduceFromGroup.apply(x, group)


def gather_from_group(x, group, dim: int, sizes: Sequence[int]):
    """The ranks' parts concatenated on ``dim`` forward; the backward keeps
    this rank's part of the gradient (the consumer is replicated, so every
    rank holds the same full gradient)."""
    return _GatherFromGroup.apply(x, group, dim % x.dim(), list(sizes))


def split_to_group(x, group, dim: int, sizes: Sequence[int]):
    """This rank's part of a replicated ``x`` on ``dim`` forward; the
    backward gathers the parts of the gradient, so the producer gets all of
    it."""
    return _SplitToGroup.apply(x, group, dim % x.dim(), list(sizes))


# -- gradients and host objects ------------------------------------------------


def mark_model_partial(params, group) -> None:
    """Mark parameters whose gradient each rank of ``group`` holds only a
    part of (a projection run on a slice of the tokens): ``sync_grads``
    sums them over the group."""
    for p in params:
        p._mfl_partial_group = group


def _all_reduce_coalesced(tensors: List[torch.Tensor], group) -> None:
    """Sum ``tensors`` over ``group`` in place, one collective a dtype."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = _flatten_dense_tensors(ts)
        dist.all_reduce(flat, group=group)
        for t, r in zip(ts, _unflatten_dense_tensors(flat, ts)):
            t.copy_(r)


@torch.no_grad()
def sync_grads(params, mesh) -> None:
    """Every rank's gradients made the global batch's: those of parameters
    marked by ``mark_model_partial`` summed over their model group, then
    every gradient summed over the data axis (the criterion's normalisers
    are global, so the sum is the global gradient). A parameter that
    received no gradient gets a zero one first."""
    if mesh is None:
        return
    params = [p for p in params if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    partial: Dict[object, List[torch.Tensor]] = {}
    for p in params:
        group = getattr(p, "_mfl_partial_group", None)
        if group is not None:
            partial.setdefault(group, []).append(p.grad)
    for group, grads in partial.items():
        _all_reduce_coalesced(grads, group)
    _all_reduce_coalesced([p.grad for p in params], axis_group(mesh, DATA))


def all_reduce_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed over the data axis (a copy); ``t`` without a mesh."""
    if mesh is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=axis_group(mesh, DATA))
    return t


def gather_objects(obj, mesh) -> list:
    """Every data rank's ``obj``, in rank order (every rank gets the list);
    ``[obj]`` without a mesh."""
    if mesh is None:
        return [obj]
    group = axis_group(mesh, DATA)
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out
