"""Collectives of the sharded deployments.

Serving moves pool pages and attention head outputs between ranks and
never reduces them, so a rank's result holds the same bits whatever the
mesh: :func:`all_gather_tiled`, every rank's block of a tensor
concatenated along one dim in the group's rank order (the reference's
``jax.lax.all_gather(..., tiled=True)``).

Training adds sums: :func:`all_reduce_sum` and :func:`reduce_scatter_sum`
(a sum whose every rank keeps only its block), and three autograd
functions over the data dims of a training mesh (:class:`Axis`, one mesh
dim as this rank sees it):

- :func:`gather_at_use`, a parameter's whole tensor from this rank's
  block. Its backward sums the gradient over the data dims (each data
  rank saw other rows) and keeps the rank's block. Over the ``model`` dim
  it only keeps the block: the model ranks of one data group see the same
  rows and compute the same gradient, so a sum there would multiply it.
- :func:`data_mean`, the mean over the data dims, whose backward divides
  the gradient by their size (summed over the data ranks afterwards, the
  shares make the whole);
- :func:`gather_rows`, the data ranks' rows concatenated in rank order,
  whose backward is the sum-then-block of the rows' gradients.

A ``gloo`` group moves a CUDA tensor through host memory: the block is
copied into page-locked host memory, reduced or gathered there and
copied back to the tensor's device. That is how gloo carries CUDA tensors, decided by the
group's backend (the caller's choice), never by a failure; an ``nccl``
group works on the card. A failed collective raises.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import torch
import torch.distributed as dist

def _staged(t: torch.Tensor, group) -> bool:
    """Whether ``group`` carries ``t`` through the host: a CUDA tensor
    under gloo."""
    return t.device.type != "cpu" and dist.get_backend(group) == "gloo"


def _carried(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` contiguous where ``group``'s backend can carry it: copied
    into page-locked host memory when it is staged (the copies to and from
    the card then run at the bus's rate; PyTorch's pinned-memory allocator
    caches the blocks)."""
    src = t.contiguous()
    if not _staged(src, group):
        return src
    host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    host.copy_(src)
    return host


def _empty_beside(src: torch.Tensor, shape, staged: bool) -> torch.Tensor:
    """An output for a collective over ``src`` (pinned when staged)."""
    return torch.empty(shape, dtype=src.dtype, device=src.device,
                       pin_memory=staged)


def all_gather_tiled(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` concatenated along ``dim``, in rank
    order: shape ``t.shape`` with ``dim`` multiplied by the group's size.
    A group of one returns ``t`` itself. Every rank must call it with the
    same shape and dtype."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    dim = dim % t.dim()
    src = _carried(t.movedim(dim, 0), group)
    out = _empty_beside(src, (n * src.shape[0],) + tuple(src.shape[1:]),
                        _staged(t, group))
    with warnings.catch_warnings():
        # the one gather into a single tensor that torch 2.11 and 2.13
        # both have; 2.13 marks it deprecated
        warnings.filterwarnings("ignore", message=".*all_gather_into_tensor")
        dist.all_gather_into_tensor(out, src, group=group)
    return out.to(t.device).movedim(0, dim)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``t`` over ``group``, a new tensor on
    ``t``'s device (``t`` itself for a group of one). Every rank gets the
    same bits."""
    if dist.get_world_size(group) == 1:
        return t
    src = _carried(t, group)
    if src is t or src.data_ptr() == t.data_ptr():
        src = src.clone()
    dist.all_reduce(src, op=dist.ReduceOp.SUM, group=group)
    return src.to(t.device)


def reduce_scatter_sum(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of every rank's ``t`` over ``group``, of which this rank
    keeps block ``rank`` of ``size`` along ``dim`` (one
    ``reduce_scatter_tensor``, which the gloo of torch 2.11 and 2.13
    has)."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    dim = dim % t.dim()
    src = _carried(t.movedim(dim, 0), group)
    out = _empty_beside(src, (src.shape[0] // n,) + tuple(src.shape[1:]),
                        _staged(t, group))
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*reduce_scatter_tensor")
        dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM,
                                   group=group)
    return out.to(t.device).movedim(0, dim).contiguous()


# ------------------------------------------------------------- training


class Axis(NamedTuple):
    """One mesh dim as this rank sees it: its name, the rank's index on it,
    its size, and the process group of the ranks that differ only there."""

    name: str
    index: int
    size: int
    group: object


def block_index(axes) -> tuple:
    """(this rank's index, the count) over ``axes`` taken together, the
    first outermost (row-major, as a tuple entry of a placement spec
    orders them)."""
    index, size = 0, 1
    for ax in axes:
        index, size = index * ax.size + ax.index, size * ax.size
    return index, size


def take_block(t: torch.Tensor, dim: int, axes) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` over ``axes`` (a view)."""
    index, size = block_index(axes)
    if size == 1:
        return t
    n = t.shape[dim] // size
    return t.narrow(dim, index * n, n)


def gather_blocks(t: torch.Tensor, dim: int, axes) -> torch.Tensor:
    """Every rank's block along ``dim`` over ``axes``, whole: gathered
    over the innermost axis first, so the blocks land in
    :func:`block_index` order."""
    for ax in reversed(axes):
        t = all_gather_tiled(t, dim, ax.group)
    return t


def sum_over(t: torch.Tensor, axes) -> torch.Tensor:
    for ax in axes:
        t = all_reduce_sum(t, ax.group)
    return t


def sum_then_block(t: torch.Tensor, dim: int, axes) -> torch.Tensor:
    """The sum of ``t`` over ``axes``, this rank's block along ``dim``."""
    axes = [ax for ax in axes if ax.size > 1]
    if len(axes) == 1:
        return reduce_scatter_sum(t, dim, axes[0].group)
    return take_block(sum_over(t, axes), dim, axes).contiguous()


class _GatherAtUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, dims, data):
        ctx.dims, ctx.data = dims, data
        full = shard
        for dim, axes, _ in dims:
            full = gather_blocks(full, dim, axes)
        return full.view_as(full) if full is shard else full

    @staticmethod
    def backward(ctx, g):
        # the model dims: only the block (the model ranks agree)
        for dim, axes, is_data in ctx.dims:
            if not is_data:
                g = take_block(g, dim, axes)
        data_dims = [(dim, axes) for dim, axes, is_data in ctx.dims
                     if is_data]
        if ctx.data:  # each data rank saw its own rows: sum them
            if data_dims:
                g = sum_then_block(g, data_dims[0][0], ctx.data)
            else:
                g = sum_over(g.contiguous(), ctx.data)
        else:  # the rows were the same on every data rank
            for dim, axes in data_dims:
                g = take_block(g, dim, axes)
        return g.contiguous(), None, None


def gather_at_use(shard: torch.Tensor, dims: tuple, data: tuple):
    """The whole tensor of which ``shard`` is this rank's block.

    ``dims`` lists ``(tensor dim, axes, is_data)`` for each dim the block
    was cut along (``axes`` outermost first, ``is_data`` for the data
    dims); ``data`` holds the data axes whose ranks saw different rows
    (empty when every data rank trained on the same rows). The backward
    is the module docstring's."""
    return _GatherAtUse.apply(shard, dims, data)


class _DataMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, data):
        ctx.n = block_index(data)[1]
        return sum_over(x.contiguous(), data) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def data_mean(x: torch.Tensor, data: tuple) -> torch.Tensor:
    """The mean of every data rank's ``x`` (the same bits on each); the
    backward gives each rank its share, the gradient over the size."""
    return _DataMean.apply(x, data)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, data):
        ctx.data = data
        return gather_blocks(x, 0, data)

    @staticmethod
    def backward(ctx, g):
        return sum_then_block(g, 0, ctx.data), None


def gather_rows(x: torch.Tensor, data: tuple) -> torch.Tensor:
    """Every data rank's rows of ``x`` along dim 0, in rank order."""
    return _GatherRows.apply(x, data)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def scale_grad(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` itself, whose gradient is divided by ``n``: a value every
    data rank computes whole and adds to its loss."""
    return _ScaleGrad.apply(x, n)
