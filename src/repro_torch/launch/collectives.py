"""Exact collectives of the sharded serving deployment.

The deployment moves pool pages and attention head outputs between ranks
and never reduces them, so a rank's result holds the same bits whatever
the mesh. One primitive covers both: :func:`all_gather_tiled`, every
rank's block of a tensor concatenated along one dim in the group's rank
order (the reference's ``jax.lax.all_gather(..., tiled=True)``).

A ``gloo`` group moves a CUDA tensor through host memory: the block is
copied to the host, gathered there and copied back to the tensor's
device. That is how gloo carries CUDA tensors, decided by the group's
backend (the caller's choice), never by a failure; an ``nccl`` group
gathers on the card. A failed collective raises.
"""

from __future__ import annotations

import warnings

import torch
import torch.distributed as dist


def all_gather_tiled(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` concatenated along ``dim``, in rank
    order: shape ``t.shape`` with ``dim`` multiplied by the group's size.
    A group of one returns ``t`` itself. Every rank must call it with the
    same shape and dtype."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    dim = dim % t.dim()
    src = t.movedim(dim, 0).contiguous()
    if src.device.type != "cpu" and dist.get_backend(group) == "gloo":
        src = src.cpu()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    with warnings.catch_warnings():
        # the one gather into a single tensor that torch 2.11 and 2.13
        # both have; 2.13 marks it deprecated
        warnings.filterwarnings("ignore", message=".*all_gather_into_tensor")
        dist.all_gather_into_tensor(out, src, group=group)
    return out.to(t.device).movedim(0, dim)
