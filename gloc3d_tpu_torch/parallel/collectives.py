"""The collectives that the port's multi-rank paths share (the sharded
search, data parallelism, group BatchNorm), over a ``torch.distributed``
process group ``mesh`` (None: the default group)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

# torch 2.13 renames all_gather_into_tensor; the card's torch has only the
# old name
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def group_shape(mesh) -> Tuple[int, int]:
    """(ranks, this process's rank) of the process group ``mesh`` (None:
    the default group)."""
    return dist.get_world_size(mesh), dist.get_rank(mesh)


def all_gather(mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each) stacked in rank order:
    (ranks,) + x.shape, on every rank."""
    world = dist.get_world_size(mesh)
    out = x.new_empty((world * x.shape[0],) + x.shape[1:])
    _all_gather(out, x.contiguous(), group=mesh)
    return out.view((world,) + x.shape)


def broadcast_rank0(mesh, x: torch.Tensor) -> None:
    """Overwrite ``x`` on every rank with the group's rank 0's."""
    src = 0 if mesh is None else dist.get_global_rank(mesh, 0)
    dist.broadcast(x, src=src, group=mesh)


def same_on_every_rank(mesh, x: torch.Tensor) -> bool:
    """Whether ``x`` holds the same bits on every rank (every rank gets
    the same answer)."""
    ref = x.clone()
    broadcast_rank0(mesh, ref)
    ok = torch.tensor([int(torch.equal(ref, x))], device=x.device)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=mesh)
    return bool(ok.item())
