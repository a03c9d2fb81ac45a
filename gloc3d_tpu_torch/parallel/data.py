"""Data parallelism over a process group: the batch split over ranks, the
state replicated.

In JAX, ``Trainer(mesh=...)`` and ``GlobalLocalizer.shard_extraction`` only
place arrays on a mesh, and XLA keeps the global semantics. Here each rank
is a process with its own tensors (``parallel/sharding.py``: a JAX mesh is
a process group, every call is SPMD), so the global quantities are written
out: rank 0's state broadcast once, this rank's rows of a batch, the
ranks' results gathered in rank order, and gradients summed over ranks.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch
import torch.distributed as dist

from gloc3d_tpu_torch.parallel.collectives import (
    all_gather, broadcast_rank0, group_shape,
)


def require_group(mesh, who: str):
    """``mesh`` as a process group (None: the default group). Raises
    TypeError for anything else, RuntimeError when torch.distributed has
    no default group yet."""
    if mesh is None:
        if not dist.is_initialized():
            raise RuntimeError(f"{who}: no default process group; call "
                               f"torch.distributed.init_process_group first")
        mesh = dist.group.WORLD
    if not isinstance(mesh, dist.ProcessGroup):
        raise TypeError(f"{who}: mesh must be a torch.distributed "
                        f"ProcessGroup (a JAX mesh is a process group "
                        f"here), got {type(mesh).__name__}")
    return mesh


def shard_rows(n: int, mesh) -> slice:
    """This rank's contiguous rows [r·n/P, (r+1)·n/P) of an n-row batch,
    n a multiple of the group's size P."""
    world, rank = group_shape(mesh)
    if n % world:
        raise ValueError(f"batch of {n} not divisible by {world} ranks")
    per = n // world
    return slice(rank * per, (rank + 1) * per)


def gather_rows(mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each) concatenated on the
    leading axis in rank order, on every rank. Booleans travel as uint8."""
    if x.dtype == torch.bool:
        return gather_rows(mesh, x.to(torch.uint8)).bool()
    return all_gather(mesh, x).reshape((-1,) + tuple(x.shape[1:]))


def gather_host(mesh, a: np.ndarray, device) -> np.ndarray:
    """``gather_rows`` of a numpy array, moved through ``device`` (a CUDA
    device for NCCL)."""
    a = np.asarray(a)
    return gather_rows(mesh, torch.from_numpy(np.ascontiguousarray(a)).to(
        device)).cpu().numpy().astype(a.dtype, copy=False)


def broadcast_module(mesh, module: torch.nn.Module) -> None:
    """Overwrite every parameter and buffer of ``module`` with rank 0's:
    freshly built models differ per process."""
    with torch.no_grad():
        for t in module.state_dict().values():
            broadcast_rank0(mesh, t)


def all_reduce_grads(mesh, params: Iterable[torch.nn.Parameter],
                     *extra: torch.Tensor) -> None:
    """Sum the gradients of ``params`` (those that have one: the same set
    on every rank, the graph being the same) and the float32 scalars
    ``extra`` over the ranks in place, with one all-reduce of their
    concatenation. Every rank gets the same bits."""
    tensors = [p.grad for p in params if p.grad is not None]
    tensors += [e.view(1) for e in extra]
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
