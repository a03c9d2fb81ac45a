"""The sharded search: a descriptor bank split over the ranks of a process
group.

Port of ``gloc3d_tpu/parallel/sharding.py``: ``sharded_topk``,
``sharded_topk_int8`` and ``ShardedBank``. The bank shards on its row
axis. A query takes each rank's exact local top-k (``ops/topk.py``),
offsets the ids to global ones, and merges the ranks' (Q, k) candidates
with one all-gather, so the collective moves O(ranks · k) values, not O(N).

A JAX ``Mesh`` of N devices is, here, a ``torch.distributed`` process
group of N ranks: the argument ``mesh``, ``None`` meaning the default
group. Each rank is one process with its own device (``cuda:<local rank>``
over NCCL, CPU tensors over gloo), and every call is SPMD: every rank
calls the same method with the same queries and gets the same answer. A
group of one rank runs the same code and the same collective. The merge
puts the ranks' lists in rank order through the port's stable selection,
so ties go to the earliest global index, as ``lax.top_k`` breaks them in
JAX. ``shard_batch`` and ``replicate`` place JAX arrays on a mesh; a
process group places nothing (each rank holds its own tensors), so they
have no counterpart; ``parallel/mesh.py::make_mesh`` makes the group.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gloc3d_tpu_torch.core.device import resolve_device
from gloc3d_tpu_torch.ops.topk import (
    l2_topk, l2_topk_int8, quantize_rows, select_topk,
)
from gloc3d_tpu_torch.parallel.collectives import all_gather, group_shape


def merge_topk(d2_parts: torch.Tensor, id_parts: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(P, Q, k') per-rank ascending distances and their global ids, in
    rank order → the k nearest (dists² (Q, k) clamped at 0, ids (Q, k)).
    The ranks' lists are concatenated in rank order and selected by the
    stable sort, so among equal distances the earlier rank, and within a
    rank the earlier local index, wins: the earliest global index."""
    p, q, kk = d2_parts.shape
    d2 = d2_parts.permute(1, 0, 2).reshape(q, p * kk)
    ids = id_parts.permute(1, 0, 2).reshape(q, p * kk)
    d2, sel = select_topk(d2, k)
    return d2, torch.gather(ids, 1, sel)


def gather_merge(mesh, d2: torch.Tensor, gid: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every rank's (Q, k') local candidates, gathered in one collective
    and merged (``merge_topk``). Distances and ids travel as one float64
    tensor: fp32 values and ids below 2^53 convert both ways exactly."""
    kk = d2.shape[1]
    parts = all_gather(mesh, torch.cat([d2.double(), gid.double()], 1))
    return merge_topk(parts[..., :kk].float(), parts[..., kk:].long(), k)


def _rows(n: int, mesh) -> Tuple[slice, int]:
    """This rank's rows of an n-row bank, and the first one's global id."""
    world, rank = group_shape(mesh)
    if n % world != 0:
        raise ValueError(f"bank rows {n} not divisible by mesh size {world}")
    shard = n // world
    return slice(rank * shard, (rank + 1) * shard), rank * shard


def sharded_topk(mesh, queries: torch.Tensor, bank: torch.Tensor, k: int,
                 valid: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact global top-k over an (N, D) bank sharded on its rows, N a
    multiple of the group's size: each rank searches its rows [rank · N/P,
    (rank + 1) · N/P) of ``bank`` (and of ``valid`` (N,) bool, False rows
    never returned), and the ranks merge. → (dists² (Q, k), global ids
    (Q, k)) on every rank, equal to ``l2_topk`` over the whole bank."""
    rows, first = _rows(bank.shape[0], mesh)
    d2, idx = l2_topk(queries, bank[rows], k,
                      None if valid is None else valid[rows])
    return gather_merge(mesh, d2, idx + first, k)


def sharded_topk_int8(mesh, queries: torch.Tensor, bank_q: torch.Tensor,
                      scales: torch.Tensor, b_sq: torch.Tensor, k: int,
                      valid: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``sharded_topk`` over an int8 bank (codes (N, D), scales (N,), exact
    norms (N,); ``ops/topk.py::l2_topk_int8``), each sliced per rank."""
    rows, first = _rows(bank_q.shape[0], mesh)
    d2, idx = l2_topk_int8(queries, bank_q[rows], scales[rows], b_sq[rows],
                           k, None if valid is None else valid[rows])
    return gather_merge(mesh, d2, idx + first, k)


class ShardedBank:
    """A descriptor bank distributed over the ranks of ``mesh``.

    The capacity is rounded up to a multiple of the group's size, and rank
    r holds the global rows [r · C/P, (r + 1) · C/P) on ``device`` (default
    ``cuda``, the card this process has made current; CPU tensors need
    ``device="cpu"`` and a gloo group). ``add`` appends on every rank and
    each rank keeps only its own rows; ``query`` is ``sharded_topk`` over
    the live prefix. ``quantize="int8"`` stores per-row int8 codes, scales
    and exact norms (``ops/topk.py::quantize_rows``)."""

    def __init__(self, mesh, dim: int, capacity: int, quantize: str = "none",
                 device: Optional[torch.device] = None):
        self.mesh = mesh
        self.dim = dim
        self.quantize = quantize
        world, rank = group_shape(mesh)
        self.capacity = -(-capacity // world) * world
        self._shard = self.capacity // world
        self._first = rank * self._shard
        self.device = resolve_device(device, "ShardedBank")
        int8 = quantize == "int8"
        self._bank = torch.zeros((self._shard, dim), dtype=torch.int8 if int8
                                 else torch.float32, device=self.device)
        if int8:
            self._scales = torch.zeros(self._shard, device=self.device)
            self._bsq = torch.zeros(self._shard, device=self.device)
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def add(self, feats) -> None:
        """Append (M, D) or (D,) descriptors (numpy or a tensor): the same
        call on every rank; each writes the rows that fall in its shard."""
        feats = torch.atleast_2d(torch.as_tensor(feats, dtype=torch.float32))
        m = feats.shape[0]
        if self._size + m > self.capacity:
            raise ValueError("sharded bank capacity exceeded")
        lo = max(self._size, self._first)
        hi = min(self._size + m, self._first + self._shard)
        if lo < hi:
            rows = feats[lo - self._size:hi - self._size].to(self.device)
            out = slice(lo - self._first, hi - self._first)
            if self.quantize == "int8":
                (self._bank[out], self._scales[out],
                 self._bsq[out]) = quantize_rows(rows)
            else:
                self._bank[out] = rows
        self._size += m

    def truncate(self, n: int) -> None:
        """Drop entries beyond n (padded db-build tails)."""
        if not 0 <= n <= self._size:
            raise ValueError(f"truncate({n}) outside [0, {self._size}]")
        self._size = n

    def query(self, queries, k: int, exclude_after: Optional[int] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Global exact top-k over the live rows → (dists² (Q, k), ids
        (Q, k) int32) on the host, the same on every rank.
        ``exclude_after`` bounds the searchable prefix (the SLAM
        exclude-recent window as a validity mask on global ids)."""
        q = torch.atleast_2d(torch.as_tensor(queries, dtype=torch.float32,
                                             device=self.device))
        limit = self._size if exclude_after is None else min(exclude_after,
                                                             self._size)
        gid = torch.arange(self._first, self._first + self._shard,
                           device=self.device)
        valid = gid < max(limit, 0)
        if self.quantize == "int8":
            d2, idx = l2_topk_int8(q, self._bank, self._scales, self._bsq, k,
                                   valid)
        else:
            d2, idx = l2_topk(q, self._bank, k, valid)
        d2, idx = gather_merge(self.mesh, d2, idx + self._first, k)
        return d2.cpu().numpy(), idx.to(torch.int32).cpu().numpy()

    def to_host(self) -> np.ndarray:
        """The live (size, D) rows (dequantized in int8 mode), gathered from
        every rank: the same array on each."""
        rows = (self._bank.float() * self._scales[:, None]
                if self.quantize == "int8" else self._bank)
        return all_gather(self.mesh, rows).reshape(-1, self.dim)[
            : self._size].cpu().numpy()
