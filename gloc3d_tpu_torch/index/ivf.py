"""IVF (inverted-file) partitioned descriptor index for map-scale maps.

Port of ``gloc3d_tpu/index/ivf.py::IVFBank``: a k-means coarse quantizer
routes each descriptor to a cell, and a query scores only the ``nprobe``
cells whose centroids lie nearest. Cells are a dense ``(num_cells,
cell_capacity, D)`` tensor with per-cell sizes and a ``(num_cells,
cell_capacity)`` id table (-1 = empty slot), so a query is two gathers and
one batched product over ``nprobe · cell_capacity`` rows; ``nprobe =
num_cells`` is the exact search.

The structure is JAX's: a host-side numpy mirror of the cells; routing on
the device in chunks of 131 072 rows; a bulk write placed by a stable
argsort of the assignments; ``_spill_assign`` under ``max_cell_capacity``;
``_grow`` doubling the capacity otherwise; a device copy cached by
``(total, cell_capacity)``, so that a query never uploads the map again;
``exclude_after`` as a mask inside the scan; ``-1`` ids for slots whose
distance is inf; ``save`` / ``load`` in JAX's npz format, so maps load
across the two packages. ``quantize="int8"`` stores cells as per-row int8
codes with a scale and the exact fp32 norm (ops/topk.py::quantize_rows);
routing stays fp32.

torch has no batched int8 product, so the int8 scan of Q queries takes the
cuBLASLt int8 GEMM (``ops/topk.py::int8_dots``) of each group of up to 8
queries' candidates against those 8 queries and keeps each query's own
column: up to 8 × the multiply-adds of the batched product, but the
candidate rows, which set the time, are read once. ``train`` takes the
port's k-means draws (a ``torch.Generator``, or ``seed_draws`` to replay
JAX's): torch cannot replay a JAX key, so a map the port trains gets other
centroids than JAX's for the same rows.

``ShardedIVF`` (JAX's ``ShardedIVF``) spreads the cells over the ranks of
a ``torch.distributed`` process group on the cell axis (see
``parallel/sharding.py`` for how a mesh maps onto a group): the centroids
are replicated and must hold the same bits on every rank; each rank routes
every query, scans only the probed cells it owns and keeps its local top-k,
and one all-gather merges the ranks' candidates.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gloc3d_tpu_torch.core.device import resolve_device
from gloc3d_tpu_torch.index.kmeans import kmeans
from gloc3d_tpu_torch.ops.topk import (
    int8_dots, l2_topk, quantize_rows, select_topk,
)
from gloc3d_tpu_torch.parallel.collectives import (
    group_shape, same_on_every_rank,
)
from gloc3d_tpu_torch.parallel.sharding import gather_merge

NO_LIMIT = 2**31 - 1
_ROUTE_CHUNK = 131072


def _gathered(probe: torch.Tensor, *tables: torch.Tensor):
    """Each table (C, P, …) gathered at the (Q, nprobe) cells ``probe`` as
    (Q, nprobe · P, …)."""
    qn = probe.shape[0]
    return [t[probe].reshape((qn, -1) + t.shape[2:]) for t in tables]


def _masked(d2: torch.Tensor, cand_ids: torch.Tensor, limit: int):
    """Empty slots and ids ≥ ``limit`` at +inf."""
    ok = (cand_ids >= 0) & (cand_ids < limit)
    return torch.where(ok, d2, torch.inf), cand_ids


def select_ids(d2: torch.Tensor, cand_ids: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest candidates' (dists², global ids), -1 for the
    inf-distance filler slots."""
    d2, sel = select_topk(d2, k)
    picked = torch.gather(cand_ids, 1, sel)
    return d2, torch.where(torch.isfinite(d2), picked, -1)


def _cell_dists(probe, cells, bsq, cell_ids, q32):
    """fp32 cells (C, P, D) with norms and ids (C, P), scanned at the
    probed cells ``probe`` (Q, nprobe) → (dists² (Q, M), ids (Q, M)) of the
    M = nprobe · P slots, unmasked."""
    cand, cand_sq, cand_ids = _gathered(probe, cells, bsq, cell_ids)
    dots = torch.bmm(cand, q32[:, :, None])[..., 0]     # (Q, M)
    return (q32 * q32).sum(1)[:, None] - 2.0 * dots + cand_sq, cand_ids


def _batched_int8_dots(cand: torch.Tensor, qq: torch.Tensor
                       ) -> torch.Tensor:
    """(Q, M, D) int8 candidates · (Q, D) int8 queries → (Q, M) int32:
    one int8 GEMM per group of 8 queries, each query's own column kept."""
    out = []
    for g in range(0, qq.shape[0], 8):
        c, q = cand[g:g + 8], qq[g:g + 8]
        n, m = c.shape[:2]
        d = int8_dots(c.reshape(n * m, -1), q).reshape(n, m, n)
        ar = torch.arange(n, device=d.device)
        out.append(d[ar, :, ar])
    return torch.cat(out)


def _cell_dists_int8(probe, cells_q, scales, bsq, cell_ids, q32):
    """``_cell_dists`` over int8 cells with per-row scales (C, P): the cross
    term an exact int8 product, JAX's order of operations after it."""
    cand, cand_sc, cand_sq, cand_ids = _gathered(
        probe, cells_q, scales, bsq, cell_ids)
    qq, q_scale, q_sq = quantize_rows(q32)
    idots = _batched_int8_dots(cand, qq)                # (Q, M) int32
    dots = idots.float() * (q_scale[:, None] * cand_sc)
    return q_sq[:, None] - 2.0 * dots + cand_sq, cand_ids


def _scan(cells, bsq, scales, cell_ids, q32, probe):
    """The distance pass over the cells ``probe``, fp32 cells or int8 ones
    (``scales`` not None)."""
    if scales is None:
        return _cell_dists(probe, cells, bsq, cell_ids, q32)
    return _cell_dists_int8(probe, cells, scales, bsq, cell_ids, q32)


def _ivf_dists(centroids, cells, bsq, cell_ids, queries, nprobe: int,
               limit: int = NO_LIMIT, scales=None):
    """The distance pass: routing in fp32 to the ``nprobe`` nearest cells,
    then (dists² (Q, M), ids (Q, M)) of their slots, empty and excluded
    ones at +inf. ``scales`` (C, P) marks int8 cells."""
    q32 = queries.float()
    _, probe = l2_topk(q32, centroids, nprobe)          # (Q, nprobe)
    return _masked(*_scan(cells, bsq, scales, cell_ids, q32, probe), limit)


def _ivf_query(centroids: torch.Tensor, cells: torch.Tensor,
               bsq: torch.Tensor, cell_ids: torch.Tensor,
               queries: torch.Tensor, k: int, nprobe: int,
               limit: int = NO_LIMIT) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 cells (C, P, D) with exact norms (C, P) and ids (C, P) →
    (dists² (Q, k), global ids (Q, k)); ids ≥ ``limit`` are excluded."""
    return select_ids(*_ivf_dists(centroids, cells, bsq, cell_ids, queries,
                                  nprobe, limit), k)


def _ivf_query_int8(centroids: torch.Tensor, cells_q: torch.Tensor,
                    scales: torch.Tensor, bsq: torch.Tensor,
                    cell_ids: torch.Tensor, queries: torch.Tensor, k: int,
                    nprobe: int, limit: int = NO_LIMIT
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_ivf_query`` over int8 cells with per-row scales (C, P)."""
    return select_ids(*_ivf_dists(centroids, cells_q, bsq, cell_ids,
                                  queries, nprobe, limit, scales), k)


def ivf_search(arrays: tuple, queries: torch.Tensor, k: int, nprobe: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``IVFBank.query_device`` as a function of the index's device arrays
    (``IVFBank.search_arrays``: centroids, cells, norms, scales or None,
    ids), for a program that takes them as inputs: (dists² (Q, k), ids
    (Q, k) int64, -1 for inf-distance filler)."""
    cents, cells, bsq, scales, ids = arrays
    return select_ids(*_ivf_dists(cents, cells, bsq, ids, queries,
                                  min(nprobe, cells.shape[0]),
                                  scales=scales), k)


class IVFBank:
    """Partitioned descriptor index (train → add → query) on ``device``
    (default ``cuda``; without a card, pass ``device="cpu"``)."""

    def __init__(self, dim: int, num_cells: int = 256,
                 cell_capacity: int = 256, nprobe: int = 8,
                 quantize: str = "none",
                 max_cell_capacity: Optional[int] = None,
                 spill_probes: int = 8,
                 device: Optional[torch.device] = None):
        self.dim = dim
        self.num_cells = num_cells
        self.cell_capacity = cell_capacity
        self.nprobe = nprobe
        self.quantize = quantize
        self.max_cell_capacity = max_cell_capacity
        self.spill_probes = spill_probes
        self.device = resolve_device(device, "IVFBank")
        self.spilled = 0          # rows placed in a non-nearest probed cell
        self.spill_overflow = 0   # rows placed in an arbitrary emptiest cell
        self.centroids: Optional[torch.Tensor] = None
        dt = np.int8 if quantize == "int8" else np.float32
        self._cells = np.zeros((num_cells, cell_capacity, dim), dt)
        self._bsq = np.zeros((num_cells, cell_capacity), np.float32)
        if quantize == "int8":
            self._scales = np.zeros((num_cells, cell_capacity), np.float32)
        self._ids = np.full((num_cells, cell_capacity), -1, np.int64)
        self._sizes = np.zeros(num_cells, np.int64)
        self._total = 0
        self._dev_stamp = None

    def __len__(self) -> int:
        return self._total

    def train(self, sample, generator: Optional[torch.Generator] = None,
              iters: int = 25, seed_draws=None) -> None:
        """Fit the coarse quantizer on a descriptor sample (k-means++ on
        the device; its draws from ``generator``, by default one seeded
        with 0, or replayed from ``seed_draws``)."""
        if generator is None and seed_draws is None:
            generator = torch.Generator().manual_seed(0)
        data = torch.as_tensor(np.asarray(sample, np.float32),
                               device=self.device)
        self.centroids, _ = kmeans(data, self.num_cells, iters,
                                   generator=generator,
                                   seed_draws=seed_draws)

    def add(self, feats) -> None:
        """Bulk insert: routing on the device, one bucketed write on the
        host. The rank of a row within its cell's group of a stable argsort
        of the assignments is its slot offset, so the batch lands in one
        fancy-indexed write."""
        if self.centroids is None:
            raise RuntimeError("IVFBank.train must run before add")
        feats = np.atleast_2d(np.asarray(feats, np.float32))
        m = len(feats)
        if m == 0:
            return
        # with a capacity bound, route to the nearest L cells so that rows
        # overflowing their first choice can spill to the next
        bounded = self.max_cell_capacity is not None
        L = min(self.spill_probes, self.num_cells) if bounded else 1
        choices = np.empty((m, L), np.int64)
        for i in range(0, m, _ROUTE_CHUNK):
            chunk = torch.from_numpy(feats[i:i + _ROUTE_CHUNK]).to(
                self.device)
            choices[i:i + _ROUTE_CHUNK] = l2_topk(
                chunk, self.centroids, L)[1].cpu().numpy()
        assign = choices[:, 0].copy()
        counts = np.bincount(assign, minlength=self.num_cells)
        while (self._sizes + counts).max() > self.cell_capacity:
            if bounded and self.cell_capacity * 2 > self.max_cell_capacity:
                break
            self._grow()
        if (self._sizes + counts).max() > self.cell_capacity:
            assign = self._spill_assign(choices)
            counts = np.bincount(assign, minlength=self.num_cells)
        order = np.argsort(assign, kind="stable")
        sorted_assign = assign[order]
        group_starts = np.concatenate([[0], np.cumsum(counts)])
        rank_in_cell = np.arange(m) - group_starts[sorted_assign]
        rows = self._sizes[sorted_assign] + rank_in_cell
        if self.quantize == "int8":
            codes, scales, bsq = (t.cpu().numpy() for t in quantize_rows(
                torch.from_numpy(feats).to(self.device)))
            self._cells[sorted_assign, rows] = codes[order]
            self._scales[sorted_assign, rows] = scales[order]
            self._bsq[sorted_assign, rows] = bsq[order]
        else:
            self._cells[sorted_assign, rows] = feats[order]
            self._bsq[sorted_assign, rows] = np.einsum(
                "nd,nd->n", feats, feats)[order]
        self._ids[sorted_assign, rows] = self._total + order
        self._sizes += counts
        self._total += m

    def _spill_assign(self, choices: np.ndarray) -> np.ndarray:
        """Place each row in its nearest probed cell with room left, one
        probe level at a time: a stable argsort ranks the rows contending
        for each cell, the first ``room[cell]`` win, the rest try their
        next level. Rows that exhaust all L levels go to the emptiest cells
        (counted in ``spill_overflow``: they are found only when that cell
        is probed, a sign to retrain with more cells)."""
        m, L = choices.shape
        room = (self.cell_capacity - self._sizes).astype(np.int64)
        final = np.full(m, -1, np.int64)
        remaining = np.arange(m)
        for level in range(L):
            if not len(remaining):
                break
            c = choices[remaining, level]
            order = np.argsort(c, kind="stable")
            cs = c[order]
            lvl_counts = np.bincount(cs, minlength=self.num_cells)
            starts = np.concatenate([[0], np.cumsum(lvl_counts)])
            rank = np.arange(len(cs)) - starts[cs]
            won = rank < room[cs]
            winners = remaining[order[won]]
            final[winners] = cs[won]
            room -= np.minimum(lvl_counts, room)
            remaining = remaining[order[~won]]
            if level > 0:
                self.spilled += int(won.sum())
        if len(remaining):
            self.spill_overflow += len(remaining)
            emptiest = np.argsort(-room, kind="stable")
            slots_cell = np.repeat(emptiest, room[emptiest])
            if len(slots_cell) < len(remaining):
                raise RuntimeError(
                    f"IVFBank full: {len(remaining) - len(slots_cell)} rows "
                    f"do not fit under max_cell_capacity="
                    f"{self.max_cell_capacity}; retrain with more cells")
            final[remaining] = slots_cell[: len(remaining)]
        return final

    def _grow(self) -> None:
        """Double the cell capacity on the host mirror."""
        cap = self.cell_capacity * 2

        def grown(a, fill):
            out = np.full((self.num_cells, cap) + a.shape[2:], fill, a.dtype)
            out[:, : self.cell_capacity] = a
            return out

        self._cells = grown(self._cells, 0)
        self._bsq = grown(self._bsq, 0)
        self._ids = grown(self._ids, -1)
        if self.quantize == "int8":
            self._scales = grown(self._scales, 0)
        self.cell_capacity = cap

    def device_arrays(self) -> tuple:
        """(cells, bsq, scales or None, ids) on the device, uploaded again
        only when the index changed."""
        stamp = (self._total, self.cell_capacity)
        if self._dev_stamp != stamp:
            self._dev = None  # free the old copy before the new upload

            def dev(a):
                return torch.from_numpy(a).to(self.device)

            self._dev = (dev(self._cells), dev(self._bsq),
                         dev(self._scales) if self.quantize == "int8"
                         else None, dev(self._ids))
            self._dev_stamp = stamp
        return self._dev

    def search_arrays(self) -> tuple:
        """(centroids, cells, bsq, scales or None, ids) on the device, as
        ``ivf_search`` takes them (uploaded again only when the index
        changed)."""
        return (self.centroids,) + self.device_arrays()

    def distances(self, queries, nprobe: Optional[int] = None,
                  exclude_after: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The distance pass of a search: (dists² (Q, M), global ids
        (Q, M)) of the M probed slots, +inf at empty and excluded ones."""
        nprobe = min(nprobe or self.nprobe, self.num_cells)
        limit = NO_LIMIT if exclude_after is None else max(exclude_after, 0)
        q = torch.atleast_2d(torch.as_tensor(queries, dtype=torch.float32,
                                             device=self.device))
        cells, bsq, scales, ids = self.device_arrays()
        return _ivf_dists(self.centroids, cells, bsq, ids, q, nprobe, limit,
                          scales)

    def query_device(self, queries, k: int = 20,
                     nprobe: Optional[int] = None,
                     exclude_after: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k over the probed cells → (dists² (Q, k), ids (Q, k) int64,
        -1 for inf-distance filler) left on the device. ``exclude_after``
        hides global ids ≥ the bound inside the scan (the SLAM
        exclude-recent window)."""
        return select_ids(*self.distances(queries, nprobe, exclude_after), k)

    def query(self, queries, k: int = 20, nprobe: Optional[int] = None,
              exclude_after: Optional[int] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
        """``query_device`` with the results on the host: (dists² (Q, k),
        ids (Q, k) int32)."""
        d2, idx = self.query_device(queries, k, nprobe, exclude_after)
        return d2.cpu().numpy(), idx.to(torch.int32).cpu().numpy()

    def save(self, path: str) -> None:
        """Write the trained, filled index in JAX's npz format."""
        if self.centroids is None:
            raise RuntimeError("IVFBank.train must run before save")
        extra = {"bsq": self._bsq}
        if self.quantize == "int8":
            extra["scales"] = self._scales
        np.savez(path, centroids=self.centroids.cpu().numpy(),
                 cells=self._cells, ids=self._ids, sizes=self._sizes,
                 total=self._total, nprobe=self.nprobe, **extra)

    @classmethod
    def load(cls, path: str, device: Optional[torch.device] = None
             ) -> "IVFBank":
        """Read an index written by ``save`` of either package (an fp32
        file from before the dot form, without ``bsq``, gets its norms
        recomputed)."""
        d = np.load(path, allow_pickle=False)
        cells = d["cells"]
        quantize = "int8" if cells.dtype == np.int8 else "none"
        bank = cls(dim=cells.shape[2], num_cells=cells.shape[0],
                   cell_capacity=cells.shape[1], nprobe=int(d["nprobe"]),
                   quantize=quantize, device=device)
        bank.centroids = torch.as_tensor(d["centroids"], device=bank.device)
        bank._cells = cells.copy()
        if "bsq" in d:
            bank._bsq = d["bsq"].copy()
        else:
            bank._bsq = np.einsum(
                "cpd,cpd->cp", cells, cells).astype(np.float32)
        if quantize == "int8":
            bank._scales = d["scales"].copy()
        bank._ids = d["ids"].copy()
        bank._sizes = d["sizes"].copy()
        bank._total = int(d["total"])
        return bank


class ShardedIVF:
    """An ``IVFBank`` spread over the ranks of ``mesh`` (a process group,
    None for the default one) on its CELL axis.

    The centroids are replicated: every rank routes a query to the same
    ``nprobe`` cells, so the constructor refuses centroids whose bits
    differ between ranks (train on one rank and ``broadcast``, or from the
    same rows, seed and device on each). Rank r holds cells [r · C/P,
    (r + 1) · C/P) of the cells, norms, scales and ids on the inner
    bank's device. A query scans the probed cells a rank owns (exactly one
    rank owns each), the others' slots at +inf, keeps the rank's top-k,
    and one all-gather merges them: ids whose merged distance is +inf read
    -1, distances are clamped at 0. The results equal the unsharded
    ``IVFBank``'s but where distances tie exactly across ranks (the
    earliest rank wins there, as in JAX's ``ShardedIVF``).

    ``add`` ingests into the inner bank's host mirror and marks the shards
    dirty; the next query uploads the rank's cells again (build once,
    query many: an add on a sharded map costs an upload of the shard).
    Every method is SPMD: every rank calls it with the same arguments."""

    def __init__(self, mesh, inner: IVFBank):
        if inner.centroids is None:
            raise RuntimeError("ShardedIVF needs a trained IVFBank")
        world, rank = group_shape(mesh)
        if inner.num_cells % world != 0:
            raise ValueError(f"num_cells {inner.num_cells} not divisible by "
                             f"mesh size {world}")
        if not same_on_every_rank(mesh, inner.centroids):
            raise RuntimeError("ShardedIVF: the ranks hold different "
                               "centroids; broadcast one rank's before "
                               "adding rows")
        self.mesh = mesh
        self.inner = inner
        self.dim = inner.dim
        cps = inner.num_cells // world
        self._cells = slice(rank * cps, (rank + 1) * cps)
        self._dirty = True

    def __len__(self) -> int:
        return len(self.inner)

    @property
    def centroids(self) -> torch.Tensor:
        return self.inner.centroids

    def add(self, feats) -> None:
        self.inner.add(feats)
        self._dirty = True

    def _refresh(self) -> None:
        """This rank's cells, norms, scales and ids on the device, uploaded
        again after an add."""
        if not self._dirty:
            return
        self._dev = None  # free the old shard before the new upload

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(
                a[self._cells])).to(self.inner.device)

        inner = self.inner
        self._dev = (dev(inner._cells), dev(inner._bsq),
                     dev(inner._scales) if inner.quantize == "int8"
                     else None, dev(inner._ids))
        self._dirty = False

    def query_device(self, queries, k: int = 20,
                     nprobe: Optional[int] = None,
                     exclude_after: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k over the probed cells of every rank → (dists² (Q, k), ids
        (Q, k) int64, -1 for inf-distance filler) on the device, the same
        on every rank; ids ≥ ``exclude_after`` are hidden in the scan."""
        self._refresh()
        nprobe = min(nprobe or self.inner.nprobe, self.inner.num_cells)
        limit = NO_LIMIT if exclude_after is None else max(exclude_after, 0)
        q32 = torch.atleast_2d(torch.as_tensor(
            queries, dtype=torch.float32, device=self.inner.device))
        cells, bsq, scales, ids = self._dev
        cps = cells.shape[0]
        _, probe = l2_topk(q32, self.centroids, nprobe)  # global cell ids
        local = probe - self._cells.start
        mine = (local >= 0) & (local < cps)
        d2, cand = _scan(cells, bsq, scales, ids, q32, local.clamp(0, cps - 1))
        d2, cand = _masked(torch.where(
            mine.repeat_interleave(cells.shape[1], 1), d2, torch.inf), cand,
            limit)
        d2, sel = torch.sort(d2, dim=-1, stable=True)   # unclamped, as JAX
        d2, idx = gather_merge(self.mesh, d2[:, :k],
                               torch.gather(cand, 1, sel[:, :k]), k)
        return d2, torch.where(torch.isfinite(d2), idx, -1)

    def query(self, queries, k: int = 20, nprobe: Optional[int] = None,
              exclude_after: Optional[int] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
        """``query_device`` with the results on the host: (dists² (Q, k),
        ids (Q, k) int32)."""
        d2, idx = self.query_device(queries, k, nprobe, exclude_after)
        return d2.cpu().numpy(), idx.to(torch.int32).cpu().numpy()

    def save(self, path: str) -> None:
        """The inner index in JAX's npz format (every rank holds the whole
        host mirror): rank 0 writes, every rank returns after a barrier."""
        if group_shape(self.mesh)[1] == 0:
            self.inner.save(path)
        dist.barrier(group=self.mesh)
