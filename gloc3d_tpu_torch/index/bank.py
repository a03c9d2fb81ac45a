"""Device-resident descriptor bank: build, serialize, query.

Port of ``gloc3d_tpu/index/bank.py::DescriptorBank``: a ``(capacity, D)``
tensor on the device that doubles on overflow, a ``size`` watermark, exact
top-k queries (ops/topk.py) with the SLAM-mode ``exclude_recent`` window,
their results on the host (``query``) or left on the device
(``query_device``; ``search`` over ``arrays()`` with the size a device
scalar is the search of ``locate_fused``'s program), ``detect_loop``, and
``save``/``load`` in the JAX bank's npz format (a bank written by either
package loads in the other).

``IndexConfig(quantize="int8")`` is the map-scale mode: per-row symmetric
int8 codes, an fp32 scale per row and the exact fp32 squared norm, so a
query reads a quarter of the fp32 bank's bytes (``l2_topk_int8``). Its file
holds ``bank_q`` / ``scales`` / ``bsq`` verbatim, as JAX writes it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gloc3d_tpu_torch import config as _config
from gloc3d_tpu_torch.core.device import resolve_device
from gloc3d_tpu_torch.ops.topk import (
    l2_distances, l2_distances_int8, quantize_rows, select_topk,
)


def search(arrays: Tuple[torch.Tensor, ...], queries: torch.Tensor, k: int,
           size) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k search of a bank's arrays at full capacity
    (``DescriptorBank.arrays``: fp32 rows, or int8 codes, scales and norms)
    → (dists² (Q, k), indices (Q, k) int64), rows from ``size`` on masked.
    ``size`` is an int or a device int32 scalar: a captured program reads
    the bank's size as it is at each replay, as the JAX package passes it
    traced."""
    ids = torch.arange(arrays[0].shape[0], device=arrays[0].device)
    valid = ids < size
    if len(arrays) == 3:
        return select_topk(l2_distances_int8(queries, *arrays, valid), k)
    return select_topk(l2_distances(queries, arrays[0], valid), k)


class DescriptorBank:
    """Append-only descriptor store with exact top-k query, on ``device``
    (default ``cuda``; without a card, pass ``device="cpu"``)."""

    def __init__(self, cfg, dim: Optional[int] = None,
                 device: Optional[torch.device] = None):
        self.cfg = cfg
        self.dim = dim or cfg.dim
        self.device = resolve_device(device, "DescriptorBank")
        self._capacity = cfg.capacity
        self._quantized = cfg.quantize == "int8"
        self._bank = self._zeros((self.dim,), torch.int8 if self._quantized
                                 else torch.float32)
        if self._quantized:
            self._scales = self._zeros((), torch.float32)
            self._bsq = self._zeros((), torch.float32)
        self._size = 0

    def _zeros(self, row: tuple, dtype: torch.dtype) -> torch.Tensor:
        return torch.zeros((self._capacity,) + row, dtype=dtype,
                           device=self.device)

    def __len__(self) -> int:
        return self._size

    @property
    def data(self) -> torch.Tensor:
        """The live (size, D) rows (dequantized in int8 mode)."""
        if self._quantized:
            return (self._bank[: self._size].float()
                    * self._scales[: self._size, None])
        return self._bank[: self._size]

    def arrays(self) -> Tuple[torch.Tensor, ...]:
        """The bank at full capacity, as ``search`` takes it: ``(rows,)``
        fp32, or ``(codes, scales, norms)`` in int8 mode."""
        if self._quantized:
            return self._bank, self._scales, self._bsq
        return (self._bank,)

    def truncate(self, n: int) -> None:
        """Drop entries beyond n (e.g. padded batch tails from a db build)."""
        if not 0 <= n <= self._size:
            raise ValueError(f"truncate({n}) outside [0, {self._size}]")
        self._size = n

    def _put(self, rows, scales=None, bsq=None) -> None:
        """Append rows (codes with their scales and norms in int8 mode),
        doubling the capacity until they fit."""
        rows = torch.as_tensor(rows, device=self.device)
        lo, hi = self._size, self._size + rows.shape[0]
        names = ("_bank", "_scales", "_bsq") if self._quantized else (
            "_bank",)
        if hi > self._capacity:
            while hi > self._capacity:
                self._capacity *= 2
            for name in names:
                old = getattr(self, name)
                grown = self._zeros(old.shape[1:], old.dtype)
                grown[: old.shape[0]] = old
                setattr(self, name, grown)
        for name, x in zip(names, (rows, scales, bsq)):
            getattr(self, name)[lo:hi] = torch.as_tensor(x,
                                                         device=self.device)
        self._size = hi

    def add(self, feats) -> None:
        """Append (M, D) or (D,) descriptors (numpy or tensor)."""
        feats = torch.atleast_2d(torch.as_tensor(
            feats, dtype=torch.float32, device=self.device))
        if self._quantized:
            self._put(*quantize_rows(feats))
        else:
            self._put(feats)

    def distances(self, queries: torch.Tensor,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The distance pass of a search: (Q, capacity) squared distances,
        +inf where ``valid`` is False."""
        if self._quantized:
            return l2_distances_int8(queries, self._bank, self._scales,
                                     self._bsq, valid)
        return l2_distances(queries, self._bank, valid)

    def query_device(self, queries, k: Optional[int] = None,
                     exclude_recent: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k search → (dists² (Q, k), indices (Q, k) int64) left on the
        device, for callers that go on there without a host round trip.

        ``exclude_recent=True`` hides the newest ``cfg.num_exclude_recent``
        entries (the SLAM-mode window)."""
        k = k or self.cfg.top_k
        queries = torch.atleast_2d(torch.as_tensor(
            queries, dtype=torch.float32, device=self.device))
        limit = (self._size - self.cfg.num_exclude_recent
                 if exclude_recent else self._size)
        return search(self.arrays(), queries, k,
                      min(self._size, max(limit, 0)))

    def query(self, queries, k: Optional[int] = None,
              exclude_recent: bool = False
              ) -> Tuple[np.ndarray, np.ndarray]:
        """``query_device`` with the results on the host: (dists² (Q, k),
        indices (Q, k) int32)."""
        d2, idx = self.query_device(queries, k, exclude_recent)
        return d2.cpu().numpy(), idx.to(torch.int32).cpu().numpy()

    def detect_loop(self, query) -> Optional[Tuple[int, float]]:
        """SLAM loop detection against the non-recent database: (db_index,
        dist²) if the nearest neighbour clears the metric gate, else None."""
        if self._size <= self.cfg.num_exclude_recent + self.cfg.top_k:
            return None
        d2, idx = self.query(query, k=1, exclude_recent=True)
        if float(d2[0, 0]) < self.cfg.metric_dist_threshold:
            return int(idx[0, 0]), float(d2[0, 0])
        return None

    def save(self, path: str) -> None:
        if self._quantized:
            # codes, scales and exact norms verbatim: re-quantizing the
            # dequantized rows would lose the exact norms
            n = self._size
            np.savez(path, bank_q=self._bank[:n].cpu().numpy(),
                     scales=self._scales[:n].cpu().numpy(),
                     bsq=self._bsq[:n].cpu().numpy(), dim=self.dim,
                     cfg=self.cfg.to_json())
        else:
            np.savez(path, bank=self.data.cpu().numpy(), dim=self.dim,
                     cfg=self.cfg.to_json())

    @classmethod
    def load(cls, path: str, cfg=None,
             device: Optional[torch.device] = None) -> "DescriptorBank":
        data = np.load(path, allow_pickle=False)
        if cfg is None:
            cfg = _config.IndexConfig.from_json(str(data["cfg"]))
        if "bank_q" in data and cfg.quantize != "int8":
            cfg = cfg.replace(quantize="int8")
        bank = cls(cfg, dim=int(data["dim"]), device=device)
        if "bank_q" in data:
            if data["bank_q"].shape[0]:
                bank._put(data["bank_q"], data["scales"], data["bsq"])
        elif data["bank"].shape[0]:
            bank.add(data["bank"])
        return bank
