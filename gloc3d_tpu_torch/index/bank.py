"""Device-resident descriptor bank: build, serialize, query.

Port of ``gloc3d_tpu/index/bank.py::DescriptorBank`` for the fp32 flat
bank: a ``(capacity, D)`` tensor on the device that doubles on overflow, a
``size`` watermark, exact top-k queries (ops/topk.py) with the SLAM-mode
``exclude_recent`` window, their results on the host (``query``) or left
on the device (``query_device``, the search of ``locate_fused``),
``detect_loop``, and ``save``/``load`` in the JAX bank's npz format (a bank
written by either package loads in the other). The int8 bank comes with
the map-scale port (ROADMAP Queue 1, item 13).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gloc3d_tpu_torch import config as _config
from gloc3d_tpu_torch.core.device import resolve_device
from gloc3d_tpu_torch.ops.topk import l2_topk


class DescriptorBank:
    """Append-only descriptor store with exact top-k query, on ``device``
    (default ``cuda``; without a card, pass ``device="cpu"``)."""

    def __init__(self, cfg, dim: Optional[int] = None,
                 device: Optional[torch.device] = None):
        if cfg.quantize != "none":
            raise NotImplementedError(
                f"quantize={cfg.quantize!r}: the int8 bank comes with the "
                "map-scale port (ROADMAP Queue 1, item 13)")
        self.cfg = cfg
        self.dim = dim or cfg.dim
        self.device = resolve_device(device, "DescriptorBank")
        self._capacity = cfg.capacity
        self._bank = torch.zeros((self._capacity, self.dim),
                                 dtype=torch.float32, device=self.device)
        self._size = 0

    def __len__(self) -> int:
        return self._size

    @property
    def data(self) -> torch.Tensor:
        """The live (size, D) rows."""
        return self._bank[: self._size]

    def truncate(self, n: int) -> None:
        """Drop entries beyond n (e.g. padded batch tails from a db build)."""
        if not 0 <= n <= self._size:
            raise ValueError(f"truncate({n}) outside [0, {self._size}]")
        self._size = n

    def add(self, feats) -> None:
        """Append (M, D) or (D,) descriptors (numpy or tensor)."""
        feats = torch.atleast_2d(torch.as_tensor(
            feats, dtype=torch.float32, device=self.device))
        m = feats.shape[0]
        if self._size + m > self._capacity:
            while self._size + m > self._capacity:
                self._capacity *= 2
            grown = torch.zeros((self._capacity, self.dim),
                                dtype=torch.float32, device=self.device)
            grown[: self._bank.shape[0]] = self._bank
            self._bank = grown
        self._bank[self._size : self._size + m] = feats
        self._size += m

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
        ids = torch.arange(self._capacity, device=self.device)
        valid = (ids < self._size) & (ids < max(limit, 0))
        return l2_topk(queries, self._bank, k, valid)

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
        np.savez(path, bank=self.data.cpu().numpy(), dim=self.dim,
                 cfg=self.cfg.to_json())

    @classmethod
    def load(cls, path: str, cfg=None,
             device: Optional[torch.device] = None) -> "DescriptorBank":
        data = np.load(path, allow_pickle=False)
        if "bank_q" in data:
            raise NotImplementedError(
                "int8 bank files load with the map-scale port (ROADMAP "
                "Queue 1, item 13)")
        if cfg is None:
            cfg = _config.IndexConfig.from_json(str(data["cfg"]))
        bank = cls(cfg, dim=int(data["dim"]), device=device)
        if data["bank"].shape[0]:
            bank.add(data["bank"])
        return bank
