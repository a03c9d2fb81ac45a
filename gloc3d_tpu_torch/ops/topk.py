"""Exact L2 top-k over a descriptor bank.

Port of ``gloc3d_tpu/ops/topk.py::l2_topk`` (fp32): one matmul for the
cross term, masked rows at +inf, and a STABLE ascending sort so that ties
keep the earliest index, as ``lax.top_k`` does (``torch.topk`` promises no
order among ties). The TPU two-stage blocked selection (``_neg_topk``) is a
TPU workaround and is not ported; the int8 bank comes with the map-scale
port (ROADMAP Queue 1, item 13).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def l2_topk(queries: torch.Tensor, bank: torch.Tensor, k: int,
            valid: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries (Q, D), bank (N, D), valid (N,) bool → (dists² (Q, k)
    ascending, indices (Q, k))."""
    q32 = queries.float()
    b32 = bank.float()
    dots = q32 @ b32.t()                                  # (Q, N)
    b_sq = (b32 * b32).sum(-1)
    q_sq = (q32 * q32).sum(-1, keepdim=True)
    d2 = q_sq - 2.0 * dots + b_sq[None, :]
    if valid is not None:
        d2 = torch.where(valid[None, :], d2, torch.inf)
    d2, idx = torch.sort(d2, dim=-1, stable=True)
    return d2[:, :k].clamp_min(0.0), idx[:, :k]
