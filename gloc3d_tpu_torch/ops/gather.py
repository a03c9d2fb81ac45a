"""Batched row gather: the backward of a segment sum.

Counterpart of ``gloc3d_tpu/ops/gather.py::row_gather``, which the JAX
package uses for the VJP of its sorted segment sum. The TPU version is a
vmapped ``dynamic_slice`` (a lowering workaround); here it is one
``index_select`` over batch-offset ids, a plain row copy.
"""

from __future__ import annotations

import math

import torch


def row_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table (..., V, C)``, ``ids (..., N)`` in ``[0, V)`` → ``(..., N,
    C)`` with ``out[..., i, :] = table[..., ids[..., i], :]``."""
    lead = ids.shape[:-1]
    n = ids.shape[-1]
    v, c = table.shape[-2:]
    b = math.prod(lead)
    flat = (ids.reshape(b, n).long()
            + torch.arange(b, device=ids.device)[:, None] * v).reshape(-1)
    return table.reshape(b * v, c).index_select(0, flat).reshape(
        lead + (n, c))
