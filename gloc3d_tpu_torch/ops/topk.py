"""Exact L2 top-k over a descriptor bank, fp32 or int8-quantized.

Port of ``gloc3d_tpu/ops/topk.py``: ``l2_topk`` (fp32) and the map-scale
pair ``quantize_rows`` / ``l2_topk_int8``. The distance is the dot form
``‖q‖² − 2q·b + ‖b‖²``, the cross term one matrix product, masked rows at
+inf; the selection is a STABLE ascending sort of the whole row, so that
ties keep the earliest index, as ``lax.top_k`` does (``torch.topk``
promises no order among ties). The TPU two-stage blocked selection
(``_neg_topk``) is a TPU workaround and is not ported.

The int8 cross term is an int8 × int8 → int32 product, exact, as JAX's
``lax.dot_general(preferred_element_type=int32)``: ``torch._int_mm``
(cuBLASLt's int8 GEMM on the card). The card refuses it unless the left
operand has more than 16 rows and both inner and right widths are
multiples of 8, so ``int8_dots`` pads to those, and computes the flat scan
as ``bank_q @ qq.T``, the bank as the tall left operand.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    return x if x.shape[0] >= rows else F.pad(x, (0, 0, 0, rows - x.shape[0]))


def int8_dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 and b (N, K) int8 → a @ b.T (M, N) int32, exact.

    On the card ``torch._int_mm`` takes M > 16 and K, N multiples of 8:
    zero rows and columns pad the operands up to that (they add nothing
    to a sum) and are cut off the result."""
    m, k = a.shape
    n = b.shape[0]
    if a.device.type == "cuda":
        kp = -(-k // 8) * 8
        if kp != k:
            a, b = F.pad(a, (0, kp - k)), F.pad(b, (0, kp - k))
        a = _pad_rows(a, 17)
        b = _pad_rows(b, -(-n // 8) * 8)
    return torch._int_mm(a, b.t())[:m, :n]


def quantize_rows(x: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization of (M, D) descriptors → (int8
    codes, fp32 per-row scales ``max(max|x|, 1e-12) / 127``, exact fp32
    squared norms). ``torch.round`` rounds half to even, as ``jnp.round``
    does."""
    x = x.float()
    scale = x.abs().amax(-1).clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale, (x * x).sum(-1)


def l2_distances(queries: torch.Tensor, bank: torch.Tensor,
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """queries (Q, D), bank (N, D), valid (N,) bool → squared L2 distances
    (Q, N), +inf where not valid."""
    q32 = queries.float()
    b32 = bank.float()
    dots = q32 @ b32.t()                                  # (Q, N)
    b_sq = (b32 * b32).sum(-1)
    q_sq = (q32 * q32).sum(-1, keepdim=True)
    d2 = q_sq - 2.0 * dots + b_sq[None, :]
    return d2 if valid is None else torch.where(valid[None, :], d2, torch.inf)


def l2_distances_int8(queries: torch.Tensor, bank_q: torch.Tensor,
                      scales: torch.Tensor, b_sq: torch.Tensor,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``l2_distances`` over an int8 bank (codes (N, D), scales (N,), exact
    norms (N,)): the queries are quantized per row on the fly, and only the
    cross term carries quantization error. JAX's order of operations."""
    qq, q_scale, q_sq = quantize_rows(torch.atleast_2d(queries))
    idots = int8_dots(bank_q, qq).t()                     # (Q, N) int32
    dots = idots.float() * (q_scale[:, None] * scales[None, :])
    d2 = q_sq[:, None] - 2.0 * dots + b_sq[None, :]
    return d2 if valid is None else torch.where(valid[None, :], d2, torch.inf)


def select_topk(d2: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, N) squared distances → the k smallest per row, ascending, ties
    to the earliest index (dists² clamped at 0, indices)."""
    d2, idx = torch.sort(d2, dim=-1, stable=True)
    return d2[:, :k].clamp_min(0.0), idx[:, :k]


def l2_topk(queries: torch.Tensor, bank: torch.Tensor, k: int,
            valid: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries (Q, D), bank (N, D), valid (N,) bool → (dists² (Q, k)
    ascending, indices (Q, k))."""
    return select_topk(l2_distances(queries, bank, valid), k)


def l2_topk_int8(queries: torch.Tensor, bank_q: torch.Tensor,
                 scales: torch.Tensor, b_sq: torch.Tensor, k: int,
                 valid: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``l2_topk`` with the bank as (codes int8 (N, D), scales (N,), exact
    squared norms (N,))."""
    return select_topk(
        l2_distances_int8(queries, bank_q, scales, b_sq, valid), k)
