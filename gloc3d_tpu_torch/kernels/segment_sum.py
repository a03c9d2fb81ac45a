"""Segment sums over segment-sorted rows: the CUDA kernel and its plain twin.

Replaces the TPU kernel ``gloc3d_tpu/ops/pallas_scatter.py::
_cumsum_rows_128`` (reached through ``segment_sum_sorted_fast`` /
``segment_sum_sorted_grad``), which the PointPillar's sorted feature mean
runs on every query. Semantics: ``values (..., N, C)`` sorted by segment and
``starts (..., V+1)`` segment offsets give ``(..., V, C)`` sums, with empty
segments 0.

On a CUDA tensor the wrapper launches ``csrc/segment_sum.cu`` (design and
bound in that file's header: memory-bound, ~31 MB read and 2.9 MB written
per scan at the main-path shape) or raises; on a CPU tensor it runs the
plain version. There is no fallback between the two. Making the kernel fast
(wider loads, fusing the divide by the pillar counts) is later work; its
time and the plain version's are in PERF.md.

The kernel is launched through ctypes, so its output carries no autograd
history: ``segment_sum_sorted_grad`` (the port of the JAX custom VJP
``segment_sum_sorted_grad``) wraps it in an autograd Function whose
backward is the exact row gather ``d_values[i] = g[ids[i]]``. Without it
the gradient would stop at the kernel on the card and only there.
"""

from __future__ import annotations

import ctypes

import torch

from gloc3d_tpu_torch.kernels import build
from gloc3d_tpu_torch.ops.gather import row_gather

MAX_CHANNELS = 256


def segment_sum_sorted_plain(values: torch.Tensor,
                             starts: torch.Tensor) -> torch.Tensor:
    """Reference version: segment ids from ``starts.diff()``, then an fp32
    ``index_add_``. Rows outside ``[starts[0], starts[V])`` are ignored."""
    batched = values.dim() == 3
    vals = values if batched else values[None]
    sts = (starts if batched else starts[None]).long()
    b, _, c = vals.shape
    v = sts.shape[-1] - 1
    out = torch.zeros((b, v, c), dtype=torch.float32, device=vals.device)
    seg = torch.arange(v, device=vals.device)
    for i in range(b):
        lo, hi = int(sts[i, 0]), int(sts[i, -1])
        ids = torch.repeat_interleave(seg, sts[i].diff())
        out[i].index_add_(0, ids, vals[i, lo:hi].float())
    return out if batched else out[0]


def _check(values: torch.Tensor, starts: torch.Tensor) -> None:
    if values.device != starts.device:
        raise ValueError("values and starts must be on the same device")
    if values.dtype != torch.float32:
        raise TypeError(f"values must be float32, got {values.dtype}")
    if starts.dtype != torch.int32:
        raise TypeError(f"starts must be int32, got {starts.dtype}")
    if values.dim() not in (2, 3) or starts.dim() != values.dim() - 1:
        raise ValueError(f"expected values (B, N, C) with starts (B, V+1) "
                         f"or values (N, C) with starts (V+1,); got "
                         f"{tuple(values.shape)} and {tuple(starts.shape)}")
    if values.shape[:-2] != starts.shape[:-1]:
        raise ValueError("values and starts disagree on the batch size")
    c = values.shape[-1]
    if c % 2 or not 0 < c <= MAX_CHANNELS:
        raise ValueError(f"C={c}: the kernel takes an even C up to "
                         f"{MAX_CHANNELS}")
    if starts.shape[-1] < 2:
        raise ValueError("starts needs at least 2 entries (V >= 1)")
    if not (values.is_contiguous() and starts.is_contiguous()):
        raise ValueError("values and starts must be contiguous")
    if values.data_ptr() % 8:
        raise ValueError("values must be 8-byte aligned (float2 loads)")


def segment_sum_sorted(values: torch.Tensor,
                       starts: torch.Tensor) -> torch.Tensor:
    """``(..., N, C)`` fp32 rows sorted by segment → ``(..., V, C)`` sums.

    CUDA tensors launch the hand-written kernel (counted in
    ``segment_sum_sorted.launches``); CPU tensors take the plain version.
    """
    if values.device.type == "cpu" and starts.device.type == "cpu":
        return segment_sum_sorted_plain(values, starts)
    _check(values, starts)
    if values.device.type != "cuda":
        raise ValueError(f"no segment-sum kernel for device {values.device}")
    return _launch(values, starts)


def _launch(values: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Allocate the zeroed output and launch the kernel on CUDA tensors that
    passed ``_check``."""
    batched = values.dim() == 3
    b = values.shape[0] if batched else 1
    n, c = values.shape[-2:]
    v = starts.shape[-1] - 1
    out = torch.zeros(values.shape[:-2] + (v, c), dtype=torch.float32,
                      device=values.device)
    if b == 0 or n == 0:
        return out
    lib = build.load("segment_sum")
    fn = lib.gloc3d_segment_sum_sorted
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 4 + [
        ctypes.c_void_p]
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(values.data_ptr(), starts.data_ptr(), out.data_ptr(),
                b, n, v, c, stream)
    if rc != 0:
        raise RuntimeError(f"segment_sum_sorted kernel launch failed: CUDA "
                           f"error {rc}")
    segment_sum_sorted.launches += 1
    return out


segment_sum_sorted.launches = 0


class _SegmentSumSortedGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, starts, ids):
        ctx.save_for_backward(ids)
        return segment_sum_sorted(values, starts)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        segment_sum_sorted_grad.backward_calls += 1
        return row_gather(g, ids), None, None


def segment_sum_sorted_grad(values: torch.Tensor, starts: torch.Tensor,
                            ids: torch.Tensor) -> torch.Tensor:
    """``segment_sum_sorted`` with a gradient for ``values``: the backward
    of a segment sum gives every row its segment's cotangent, one row
    gather. ``ids (..., N)`` are the per-row segment ids consistent with
    ``starts`` (the pillar-sorted ids of the host stats pass); ``starts``
    and ``ids`` get no gradient. Backward calls are counted in
    ``segment_sum_sorted_grad.backward_calls``."""
    return _SegmentSumSortedGrad.apply(values, starts, ids)


segment_sum_sorted_grad.backward_calls = 0
