"""Unsorted pillar binning: the CUDA kernel K2 and its plain twin.

Replaces the TPU kernel ``gloc3d_tpu/ops/pallas_scatter.py::
pillar_bin_sums`` (batched by ``pillar_bin_mean``), which the all-device
extraction runs twice per scan: the pillar statistics ``[valid, x, y, z]``
of ``ops/voxelize.py::points_to_voxels`` and the PointNet feature mean of
``scatter_mean_to_grid``. Semantics: ``features (..., N, C)`` binned by
``ids (..., N)`` in ``[0, V)`` give ``sums (..., V, C)`` and ``counts
(..., V)``, where the counts include every row (padding and out-of-grid rows
carry id 0). Sums are fp32, as the XLA scatter of the JAX serving path; the
TPU kernel's bf16 one-hot products are not the semantics held.

On a CUDA tensor the wrapper launches ``csrc/pillar_bin_sums.cu`` (design
and bound in that file's header: a narrow kernel for C <= 8, a wide one
for larger C, pillar 0 summed in a fixed order from per-block partials by
a second launch) or raises; on a CPU tensor it runs the plain version.
There is no fallback between the two. The wrapper types the C entry once
and allocates with ``torch.empty``; the C entry sizes the grid and zeroes
the outputs on the stream. The id-range check still reads the range back
to the host.

The ctypes launch leaves no autograd history: ``pillar_bin_sums_grad`` wraps
the binning in an autograd Function for the PointNet feature mean, with the
backward of the JAX package's XLA scatter (``ops/voxelize.py::
scatter_mean_to_grid``), the row gather ``d_features[i] = g_sums[ids[i]]``.
The statistics binning bins input coordinates and stays on the plain
wrapper.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Tuple

import torch

from gloc3d_tpu_torch.kernels import build
from gloc3d_tpu_torch.ops.gather import row_gather

MAX_CHANNELS = 256


def pillar_bin_sums_plain(features: torch.Tensor, ids: torch.Tensor,
                          num_voxels: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference version: an ``index_add_`` and a ``bincount`` over
    batch-offset ids. The sums accumulate in float64 and round to fp32 once:
    pillar 0 collects the coordinates of ~82 000 out-of-grid rows of a real
    scan, and an fp32 ``index_add_`` adds them one by one onto a running sum
    of ~3e6 (a rounding step of ~0.25 per add); on an H100 such a version
    and the kernel differed there by 9e-6 of the L1 mass, too close to the
    1e-5 the kernel is held to for a reference."""
    lead = features.shape[:-2]
    n, c = features.shape[-2:]
    b = math.prod(lead)
    flat = (ids.reshape(b, n).long()
            + torch.arange(b, device=ids.device)[:, None] * num_voxels
            ).reshape(-1)
    sums = torch.zeros((b * num_voxels, c), dtype=torch.float64,
                       device=features.device)
    sums.index_add_(0, flat, features.reshape(b * n, c).double())
    counts = torch.bincount(flat, minlength=b * num_voxels).float()
    return (sums.float().reshape(lead + (num_voxels, c)),
            counts.reshape(lead + (num_voxels,)))


def _check(features: torch.Tensor, ids: torch.Tensor, num_voxels: int
           ) -> None:
    if features.device != ids.device:
        raise ValueError("features and ids must be on the same device")
    if features.dtype != torch.float32:
        raise TypeError(f"features must be float32, got {features.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if features.dim() < 2 or features.shape[:-1] != ids.shape:
        raise ValueError(f"expected features (..., N, C) with ids (..., N); "
                         f"got {tuple(features.shape)} and "
                         f"{tuple(ids.shape)}")
    c = features.shape[-1]
    if not 0 < c <= MAX_CHANNELS:
        raise ValueError(f"C={c}: the kernel takes 1 to {MAX_CHANNELS} "
                         f"channels")
    if num_voxels < 1:
        raise ValueError("num_voxels must be at least 1")
    if not (features.is_contiguous() and ids.is_contiguous()):
        raise ValueError("features and ids must be contiguous")
    if ids.numel():
        lo, hi = (int(t) for t in torch.aminmax(ids))
        if lo < 0 or hi >= num_voxels:
            # A second reading tells bad ids from a bad device reduction.
            host = ids.cpu()
            bad = (host < 0) | (host >= num_voxels)
            first = bad.reshape(-1).nonzero()[:4, 0].tolist()
            raise ValueError(
                f"ids span [{lo}, {hi}], outside [0, {num_voxels}); read back "
                f"to the host they span [{int(host.min())}, "
                f"{int(host.max())}], {int(bad.sum())} of {host.numel()} "
                f"out of range (first at flat rows {first}, shape "
                f"{tuple(ids.shape)})")


def pillar_bin_sums(features: torch.Tensor, ids: torch.Tensor,
                    num_voxels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(..., N, C)`` fp32 rows binned by ``(..., N)`` int32 ids →
    ``(sums (..., V, C), counts (..., V))``.

    CUDA tensors launch the hand-written kernel (counted in
    ``pillar_bin_sums.launches``); CPU tensors take the plain version.
    """
    if features.device.type == "cpu" and ids.device.type == "cpu":
        return pillar_bin_sums_plain(features, ids, num_voxels)
    _check(features, ids, num_voxels)
    if features.device.type != "cuda":
        raise ValueError(f"no pillar-binning kernel for device "
                         f"{features.device}")
    return _launch(features, ids, num_voxels)


_fns = None


def _kernel_fns():
    """The kernel's C entry and its scratch size, loaded and typed once."""
    global _fns
    if _fns is None:
        lib = build.load("pillar_bin_sums")
        fn = lib.gloc3d_pillar_bin_sums
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 4 + [
            ctypes.c_void_p]
        size = lib.gloc3d_pillar_bin_sums_scratch_floats
        size.restype = ctypes.c_int64
        size.argtypes = [ctypes.c_int64] * 3
        _fns = fn, size
    return _fns


def _launch(features: torch.Tensor, ids: torch.Tensor, num_voxels: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Allocate the outputs and the pillar-0 partials (``torch.empty``: the
    C entry zeroes the outputs on the stream and sizes the grid) and launch
    the kernels on CUDA tensors that passed ``_check`` (the check reads the
    id range back to the host; the launch itself does not synchronise)."""
    lead = features.shape[:-2]
    n, c = features.shape[-2:]
    b = math.prod(lead)
    dev = features.device
    sums = torch.empty(lead + (num_voxels, c), dtype=torch.float32,
                       device=dev)
    counts = torch.empty(lead + (num_voxels,), dtype=torch.float32,
                         device=dev)
    if b == 0:
        return sums, counts
    fn, scratch_floats = _kernel_fns()
    guard = (torch.cuda.device(dev) if dev.index is not None
             and dev.index != torch.cuda.current_device()
             else contextlib.nullcontext())
    with guard:
        size = scratch_floats(b, n, c)
        if size < 0:
            raise RuntimeError("pillar_bin_sums: cannot read the device's "
                               "SM count")
        scratch = torch.empty(size, dtype=torch.float32, device=dev)
        rc = fn(features.data_ptr(), ids.data_ptr(), sums.data_ptr(),
                counts.data_ptr(), scratch.data_ptr(), b, n, num_voxels, c,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pillar_bin_sums kernel launch failed: CUDA "
                           f"error {rc}")
    pillar_bin_sums.launches += 1
    return sums, counts


pillar_bin_sums.launches = 0


class _PillarBinSumsGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, ids, num_voxels):
        sums, counts = pillar_bin_sums(features, ids, num_voxels)
        ctx.save_for_backward(ids)
        ctx.mark_non_differentiable(counts)
        return sums, counts

    @staticmethod
    def backward(ctx, g_sums, g_counts):
        (ids,) = ctx.saved_tensors
        pillar_bin_sums_grad.backward_calls += 1
        return row_gather(g_sums, ids), None, None


def pillar_bin_sums_grad(features: torch.Tensor, ids: torch.Tensor,
                         num_voxels: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``pillar_bin_sums`` with a gradient for ``features`` (the sums' row
    gather); the counts carry none. Backward calls are counted in
    ``pillar_bin_sums_grad.backward_calls``."""
    return _PillarBinSumsGrad.apply(features, ids, num_voxels)


pillar_bin_sums_grad.backward_calls = 0
