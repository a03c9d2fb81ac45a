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

The wrapper calls the custom op ``gloc3d::pillar_bin_sums`` (``ops.py``),
so a traced or exported program carries the op and not the version its
tracing device ran. On a CUDA tensor the op launches
``csrc/pillar_bin_sums.cu`` (design and bound in that file's header: a
stable counting sort of the row indices by pillar from the ids alone, then
each pillar's rows gathered and added in that fixed order, in fp32 within
64 sorted positions and fp64 above, and rounded once, so every launch
gives the same bits and an item gives the same bits in any batch) or
raises; on a CPU tensor it runs the plain
version. There is no fallback between the two. The wrapper types the C
entry once and allocates the outputs and the scratch with ``torch.empty``.

The id-range check is the kernel's own reading on a CUDA tensor: the kernel
counts the ids outside ``[0, V)`` it reads (and leaves those rows out),
notes the first one, and the wrapper copies that status block to the host
once per call and raises ``ValueError`` if it is not clean, with the host's
own reading of the ids beside it (``status_message``). On a CPU tensor
``_check`` reads the range on the host.

Within ``deferred_status()`` the wrapper reads nothing on the host: it
calls the op ``gloc3d::pillar_bin_sums_status``, which returns the status
block beside the sums (the kernel's on a CUDA tensor, the same words from
tensor operations on a CPU tensor, which then also leave the bad rows out),
and notes each launch's status, ids and V for its caller, which checks them
once the status has come to the host with its other results
(``check_deferred``, which raises the same ``ValueError``). That is how a
captured CUDA graph runs K2 (``pipeline.py::GlobalLocalizer.locate_fused``):
capture forbids the copy inside the op.

A launch inside a CUDA graph capture is recorded, not run: it is counted in
``pillar_bin_sums.captured``, and a graph's replays in
``pillar_bin_sums.replayed`` (by whoever replays it), not in ``launches``.

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
from typing import List, Optional, Tuple

import torch

from gloc3d_tpu_torch import profiling
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


def pillar_bin_sums_status_plain(features: torch.Tensor, ids: torch.Tensor,
                                 num_voxels: int
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """``pillar_bin_sums_plain`` with the kernel's status block, in tensor
    operations (no host read): ids outside ``[0, V)`` are left out of the
    sums and the counts, as the kernel leaves them, and each item's status
    is (bad ids, the first such row, its id, rows placed), zeros for the
    row and id of a clean item."""
    n = ids.shape[-1]
    flat = ids.reshape(-1, n)
    bad = (flat < 0) | (flat >= num_voxels)
    n_bad = bad.sum(-1)
    first = bad.int().argmax(-1)
    value = torch.where(n_bad > 0, flat.gather(-1, first[:, None])[:, 0], 0)
    status = torch.stack([n_bad, first, value, n - n_bad], -1).int()
    safe = torch.where(bad, num_voxels, flat).reshape(ids.shape).int()
    sums, counts = pillar_bin_sums_plain(features, safe, num_voxels + 1)
    return (sums[..., :-1, :].contiguous(), counts[..., :-1].contiguous(),
            status)


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
    if ids.numel() and ids.device.type == "cpu":
        lo, hi = (int(t) for t in torch.aminmax(ids))
        if lo < 0 or hi >= num_voxels:
            raise ValueError(f"ids span [{lo}, {hi}], outside [0, "
                             f"{num_voxels}); "
                             + _host_reading(ids, num_voxels))


def _host_reading(host_ids: torch.Tensor, num_voxels: int) -> str:
    bad = (host_ids < 0) | (host_ids >= num_voxels)
    first = bad.reshape(-1).nonzero()[:4, 0].tolist()
    return (f"read back to the host they span [{int(host_ids.min())}, "
            f"{int(host_ids.max())}], {int(bad.sum())} of {host_ids.numel()} "
            f"out of range (first at flat rows {first}, shape "
            f"{tuple(host_ids.shape)})")


def status_message(status, host_ids: torch.Tensor, num_voxels: int) -> str:
    """The error for a kernel status ``(B, 4)`` (per item: ids outside
    ``[0, V)``, the first such row, its id, rows placed) that is not clean,
    with the host's reading of the same ids beside the kernel's, so that a
    recurrence shows whether the ids in memory were bad or the read was."""
    st = torch.as_tensor(status).reshape(-1, 4).long()
    n = host_ids.shape[-1] if host_ids.dim() else 1
    bad = int(st[:, 0].sum())
    item = int((st[:, 0] > 0).nonzero()[0, 0]) if bad else 0
    row, value = int(st[item, 1]), int(st[item, 2])
    return (f"the kernel read {bad} of {host_ids.numel()} ids outside [0, "
            f"{num_voxels}) (first at flat row {item * n + row}, id {value}); "
            + _host_reading(host_ids, num_voxels))


def _check_status(status: torch.Tensor, ids: torch.Tensor, num_voxels: int
                  ) -> None:
    """Raise ``ValueError`` if the kernel read ids outside ``[0, V)``: one
    copy of the status block to the host (a synchronisation), and on a
    fault a second, host copy of the ids."""
    st = profiling.to_host(status)
    if int(st[:, 0].sum()):
        raise ValueError(status_message(st, ids.cpu(), num_voxels))


_DEFERRED: Optional[List[tuple]] = None


@contextlib.contextmanager
def deferred_status():
    """Within: every ``pillar_bin_sums`` call leaves its status on the
    device and appends ``(status (B, 4) int32, ids, num_voxels)`` to the
    list this yields, for ``check_deferred`` once the status words are on
    the host."""
    global _DEFERRED
    outer, _DEFERRED = _DEFERRED, []
    try:
        yield _DEFERRED
    finally:
        _DEFERRED = outer


def check_deferred(statuses, launches) -> None:
    """Raise ``_check_status``'s ``ValueError`` for the first launch whose
    status, read back to the host (``statuses``: one (B, 4) block per
    launch), counts a bad id; ``launches``: their ``(status, ids,
    num_voxels)`` from ``deferred_status``, whose ids are read to the host
    only then."""
    for st, (_, ids, num_voxels) in zip(statuses, launches):
        if int(st[:, 0].sum()):
            raise ValueError(status_message(st, ids.cpu(), num_voxels))


def pillar_bin_sums(features: torch.Tensor, ids: torch.Tensor,
                    num_voxels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(..., N, C)`` fp32 rows binned by ``(..., N)`` int32 ids →
    ``(sums (..., V, C), counts (..., V))``, through the custom op
    ``gloc3d::pillar_bin_sums`` (``ops.py``), or within
    ``deferred_status()`` ``gloc3d::pillar_bin_sums_status``.

    CUDA tensors launch the hand-written kernel (counted in
    ``pillar_bin_sums.launches``); CPU tensors take the plain version.
    """
    if _DEFERRED is None:
        return torch.ops.gloc3d.pillar_bin_sums(features, ids, num_voxels)
    sums, counts, status = torch.ops.gloc3d.pillar_bin_sums_status(
        features, ids, num_voxels)
    _DEFERRED.append((status, ids, num_voxels))
    return sums, counts


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
        size = lib.gloc3d_pillar_bin_sums_scratch_bytes
        size.restype = ctypes.c_int64
        size.argtypes = [ctypes.c_int64] * 4
        _fns = fn, size
    return _fns


def _launch(features: torch.Tensor, ids: torch.Tensor, num_voxels: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Allocate the outputs and the scratch (``torch.empty``: the kernels
    write every word they read, and zero their own counters) and launch the
    kernels on CUDA tensors that passed ``_check``. Returns the sums, the
    counts and the kernel's status block ``(B, 4)`` int32, still on the
    card: the launch itself does not synchronise."""
    lead = features.shape[:-2]
    n, c = features.shape[-2:]
    b = math.prod(lead)
    dev = features.device
    sums = torch.empty(lead + (num_voxels, c), dtype=torch.float32,
                       device=dev)
    counts = torch.empty(lead + (num_voxels,), dtype=torch.float32,
                         device=dev)
    if b == 0:
        return sums, counts, torch.zeros((0, 4), dtype=torch.int32,
                                         device=dev)
    fn, scratch_bytes = _kernel_fns()
    guard = (torch.cuda.device(dev) if dev.index is not None
             and dev.index != torch.cuda.current_device()
             else contextlib.nullcontext())
    with guard:
        scratch = torch.empty(scratch_bytes(b, n, num_voxels, c),
                              dtype=torch.uint8, device=dev)
        rc = fn(features.data_ptr(), ids.data_ptr(), sums.data_ptr(),
                counts.data_ptr(), scratch.data_ptr(), b, n, num_voxels, c,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pillar_bin_sums kernel launch failed: CUDA "
                           f"error {rc}")
    if torch.cuda.is_current_stream_capturing():
        pillar_bin_sums.captured += 1
    else:
        pillar_bin_sums.launches += 1
    return sums, counts, scratch[:16 * b].view(torch.int32).view(b, 4)


pillar_bin_sums.launches = 0
pillar_bin_sums.captured = 0  # launches recorded into a CUDA graph
pillar_bin_sums.replayed = 0  # launches run by replays of such graphs


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
