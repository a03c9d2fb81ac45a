"""k-NN PCA normals in float64: the CUDA kernel and its plain twin.

Replaces no TPU kernel: it replaces the k-NN and the PCA of the JAX
function ``gloc3d_tpu/ops/ground.py::estimate_ground`` (an (M, M) distance
matrix, ``approx_min_k`` over its rows, the neighbours' covariance and its
smallest eigenvector), which the ground estimate runs on every aligned scan
over its ``num_candidates`` subsample. Semantics: ``points (B, M, 3)``
float64 and ``ok (B, M)`` give ``normals (B, M, 3)`` float64, row i the
smallest eigenvector of the covariance / k of its k nearest points by
``d2(i, j) = (|p_i|² - 2 p_i·p_j) + |p_j|²``, the row itself included.
Columns with ``ok`` false count as +inf, as does a NaN distance (only a
point that is not finite gives one). At equal distances the earliest index
wins, and with fewer than k finite columns the earliest infinite ones fill
the set (``torch.topk`` promises neither: the plain version takes its k-th
value and, where equal distances straddle it, the earliest of them).

The wrapper calls the custom op ``gloc3d::knn_normals`` (``ops.py``), so a
traced or exported program carries the op and not the version its tracing
device ran. On a CUDA tensor the op launches ``csrc/knn_normals.cu``
(design and bound in that file's header: no (M, M) matrix, a warp's running
top-k over the columns staged in shared memory, then the covariance and the
closed-form eigenvector in the same warp; float64-bound, and every launch
gives the same bits) or raises; on a CPU tensor it runs the plain version.
There is no fallback between the two.

A launch inside a CUDA graph capture is recorded, not run: it is counted
in ``knn_normals.captured``, and a graph's replays in
``knn_normals.replayed`` (by whoever replays it), not in ``launches``.
"""

from __future__ import annotations

import contextlib
import ctypes
import math

import torch

from gloc3d_tpu_torch.kernels import build

MAX_K = 32


def _smallest_eigvec_3x3(a: torch.Tensor) -> torch.Tensor:
    """Closed-form smallest eigenvector of batched symmetric (…, 3, 3):
    trigonometric (Cardano) eigenvalues, then the column of (A−λ1)(A−λ2)
    with the largest norm. Degenerate (isotropic) inputs return +Z."""
    diag = a.diagonal(dim1=-2, dim2=-1)
    q = diag.sum(-1) / 3.0
    a01, a02, a12 = a[..., 0, 1], a[..., 0, 2], a[..., 1, 2]
    p1 = a01 ** 2 + a02 ** 2 + a12 ** 2
    dq = diag - q[..., None]
    p2 = torch.sum(dq * dq, -1) + 2.0 * p1
    p = torch.sqrt(torch.clamp_min(p2 / 6.0, 1e-20))
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    b = (a - q[..., None, None] * eye) / p[..., None, None]
    detb = torch.linalg.det(b)
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    lam1 = q + 2.0 * p * torch.cos(phi)                        # largest
    lam3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    lam2 = 3.0 * q - lam1 - lam3
    c = torch.matmul(a - lam1[..., None, None] * eye,
                     a - lam2[..., None, None] * eye)
    norms = torch.linalg.vector_norm(c, dim=-2)                # column norms
    best = torch.argmax(norms, dim=-1)
    v = torch.gather(c, -1, best[..., None, None].expand(
        c.shape[:-1] + (1,)))[..., 0]
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    up = torch.zeros_like(v)
    up[..., 2] = 1.0
    degenerate = (p2 < 1e-16) | (n[..., 0] < 1e-12)
    return torch.where(degenerate[..., None], up,
                       v / torch.clamp_min(n, 1e-20))


def _smallest_k(d2: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of each row's k smallest values, ordered by (value,
    index): ``torch.topk`` for the k-th value, then, in rows where equal
    values straddle it, the earliest of them (one host read decides)."""
    vals, idx = torch.topk(d2, k, dim=-1, largest=False)
    kth = vals[..., -1:]
    if bool(((d2 == kth).sum(-1) > (vals == kth).sum(-1)).any()):
        below = d2 < kth
        at = d2 == kth
        take = below | (at & (torch.cumsum(at, -1)
                              <= k - below.sum(-1, keepdim=True)))
        idx = take.nonzero()[:, -1].reshape(idx.shape)
    else:
        idx = torch.sort(idx, dim=-1).values
    order = torch.sort(d2.gather(-1, idx), dim=-1, stable=True).indices
    return idx.gather(-1, order)


def knn_covariance_plain(points: torch.Tensor, ok: torch.Tensor,
                         k: int) -> torch.Tensor:
    """The plain version's (B, M, 3, 3) neighbour covariances: the (B, M, M)
    distance matrix, the k smallest of each row (``_smallest_k``), the
    neighbours' covariance / k."""
    b = points.shape[0]
    sq = torch.sum(points * points, -1)
    d2 = (sq[:, :, None] - 2.0 * torch.bmm(points, points.transpose(1, 2))
          + sq[:, None, :])
    d2 = torch.where(ok[:, None, :], d2, math.inf).nan_to_num_(
        nan=math.inf, posinf=math.inf, neginf=-math.inf)
    nn = _smallest_k(d2, k)                            # incl. self
    rows = torch.arange(b, device=points.device)[:, None, None]
    nbr = points[rows, nn]                             # (B, M, K, 3)
    c = nbr - nbr.mean(dim=2, keepdim=True)
    return torch.einsum("bmki,bmkj->bmij", c, c) / k


def knn_normals_plain(points: torch.Tensor, ok: torch.Tensor,
                      k: int) -> torch.Tensor:
    """Reference version: ``_smallest_eigvec_3x3`` of
    ``knn_covariance_plain``."""
    return _smallest_eigvec_3x3(knn_covariance_plain(points, ok, k))


def _check(points: torch.Tensor, ok: torch.Tensor, k: int) -> None:
    if points.device != ok.device:
        raise ValueError("points and ok must be on the same device")
    if points.dtype != torch.float64:
        raise TypeError(f"points must be float64, got {points.dtype}")
    if ok.dtype != torch.bool:
        raise TypeError(f"ok must be bool, got {ok.dtype}")
    if points.dim() != 3 or points.shape[-1] != 3 \
            or ok.shape != points.shape[:2]:
        raise ValueError(f"expected points (B, M, 3) with ok (B, M); got "
                         f"{tuple(points.shape)} and {tuple(ok.shape)}")
    m = points.shape[1]
    if not 1 <= k <= min(MAX_K, max(m, 1)):
        raise ValueError(f"k={k}: the kernel takes 1 <= k <= min({MAX_K}, "
                         f"M={m})")
    if not (points.is_contiguous() and ok.is_contiguous()):
        raise ValueError("points and ok must be contiguous")


def knn_normals(points: torch.Tensor, ok: torch.Tensor,
                k: int) -> torch.Tensor:
    """``(B, M, 3)`` float64 points and ``(B, M)`` bool validity →
    ``(B, M, 3)`` float64 k-NN PCA normals, through the custom op
    ``gloc3d::knn_normals`` (``ops.py``).

    CUDA tensors launch the hand-written kernel (counted in
    ``knn_normals.launches``); CPU tensors take the plain version.
    """
    return torch.ops.gloc3d.knn_normals(points, ok, k)


knn_normals.launches = 0
knn_normals.captured = 0  # launches recorded into a CUDA graph
knn_normals.replayed = 0  # launches run by replays of such graphs

_fn = None


def _kernel_fn():
    """The kernel's C entry, loaded and typed once."""
    global _fn
    if _fn is None:
        fn = build.load("knn_normals").gloc3d_knn_normals
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [
            ctypes.c_void_p]
        _fn = fn
    return _fn


def _launch(points: torch.Tensor, ok: torch.Tensor, k: int) -> torch.Tensor:
    """Allocate the normals and launch the kernel on CUDA tensors that
    passed ``_check``. The launch does not synchronise."""
    b, m = points.shape[:2]
    dev = points.device
    out = torch.empty_like(points)
    if out.numel() == 0:
        return out
    guard = (torch.cuda.device(dev) if dev.index is not None
             and dev.index != torch.cuda.current_device()
             else contextlib.nullcontext())
    with guard:
        rc = _kernel_fn()(points.data_ptr(), ok.data_ptr(), out.data_ptr(),
                          b, m, k, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"knn_normals kernel launch failed: CUDA error "
                           f"{rc}")
    if torch.cuda.is_current_stream_capturing():
        knn_normals.captured += 1
    else:
        knn_normals.launches += 1
    return out
