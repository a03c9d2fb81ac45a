"""Pose refinement: rigid 3-D ICP, planar ICP on BEV virtual clouds, 2-D and
3-D NDT, and the ergodic roll/pitch sweep.

Port of ``gloc3d_tpu/ops/refine.py``. Every function is PyTorch ops and the
library calls they make: the exact nearest neighbours of an ICP step are one
(N, M) distance matrix from a matmul (cuBLAS, run with TF32 off: a TF32
product moves the argmin), the 3-D Kabsch update is a 3×3 SVD (cuSOLVER on
the card), and the NDT maps are ``index_add_`` scatters. Iteration counts
are fixed and every loop stays on the device: no value is read back to the
host inside one (the library calls may synchronise on their own).

Where the JAX functions take their virtual clouds behind
``jax.random.permutation(PRNGKey(0), S²)``, which torch cannot replay,
``bev_to_virtual_points`` and ``ops/contour.py::contour_virtual_cloud``
take an injectable ``perm``; the default is a fixed ``torch.randperm`` from
a generator seeded with 0. The selection is JAX's ``lax.top_k`` on a 0/1
flag (the earliest position wins a tie), here a stable descending sort.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from gloc3d_tpu_torch.core.transforms import (
    Rigid3, matrix_to_quat, quat_from_rpy, quat_to_matrix,
)
from gloc3d_tpu_torch.ops.bev import BEVImage, batch_scan_to_bev
from gloc3d_tpu_torch.ops.bev_match import MatchResult, _ieee_matmul, \
    match_bev

Tensor = torch.Tensor


class ICPResult(NamedTuple):
    transform: Rigid3     # refined src→dst
    rmse: Tensor          # () inlier RMSE at the last iteration
    num_inliers: Tensor   # () int32 correspondences within max_corr_dist


def _det3(m: Tensor) -> Tensor:
    """Determinant of (..., 3, 3) by cofactors: elementwise, no LU."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2]
                            - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2]
                              - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1]
                              - m[..., 1, 1] * m[..., 2, 0]))


def _nearest(moved: Tensor, dst: Tensor, dst_sq: Tensor, dst_valid: Tensor):
    """Exact nearest valid dst row of every moved row: (index, distance²)
    from the ‖a‖² − 2a·b + ‖b‖² matrix (ties to the lower index)."""
    d2 = ((moved * moved).sum(-1)[:, None] - 2.0 * moved @ dst.T
          + dst_sq[None, :])
    d2 = torch.where(dst_valid[None, :], d2, math.inf)
    nn_d2, nn = d2.min(dim=1)
    return nn, nn_d2


def icp_point_to_point(
    src: Tensor, src_mask: Tensor,
    dst: Tensor, dst_mask: Tensor,
    init: Rigid3,
    iterations: int = 20,
    max_corr_dist: float = 1.0,
) -> ICPResult:
    """Rigid ICP of src (N, 3) onto dst (M, 3) from an initial guess.

    Each step pairs every valid src point with its exact nearest valid dst
    point, gates the pairs at ``max_corr_dist`` and applies the weighted
    Kabsch update (3×3 SVD with the determinant sign fix). A step without
    one pair in the gate leaves the pose as it is (its covariance is 0,
    whose SVD LAPACK returns as U = V = I; cuSOLVER promises no basis for
    it, so the identity is taken explicitly). (rmse, inliers) are those of
    the last step."""
    dst_sq = (dst * dst).sum(-1)
    dst_valid = dst_mask > 0
    src_on = src_mask > 0
    eye = torch.eye(3, dtype=src.dtype, device=src.device)
    q = torch.as_tensor(init.rotation, dtype=src.dtype, device=src.device)
    t = torch.as_tensor(init.translation, dtype=src.dtype, device=src.device)
    gate = max_corr_dist * max_corr_dist
    with _ieee_matmul():
        for _ in range(iterations):
            moved = src @ quat_to_matrix(q).T + t
            nn, nn_d2 = _nearest(moved, dst, dst_sq, dst_valid)
            w = (src_on & (nn_d2 < gate)).to(src.dtype)
            n_pairs = w.sum()
            wsum = n_pairs.clamp_min(3.0)
            tgt = dst[nn]
            mu_s = (moved * w[:, None]).sum(0) / wsum
            mu_t = (tgt * w[:, None]).sum(0) / wsum
            cov = ((moved - mu_s) * w[:, None]).T @ (tgt - mu_t) / wsum
            u, _, vt = torch.linalg.svd(cov)
            d = torch.sign(_det3(vt.T @ u.T))
            corr = torch.stack([torch.ones_like(d), torch.ones_like(d), d])
            r_delta = torch.where(n_pairs > 0, (vt.T * corr) @ u.T, eye)
            t_delta = mu_t - r_delta @ mu_s
            q = matrix_to_quat(r_delta @ quat_to_matrix(q))
            t = r_delta @ t + t_delta
            # nn_d2 can be epsilon-negative from the cancellation
            rmse = torch.sqrt((nn_d2 * w).sum().clamp_min(0.0) / wsum)
    return ICPResult(Rigid3(q, t), rmse, n_pairs.to(torch.int32))


@functools.lru_cache(maxsize=8)
def _default_perm(n: int, device: torch.device) -> Tensor:
    """The fixed permutation of n pixels behind the virtual clouds: a
    ``torch.randperm`` from a CPU generator seeded with 0, the same on every
    device."""
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(0))
    return perm.to(device)


def select_pixels(flag: Tensor, origin_xy: Tensor, resolution, budget: int,
                  perm: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """The first ``budget`` flagged pixels of an (S, S) 0/1 map, in the order
    of ``perm`` (default ``_default_perm``), as metric pixel centres
    ((budget, 2) points, (budget,) 0/1 validity). JAX takes them with
    ``lax.top_k`` on the permuted flag, the earliest position winning a
    tie; a stable descending sort keeps that order."""
    s = flag.shape[-1]
    flat = flag.reshape(-1).to(torch.float32)
    if perm is None:
        perm = _default_perm(s * s, flat.device)
    perm = torch.as_tensor(perm, dtype=torch.long, device=flat.device)
    vals, pidx = torch.sort(flat[perm], descending=True, stable=True)
    vals, idx = vals[:budget], perm[pidx[:budget]]
    row = torch.div(idx, s, rounding_mode="floor").to(torch.float32)
    col = (idx % s).to(torch.float32)
    origin_xy = torch.as_tensor(origin_xy, dtype=torch.float32,
                                device=flat.device)
    pts = torch.stack([origin_xy[0] + col * resolution,
                       origin_xy[1] + row * resolution], dim=-1)
    return pts, vals


def bev_to_virtual_points(image: Tensor, origin_xy: Tensor, resolution,
                          budget: int, perm: Optional[Tensor] = None
                          ) -> Tuple[Tensor, Tensor]:
    """Occupied BEV pixels (< 0.5) → a padded metric 2-D cloud: ((budget, 2)
    points, (budget,) validity). Over budget, the fixed permutation makes
    the cloud a uniform spatial subsample; at or under budget every
    occupied pixel is in it, whatever the permutation."""
    return select_pixels(image < 0.5, origin_xy, resolution, budget, perm)


class ICP2DResult(NamedTuple):
    xy_yaw: Tensor       # (3,) refined (dx, dy, yaw): p_dst = R(yaw)p_src + t
    rmse: Tensor         # () inlier RMSE at the last iteration
    num_inliers: Tensor  # () int32 correspondences kept at the last step


def _rot2(th: Tensor) -> Tensor:
    c, s = torch.cos(th), torch.sin(th)
    return torch.stack([torch.stack([c, -s]), torch.stack([s, c])])


def icp_planar(
    src: Tensor, src_mask: Tensor,     # (N, 2), (N,)
    dst: Tensor, dst_mask: Tensor,     # (M, 2), (M,)
    init_xy_yaw: Tensor,               # (3,)
    iterations: int = 10,
    max_corr_dist: float = 1.0,
    trim_fraction: float = 0.7,
) -> ICP2DResult:
    """Trimmed planar point-to-point ICP with the closed-form 2-D Kabsch
    update (θ = atan2(Σxy − Σyx, Σxx + Σyy)). Each step keeps the closest
    ``trim_fraction`` of the in-gate pairs (at least 3): BEV virtual clouds
    overlap only partly, and the unmatched points would drag the fit."""
    dst_sq = (dst * dst).sum(-1)
    dst_valid = dst_mask > 0
    src_on = src_mask > 0
    init_xy_yaw = torch.as_tensor(init_xy_yaw, dtype=src.dtype,
                                  device=src.device)
    th, t = init_xy_yaw[2], init_xy_yaw[:2]
    gate = max_corr_dist * max_corr_dist
    n = src.shape[0]
    with _ieee_matmul():
        for _ in range(iterations):
            moved = src @ _rot2(th).T + t
            nn, nn_d2 = _nearest(moved, dst, dst_sq, dst_valid)
            in_gate = src_on & (nn_d2 < gate)
            order = torch.sort(torch.where(in_gate, nn_d2, math.inf)).values
            n_gate = in_gate.sum()
            keep_n = (n_gate.to(torch.float32) * trim_fraction).to(
                torch.int32).clamp_min(3)
            # a gather, not order[tensor]: a 0-dim index is read on the host
            cutoff = order.gather(0, (keep_n - 1).clamp(0, n - 1).long()
                                  .reshape(1))[0]
            w = (in_gate & (nn_d2 <= cutoff)).to(src.dtype)
            wsum = w.sum().clamp_min(3.0)
            tgt = dst[nn]
            mu_s = (moved * w[:, None]).sum(0) / wsum
            mu_t = (tgt * w[:, None]).sum(0) / wsum
            a = (moved - mu_s) * w[:, None]
            b = tgt - mu_t
            sxx = (a[:, 0] * b[:, 0]).sum()
            syy = (a[:, 1] * b[:, 1]).sum()
            sxy = (a[:, 0] * b[:, 1]).sum()
            syx = (a[:, 1] * b[:, 0]).sum()
            dth = torch.atan2(sxy - syx, sxx + syy)
            r_delta = _rot2(dth)
            t = r_delta @ t + (mu_t - r_delta @ mu_s)
            th = th + dth
            rmse = torch.sqrt((nn_d2 * w).sum().clamp_min(0.0) / wsum)
    th = torch.atan2(torch.sin(th), torch.cos(th))
    return ICP2DResult(torch.stack([t[0], t[1], th]), rmse,
                       w.sum().to(torch.int32))


def refine_match_icp(
    q_image: Tensor, q_origin: Tensor,
    db_image: Tensor, db_origin: Tensor,
    xy_yaw: Tensor, resolution,
    budget: int = 4096, iterations: int = 10, max_corr_dist: float = 1.0,
    perm: Optional[Tensor] = None,
) -> ICP2DResult:
    """ICP-refine a BEV match: virtual clouds of both images (the same
    permutation for each), planar ICP seeded with the matcher's
    (dx, dy, yaw)."""
    q_pts, q_valid = bev_to_virtual_points(q_image, q_origin, resolution,
                                           budget, perm)
    d_pts, d_valid = bev_to_virtual_points(db_image, db_origin, resolution,
                                           budget, perm)
    return icp_planar(q_pts, q_valid, d_pts, d_valid, xy_yaw,
                      iterations=iterations, max_corr_dist=max_corr_dist)


# The inverses below are adjugates, as in the JAX package: the same
# elementwise arithmetic as the reference (torch.linalg.inv's LU rounds
# otherwise), and no host read (torch.linalg.inv checks its pivots on the
# host).
def _inv2x2(m: Tensor) -> Tensor:
    """Batched 2×2 inverse by the adjugate."""
    a, b = m[..., 0, 0], m[..., 0, 1]
    c, d = m[..., 1, 0], m[..., 1, 1]
    inv_det = 1.0 / (a * d - b * c)
    return torch.stack([torch.stack([d, -b], -1),
                        torch.stack([-c, a], -1)], -2) * inv_det[..., None,
                                                                  None]


def _inv3x3(m: Tensor) -> Tensor:
    """Batched 3×3 inverse by the adjugate."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = f * g - d * i
    co_c = d * h - e * g
    inv_det = 1.0 / (a * co_a + b * co_b + c * co_c)
    adj = torch.stack([
        torch.stack([co_a, c * h - b * i, b * f - c * e], -1),
        torch.stack([co_b, a * i - c * g, c * d - a * f], -1),
        torch.stack([co_c, b * g - a * h, a * e - b * d], -1),
    ], -2)
    return adj * inv_det[..., None, None]


class NDTGrid2D(NamedTuple):
    """Per-cell 2-D Gaussian statistics (the NDT map)."""

    mean: Tensor      # (H, W, 2)
    inv_cov: Tensor   # (H, W, 2, 2)
    valid: Tensor     # (H, W) bool: ≥ 3 points
    origin_xy: Tensor
    cell_size: float


def build_ndt_grid(points_xy: Tensor, mask: Tensor, size: int,
                   cell_size: float, origin_xy) -> NDTGrid2D:
    """Scatter 2-D points into a size × size grid of Gaussians: counts,
    means, then covariances about the means (two ``index_add_`` passes; row
    size·size collects the points outside the grid)."""
    dev = points_xy.device
    origin_xy = torch.as_tensor(origin_xy, dtype=torch.float32, device=dev)
    ij = torch.floor((points_xy - origin_xy) / cell_size).to(torch.int32)
    inb = (mask > 0) & (ij >= 0).all(-1) & (ij < size).all(-1)
    flat = torch.where(inb, ij[:, 1] * size + ij[:, 0], size * size).long()
    n = size * size + 1
    w = inb.to(torch.float32)
    cnt = torch.zeros(n, device=dev).index_add_(0, flat, w)
    sx = torch.zeros((n, 2), device=dev).index_add_(
        0, flat, points_xy * w[:, None])
    denom = cnt.clamp_min(1.0)
    mean = sx / denom[:, None]
    centered = points_xy - mean[flat]
    outer = centered[:, :, None] * centered[:, None, :] * w[:, None, None]
    cov = torch.zeros((n, 2, 2), device=dev).index_add_(0, flat, outer)
    cov = cov / denom[:, None, None] + torch.eye(2, device=dev) * 1e-3
    inv = _inv2x2(cov)
    m = size * size
    return NDTGrid2D(mean[:m].reshape(size, size, 2),
                     inv[:m].reshape(size, size, 2, 2),
                     (cnt >= 3)[:m].reshape(size, size), origin_xy,
                     cell_size)


def _mahalanobis(d: Tensor, inv_cov: Tensor) -> Tensor:
    """dᵀ Σ⁻¹ d per row, elementwise (no batched product, so no TF32)."""
    return (d[:, :, None] * inv_cov * d[:, None, :]).sum((1, 2))


def ndt_score(grid: NDTGrid2D, points_xy: Tensor, mask: Tensor,
              pose: Tensor) -> Tensor:
    """Mean NDT likelihood of points under pose (x, y, θ)."""
    c, s = torch.cos(pose[2]), torch.sin(pose[2])
    x = c * points_xy[:, 0] - s * points_xy[:, 1] + pose[0]
    y = s * points_xy[:, 0] + c * points_xy[:, 1] + pose[1]
    p = torch.stack([x, y], 1)
    size = grid.valid.shape[0]
    ij = torch.floor((p - grid.origin_xy) / grid.cell_size).to(torch.int32)
    inb = (mask > 0) & (ij >= 0).all(-1) & (ij < size).all(-1)
    ij = ij.clamp(0, size - 1).long()
    mu = grid.mean[ij[:, 1], ij[:, 0]]
    ic = grid.inv_cov[ij[:, 1], ij[:, 0]]
    ok = inb & grid.valid[ij[:, 1], ij[:, 0]]
    score = torch.exp(-0.5 * _mahalanobis(p - mu, ic)) * ok
    return score.sum() / (mask > 0).sum().clamp_min(1)


class NDTGrid3D(NamedTuple):
    """Per-voxel 3-D Gaussian statistics (the NDT map)."""

    mean: Tensor      # (V, 3)
    inv_cov: Tensor   # (V, 3, 3)
    valid: Tensor     # (V,) bool: ≥ 5 points (PCL's default minimum)
    origin: Tensor    # (3,)
    cell_size: float
    dims: Tuple[int, int, int]  # (nx, ny, nz)


def _voxel_index(p: Tensor, origin: Tensor, cell_size: float, dims):
    """(N, 3) points → (flat x-major voxel index clamped into the grid,
    in-grid flag). The grid's extent stays a Python tuple: a tensor made
    from it would be a host-to-device copy on every call."""
    nx, ny, nz = dims
    i, j, k = torch.floor((p - origin) / cell_size).to(torch.int32).unbind(-1)
    inb = ((i >= 0) & (j >= 0) & (k >= 0) & (i < nx) & (j < ny)
           & (k < nz))
    flat = (i.clamp(0, nx - 1) * ny * nz + j.clamp(0, ny - 1) * nz
            + k.clamp(0, nz - 1))
    return flat.long(), inb


def build_ndt_grid_3d(points: Tensor, mask: Tensor, origin,
                      dims: Tuple[int, int, int],
                      cell_size: float) -> NDTGrid3D:
    """One fused scatter, a 13-wide ``index_add_`` of [1, x, y, z, x xᵀ],
    builds every voxel's count, mean and covariance (E[x xᵀ] − μ μᵀ);
    row V collects the points outside the grid. Counts are sums of 1.0,
    exact in any order; the means and covariances take the order the
    atomics run in on the card."""
    nx, ny, nz = dims
    v = nx * ny * nz
    dev = points.device
    origin = torch.as_tensor(origin, dtype=torch.float32, device=dev)
    flat, inb = _voxel_index(points, origin, cell_size, dims)
    inb = inb & (mask > 0)
    flat = torch.where(inb, flat, v)
    w = inb.to(torch.float32)
    outer = (points[:, :, None] * points[:, None, :]).reshape(-1, 9)
    payload = torch.cat([w[:, None], points * w[:, None],
                         outer * w[:, None]], dim=-1)
    acc = torch.zeros((v + 1, 13), device=dev).index_add_(0, flat, payload)
    cnt = acc[:, 0]
    denom = cnt.clamp_min(1.0)
    mean = acc[:, 1:4] / denom[:, None]
    e_xx = acc[:, 4:13].reshape(-1, 3, 3) / denom[:, None, None]
    cov = (e_xx - mean[:, :, None] * mean[:, None, :]
           + torch.eye(3, device=dev) * 1e-3)
    return NDTGrid3D(mean[:v], _inv3x3(cov)[:v], (cnt >= 5)[:v], origin,
                     cell_size, tuple(dims))


def _pose6_apply(pose6: Tensor, points: Tensor) -> Tensor:
    """(x, y, z, roll, pitch, yaw) applied to (N, 3) points."""
    r = quat_to_matrix(quat_from_rpy(pose6[3], pose6[4], pose6[5]))
    return (points[:, None, :] * r[None]).sum(-1) + pose6[:3]


def ndt_score_3d(grid: NDTGrid3D, points: Tensor, mask: Tensor,
                 pose6: Tensor) -> Tensor:
    """Mean NDT likelihood of points under a 6-DoF pose: piecewise-smooth in
    pose6 (the voxel lookup is piecewise constant), so autograd gives the
    registration gradient."""
    p = _pose6_apply(pose6, points)
    flat, inb = _voxel_index(p, grid.origin, grid.cell_size, grid.dims)
    ok = (mask > 0) & inb & grid.valid[flat]
    score = torch.exp(-0.5 * _mahalanobis(p - grid.mean[flat],
                                          grid.inv_cov[flat])) * ok
    return score.sum() / (mask > 0).sum().clamp_min(1)


def ndt_refine_3d(
    grid: NDTGrid3D, points: Tensor, mask: Tensor, init6: Tensor,
    iterations: int = 35, lr_t: float = 0.15, lr_r: float = 0.05,
) -> Tuple[Tensor, Tensor]:
    """NDT registration by normalised gradient ascent on the likelihood,
    the step decaying by 0.9 an iteration (early steps move whole cells,
    late ones converge below a centimetre). The gradient is
    ``torch.autograd.grad`` of ``ndt_score_3d``; the best-scoring iterate
    is kept with ``torch.where``, so no iteration reads the host. Returns
    (pose6, score)."""
    dev = points.device
    step = torch.tensor([lr_t] * 3 + [lr_r] * 3, device=dev)
    decays = 0.9 ** torch.arange(iterations, dtype=torch.float32, device=dev)

    def value_and_grad(pose):
        with torch.enable_grad():
            pose = pose.detach().requires_grad_(True)
            s = ndt_score_3d(grid, points, mask, pose)
            (g,) = torch.autograd.grad(s, pose)
        return s.detach(), g

    pose = torch.as_tensor(init6, dtype=torch.float32, device=dev)
    best_pose = pose
    with torch.no_grad():
        best_score = ndt_score_3d(grid, points, mask, pose)
    for i in range(iterations):
        s, g = value_and_grad(pose)
        better = s > best_score
        best_pose = torch.where(better, pose, best_pose)
        best_score = torch.where(better, s, best_score)
        pose = pose + decays[i] * step * g / (torch.linalg.vector_norm(g)
                                              + 1e-9)
    with torch.no_grad():
        final = ndt_score_3d(grid, points, mask, pose)
    better = final > best_score
    return (torch.where(better, pose, best_pose),
            torch.where(better, final, best_score))


def ergodic_rp_sweep_match(
    points: Tensor, mask: Tensor,
    db_image: Tensor, db_origin: Tensor,
    bev_cfg, match_cfg,
    half_deg: float = 3.0, step_deg: float = 1.0,
) -> Tuple[MatchResult, Tensor]:
    """Try every roll/pitch perturbation in a ±half_deg grid (7 × 7 = 49 at
    the defaults): one batched BEV projection of the scan under all of them
    (``batch_scan_to_bev(..., align_rotation=)``), each BEV registered onto
    the db image with ``match_bev``; the best score wins, the first of
    equal ones. Returns (that MatchResult, (roll, pitch) of the winner)."""
    dev = points.device
    rs = torch.deg2rad(torch.arange(-half_deg, half_deg + 1e-6, step_deg,
                                    dtype=torch.float32, device=dev))
    rr, pp = torch.meshgrid(rs, rs, indexing="ij")
    rolls, pitchs = rr.reshape(-1), pp.reshape(-1)
    quats = quat_from_rpy(rolls, pitchs, torch.zeros_like(rolls))
    k = len(quats)
    bevs = batch_scan_to_bev(points[None].expand(k, -1, -1),
                             mask[None].expand(k, -1), bev_cfg,
                             align_rotation=quats)
    db_image = torch.as_tensor(db_image, dtype=torch.float32, device=dev)
    db = BEVImage(db_image, db_origin, bev_cfg.resolution,
                  (db_image < 0.5).sum())
    res = [match_bev(BEVImage(bevs.image[i], bevs.origin_xy[i],
                              bev_cfg.resolution, bevs.num_occupied[i]),
                     db, match_cfg) for i in range(k)]
    results = MatchResult(*(torch.stack(x) for x in zip(*res)))
    best = results.score.argmax()
    pick = MatchResult(*(x[best] for x in results))
    return pick, torch.stack([rolls[best], pitchs[best]])
