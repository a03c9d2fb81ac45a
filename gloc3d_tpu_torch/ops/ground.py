"""Ground-plane estimation → gravity alignment, on the device.

Port of ``gloc3d_tpu/ops/ground.py``: candidates within the candidate radius
→ a random fixed-size subsample → k-NN PCA normals from one (M, M) distance
matrix → a 10° pitch-angle histogram keeping near-vertical bins → H
simultaneous RANSAC triplet hypotheses scored by one inlier count → a
least-squares refit on the best hypothesis's inliers → the rotation taking
the plane normal to +Z with its yaw removed, lifted by the plane distance.

Differences from the JAX function, each kept to its semantics:

- The random draws cannot be replayed from a JAX key, so they are
  injectable: ``priority`` (N,) uniforms in [0, 1) rank the subsample and
  ``sample_triplets(ground_ok, H)`` returns the (3, H) hypothesis rows.
  By default both come from ``generator``, and the triplets are drawn
  uniformly over the ground candidates by inverse CDF of (3, H) uniforms,
  which needs no host sync and gives the same rows on every device.
- ``approx_min_k`` (a TPU partial selection) becomes an exact stable sort
  for the subsample and ``torch.topk`` for the neighbours.
- Everything after the subsample runs in float64 and the outputs are
  rounded to the input dtype. The kNN distances ``|a|² - 2a·b + |b|²``
  cancel badly in fp32 (0.2 % of a 0.1 m neighbour distance at 20 m), so
  fp32 neighbour sets, and through them the plane, differ between two
  devices' matmuls; in float64 the card and the CPU give the same transform
  and hence the same aligned cloud and BEV image. The RANSAC inlier test
  rounds the float64 distance to fp32 and compares it with the fp32
  threshold, as the JAX function compares.
- A hypothesis that draws p1 and p2 at one point away from p0 counts no
  inliers (``_plane_from_triplets``): in JAX's fp32 its normal is a
  rounding residue with few inliers, in float64 it was 0, a plane through
  every point, which won the count on one test scan and moved the refit
  plane by 6.4 mm.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from gloc3d_tpu_torch.core.transforms import (
    Rigid3, quat_from_two_vectors, quat_identity, remove_yaw,
)

Tensor = torch.Tensor
TripletSampler = Callable[[Tensor, int], Tensor]


class GroundEstimate(NamedTuple):
    transform: Rigid3       # T_lidar→ground (apply to points to gravity-align)
    plane: Tensor           # (4,) [a, b, c, d]: ax+by+cz+d=0, ‖(a,b,c)‖=1, c>0
    valid: Tensor           # () bool: a near-vertical normal bin was found
    inlier_fraction: Tensor  # () RANSAC inliers / ground candidates


def _smallest_eigvec_3x3(a: Tensor) -> Tensor:
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


def _plane_from_triplets(p0: Tensor, p1: Tensor, p2: Tensor
                         ) -> tuple[Tensor, Tensor]:
    """(H, 3)×3 → (H, 4) unit-normal plane coefficients, and (H,) whether
    the hypothesis may count inliers.

    A triplet that repeats p0 has an edge of 0, so its cross product and
    plane are exactly 0 in any arithmetic, and every point lies on it, as
    in JAX. A triplet whose p1 and p2 coincide away from p0 has the cross
    product e × e: 0 in exact arithmetic, but JAX's fp32 computes it with
    fused multiply-adds and keeps their rounding residue, a random normal
    with few inliers, while float64 without them keeps 0, a plane through
    every point. Such a hypothesis counts no inliers here, on every
    device."""
    n = torch.linalg.cross(p1 - p0, p2 - p0, dim=-1)
    n = n / torch.clamp_min(
        torch.linalg.vector_norm(n, dim=-1, keepdim=True), 1e-9)
    d = -torch.sum(n * p0, dim=-1, keepdim=True)
    counts = ~((p1 == p2).all(-1) & (p1 != p0).any(-1))
    return torch.cat([n, d], dim=-1), counts


def _generator_device(generator: Optional[torch.Generator]) -> torch.device:
    return torch.device("cpu") if generator is None else generator.device


def _uniform_triplet_sampler(generator: Optional[torch.Generator] = None
                             ) -> TripletSampler:
    """(3, H) rows drawn uniformly over ``ground_ok``, by inverse CDF of
    uniforms from ``generator``. With no ground candidate (the estimate is
    then invalid and discarded) it draws over all rows instead of failing."""

    def sample(ground_ok: Tensor, h: int) -> Tensor:
        u = torch.rand((3, h), generator=generator,
                       device=_generator_device(generator))
        w = ground_ok | ~ground_ok.any()
        cdf = torch.cumsum(w.long(), 0)
        target = torch.floor(u.to(cdf.device).double() * cdf[-1]).long()
        idx = torch.searchsorted(cdf, target, right=True)
        return torch.clamp_max(idx, ground_ok.shape[0] - 1)

    return sample


def estimate_ground(points: Tensor, mask: Tensor, cfg,
                    generator: Optional[torch.Generator] = None, *,
                    priority: Optional[Tensor] = None,
                    sample_triplets: Optional[TripletSampler] = None
                    ) -> GroundEstimate:
    """Estimate the ground plane of one scan and the aligning transform.

    Args:
      points: (N, 3) padded scan.
      mask: (N,) validity.
      cfg: GroundConfig.
      generator: source of the default draws (any device; the draws are
        moved to ``points.device``).
      priority: optional (N,) uniforms in [0, 1) that rank the subsample.
      sample_triplets: optional ``(ground_ok (M,) bool, H) → (3, H)`` rows.
    """
    dev, dt = points.device, points.dtype
    n = points.shape[0]
    p64 = points.double()
    cand_ok = (mask > 0) & (torch.sum(p64 * p64, -1)
                            < cfg.candidate_radius ** 2)

    # random fixed-size subsample of candidates (invalid rows sort last)
    if priority is None:
        priority = torch.rand(n, generator=generator,
                              device=_generator_device(generator))
    prio = torch.where(cand_ok, priority.to(dev), 2.0)
    take = torch.argsort(prio, stable=True)[:cfg.num_candidates]
    pts = p64[take]                                    # (M, 3)
    ok = cand_ok[take]                                 # (M,)

    # --- k-NN PCA normals over the subsample ---
    sq = torch.sum(pts * pts, -1)
    d2 = sq[:, None] - 2.0 * pts @ pts.T + sq[None, :]
    d2 = torch.where(ok[None, :], d2, math.inf)        # exclude invalid cols
    nn = torch.topk(d2, cfg.knn, dim=1, largest=False).indices  # incl. self
    nbr = pts[nn]                                      # (M, K, 3)
    c = nbr - nbr.mean(dim=1, keepdim=True)
    cov = torch.einsum("mki,mkj->mij", c, c) / cfg.knn
    normal = _smallest_eigvec_3x3(cov)                 # (M, 3)

    # --- pitch-angle histogram, 10° bins ---
    nxy = torch.sqrt(normal[:, 0] ** 2 + normal[:, 1] ** 2)
    theta = (torch.atan2(normal[:, 2], nxy) + math.pi / 2) * (180.0 / math.pi)
    bins = torch.clamp(torch.floor_divide(theta, 10.0).long(), 0,
                       cfg.num_bins - 1)
    hist = torch.zeros(cfg.num_bins, dtype=torch.long, device=dev
                       ).scatter_add_(0, bins, ok.long())
    bin_ids = torch.arange(cfg.num_bins, device=dev)
    near_vertical = (bin_ids <= cfg.vertical_lo) | (bin_ids >= cfg.vertical_hi)
    masked_hist = torch.where(near_vertical, hist, -1)
    ground_bin = torch.argmax(masked_hist)
    valid = masked_hist[ground_bin] > 0
    ground_ok = ok & (bins == ground_bin)              # ground candidates

    # --- vectorized RANSAC plane (H simultaneous triplet hypotheses) ---
    if sample_triplets is None:
        sample_triplets = _uniform_triplet_sampler(generator)
    tri = sample_triplets(ground_ok, cfg.ransac_iters).to(dev)  # (3, H)
    planes, counts = _plane_from_triplets(pts[tri[0]], pts[tri[1]],
                                          pts[tri[2]])
    dist = torch.abs(pts @ planes[:, :3].T + planes[None, :, 3])  # (M, H)
    # the inlier test of the JAX function, in its fp32: the float64
    # distance rounded to fp32 against the fp32 threshold
    inlier = dist.float() < torch.tensor(cfg.inlier_threshold,
                                         dtype=torch.float32, device=dev)
    inl = torch.sum(inlier & ground_ok[:, None] & counts[None, :], 0)
    best = torch.argmax(inl)
    n_ground = torch.clamp_min(torch.sum(ground_ok), 1)
    inlier_frac = inl[best].double() / n_ground

    # --- least-squares refit on the inliers ---
    w = (inlier[:, best] & ground_ok).double()
    wsum = torch.clamp_min(torch.sum(w), 3.0)
    mu_i = torch.sum(pts * w[:, None], 0) / wsum
    ci = (pts - mu_i) * w[:, None]
    _, v_i = torch.linalg.eigh(ci.T @ ci / wsum)
    n_ref = v_i[:, 0]
    n_ref = n_ref / torch.clamp_min(torch.linalg.vector_norm(n_ref), 1e-9)
    plane = torch.cat([n_ref, -torch.sum(n_ref * mu_i)[None]])

    # --- alignment transform ---
    nrm = plane[:3]
    d_abs = torch.abs(plane[3])
    nrm = torch.where(nrm[2] < 0, -nrm, nrm)           # upward normal
    plane = torch.cat([nrm, torch.where(plane[2] < 0, -plane[3:],
                                        plane[3:])])
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64, device=dev)
    q = remove_yaw(quat_from_two_vectors(nrm, ez))
    transform = Rigid3(
        torch.where(valid, q, quat_identity(torch.float64, dev)).to(dt),
        torch.where(valid, ez * d_abs, torch.zeros_like(ez)).to(dt))
    return GroundEstimate(transform, plane.to(dt), valid,
                          inlier_frac.to(dt))
