"""Ground-plane estimation → gravity alignment, on the device.

Port of ``gloc3d_tpu/ops/ground.py``: candidates within the candidate radius
→ a random fixed-size subsample → k-NN PCA normals (the op
``gloc3d::knn_normals``: one hand-written kernel on the card, the (M, M)
distance matrix on the CPU) → a 10° pitch-angle histogram keeping
near-vertical bins → H simultaneous RANSAC triplet hypotheses scored by
one inlier count → a least-squares refit on the best hypothesis's inliers
→ the rotation taking the plane normal to +Z with its yaw removed, lifted
by the plane distance.
``estimate_ground_batch`` runs it over a batch of scans in one call, as
``jax.vmap(estimate_ground)`` does in the JAX package; ``estimate_ground``
(one scan) is its B = 1 case.

Differences from the JAX function, each kept to its semantics:

- The random draws cannot be replayed from a JAX key, so they are
  injectable: ``priority`` (B, N) uniforms in [0, 1) rank the subsample
  and ``sample_triplets(ground_ok (B, M), H)`` returns the (B, 3, H)
  hypothesis rows. By default both come from ``generator``, scan by scan
  in the order of one-scan calls (``batch_ground_draws``), and the
  triplets are drawn uniformly over each scan's ground candidates by
  inverse CDF of (3, H) uniforms, which needs no host sync and gives the
  same rows on every device.
- ``approx_min_k`` (a TPU partial selection) becomes an exact stable sort
  for the subsample and an exact k-NN for the neighbours, the earliest
  index first at equal distances (``kernels/knn_normals.py``).
- Everything after the subsample runs in float64 and the outputs are
  rounded to the input dtype. The kNN distances ``|a|² - 2a·b + |b|²``
  cancel badly in fp32 (0.2 % of a 0.1 m neighbour distance at 20 m), so
  fp32 neighbour sets, and through them the plane, differ between two
  devices' matmuls; in float64 the card and the CPU give the same transform
  and hence the same aligned cloud and BEV image. The RANSAC inlier test
  rounds the float64 distance to fp32 and compares it with the fp32
  threshold, as the JAX function compares.
- The refit's smallest eigenvector comes in closed form
  (``_least_eigvec_sym3``) where JAX calls ``eigh``: the card's eigh reads
  its convergence flags back on the host, which a captured CUDA graph
  cannot, and one function on every device keeps the card and the CPU on
  the same transform.
- A hypothesis that draws p1 and p2 at one point away from p0 counts no
  inliers (``_plane_from_triplets``): in JAX's fp32 its normal is a
  rounding residue with few inliers, in float64 it was 0, a plane through
  every point, which won the count on one test scan and moved the refit
  plane by 6.4 mm.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from gloc3d_tpu_torch.core.device import device_constant
from gloc3d_tpu_torch.core.transforms import (
    Rigid3, quat_from_two_vectors, remove_yaw,
)
from gloc3d_tpu_torch.kernels.knn_normals import knn_normals

Tensor = torch.Tensor
TripletSampler = Callable[[Tensor, int], Tensor]


class GroundEstimate(NamedTuple):
    """One scan's estimate; ``estimate_ground_batch`` gives each field a
    leading batch axis."""

    transform: Rigid3       # T_lidar→ground (apply to points to gravity-align)
    plane: Tensor           # (4,) [a, b, c, d]: ax+by+cz+d=0, ‖(a,b,c)‖=1, c>0
    valid: Tensor           # () bool: a near-vertical normal bin was found
    inlier_fraction: Tensor  # () RANSAC inliers / ground candidates


def _det3(m: Tensor) -> Tensor:
    """Determinants of (…, 3, 3) by cofactors (elementwise, no LU)."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2]
                            - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2]
                              - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1]
                              - m[..., 1, 1] * m[..., 2, 0]))


def _least_eigvec_sym3(a: Tensor) -> Tensor:
    """Unit eigenvector of the smallest eigenvalue of batched symmetric
    (…, 3, 3) matrices, with no host read: ``torch.linalg.eigh`` reads its
    convergence flags back on the card, which a captured program cannot.
    The smallest eigenvalue λ in closed form (trigonometric; it stays
    accurate when the two larger ones coincide, as a round scan's ground
    has them), then the longest cross product of two rows of A − λI, which
    depends on λ alone. With no such product (λ of multiplicity 2 or 3, a
    zero matrix) the result is (1, 0, 0), eigh's first column for a zero
    matrix. The sign is arbitrary, as eigh's."""
    diag = a.diagonal(dim1=-2, dim2=-1)
    q = diag.sum(-1) / 3.0
    dq = diag - q[..., None]
    p2 = (dq * dq).sum(-1) + 2.0 * (a[..., 0, 1] ** 2 + a[..., 0, 2] ** 2
                                    + a[..., 1, 2] ** 2)
    p = torch.sqrt(p2 / 6.0)
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    shifted = a - q[..., None, None] * eye
    r = torch.clamp(_det3(shifted) / (2.0 * p.clamp_min(1e-300) ** 3),
                    -1.0, 1.0)
    lam = q + 2.0 * p * torch.cos(torch.acos(r) / 3.0 + 2.0 * math.pi / 3.0)
    m = a - lam[..., None, None] * eye
    rows = m.unbind(-2)
    c = torch.stack([torch.linalg.cross(rows[i], rows[j], dim=-1)
                     for i, j in ((0, 1), (0, 2), (1, 2))], -2)
    norms = torch.linalg.vector_norm(c, dim=-1)                # (…, 3)
    best = torch.argmax(norms, dim=-1, keepdim=True)
    v = torch.gather(c, -2, best[..., None].expand(c.shape[:-2] + (1, 3)))
    n = norms.gather(-1, best)
    ex = torch.zeros_like(v)
    ex[..., 0] = 1.0
    return torch.where(n[..., None] > 0, v / n.clamp_min(1e-300)[..., None],
                       ex)[..., 0, :]


def _plane_from_triplets(p0: Tensor, p1: Tensor, p2: Tensor
                         ) -> tuple[Tensor, Tensor]:
    """(..., H, 3)×3 → (..., H, 4) unit-normal plane coefficients, and
    (..., H) whether the hypothesis may count inliers.

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


def triplets_from(uniforms: Tensor) -> TripletSampler:
    """The default triplet sampler on pre-drawn (B, 3, H) ``uniforms``:
    (B, 3, H) rows drawn uniformly over each scan's ``ground_ok`` (B, M),
    by inverse CDF. A scan with no ground candidate (its estimate is then
    invalid and discarded) draws over all its rows instead of failing."""

    def sample(ground_ok: Tensor, h: int) -> Tensor:
        b, m = ground_ok.shape
        w = ground_ok | ~ground_ok.any(-1, keepdim=True)
        cdf = torch.cumsum(w.long(), -1)                       # (B, M)
        target = torch.floor(uniforms.to(cdf.device).double()
                             * cdf[:, -1:, None]).long()       # (B, 3, H)
        idx = torch.searchsorted(cdf, target.reshape(b, -1), right=True)
        return torch.clamp_max(idx, m - 1).reshape(b, 3, h)

    return sample


def batch_ground_draws(b: int, n: int, cfg,
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[Tensor, Tensor]:
    """The draws that b one-scan ``estimate_ground`` calls on n-row scans
    take from ``generator`` by default, stacked: (b, n) priorities and
    (b, 3, ``cfg.ransac_iters``) triplet uniforms, drawn scan by scan, each
    scan's priority before its uniforms. ``estimate_ground_batch`` takes
    them by default; drawn ahead and passed back through ``priority`` and
    ``triplets_from(uniforms)``, they give each scan of a batch, or of any
    part of it, the numbers of the sequential calls, and the generator ends
    where those calls leave it."""
    dev = _generator_device(generator)
    draws = [(torch.rand(n, generator=generator, device=dev),
              torch.rand((3, cfg.ransac_iters), generator=generator,
                         device=dev)) for _ in range(b)]
    return (torch.stack([d[0] for d in draws]),
            torch.stack([d[1] for d in draws]))


def estimate_ground_batch(points: Tensor, mask: Tensor, cfg,
                          generator: Optional[torch.Generator] = None, *,
                          priority: Optional[Tensor] = None,
                          sample_triplets: Optional[TripletSampler] = None
                          ) -> GroundEstimate:
    """Estimate the ground plane of each scan of a batch and its aligning
    transform, in one call (the JAX package's ``jax.vmap(estimate_ground)``).

    Args:
      points: (B, N, 3) padded scans.
      mask: (B, N) validity.
      cfg: GroundConfig.
      generator: source of the default draws (``batch_ground_draws``; any
        device, the draws are moved to ``points.device``), taken when
        ``priority`` or ``sample_triplets`` is not given.
      priority: optional (B, N) uniforms in [0, 1) that rank the subsample.
      sample_triplets: optional ``(ground_ok (B, M) bool, H) → (B, 3, H)``
        rows.

    Returns a GroundEstimate whose fields have a leading B axis.
    """
    dev, dt = points.device, points.dtype
    b, n = points.shape[:2]
    if priority is None or sample_triplets is None:
        prio, uniforms = batch_ground_draws(b, n, cfg, generator)
        priority = prio if priority is None else priority
        sample_triplets = sample_triplets or triplets_from(uniforms)
    p64 = points.double()
    cand_ok = (mask > 0) & (torch.sum(p64 * p64, -1)
                            < cfg.candidate_radius ** 2)
    rows = torch.arange(b, device=dev)[:, None]

    # random fixed-size subsample of candidates (invalid rows sort last)
    prio = torch.where(cand_ok, priority.to(dev), 2.0)
    take = torch.argsort(prio, dim=-1, stable=True)[:, :cfg.num_candidates]
    pts = p64[rows, take]                              # (B, M, 3)
    ok = cand_ok[rows, take]                           # (B, M)
    m = pts.shape[1]

    # --- k-NN PCA normals over the subsample (op gloc3d::knn_normals) ---
    normal = knn_normals(pts, ok, cfg.knn)             # (B, M, 3)

    # --- pitch-angle histogram, 10° bins, one scatter over the batch ---
    nb = cfg.num_bins
    nxy = torch.sqrt(normal[..., 0] ** 2 + normal[..., 1] ** 2)
    theta = (torch.atan2(normal[..., 2], nxy) + math.pi / 2) * (180.0
                                                                / math.pi)
    bins = torch.clamp(torch.floor_divide(theta, 10.0).long(), 0, nb - 1)
    hist = torch.zeros(b * nb, dtype=torch.long, device=dev).scatter_add_(
        0, (bins + rows * nb).reshape(-1), ok.long().reshape(-1)
    ).reshape(b, nb)
    bin_ids = torch.arange(nb, device=dev)
    near_vertical = (bin_ids <= cfg.vertical_lo) | (bin_ids >= cfg.vertical_hi)
    masked_hist = torch.where(near_vertical, hist, -1)
    ground_bin = torch.argmax(masked_hist, dim=-1)     # (B,)
    valid = masked_hist.gather(-1, ground_bin[:, None])[:, 0] > 0
    ground_ok = ok & (bins == ground_bin[:, None])     # ground candidates

    # --- vectorized RANSAC plane (H simultaneous triplet hypotheses) ---
    tri = sample_triplets(ground_ok, cfg.ransac_iters).to(dev)  # (B, 3, H)
    planes, counts = _plane_from_triplets(pts[rows, tri[:, 0]],
                                          pts[rows, tri[:, 1]],
                                          pts[rows, tri[:, 2]])
    dist = torch.abs(torch.bmm(pts, planes[..., :3].transpose(1, 2))
                     + planes[:, None, :, 3])          # (B, M, H)
    # the inlier test of the JAX function, in its fp32: the float64
    # distance rounded to fp32 against the fp32 threshold
    inlier = dist.float() < device_constant(cfg.inlier_threshold,
                                            torch.float32, dev)
    inl = torch.sum(inlier & ground_ok[:, :, None] & counts[:, None, :], 1)
    best = torch.argmax(inl, dim=-1)                   # (B,)
    n_ground = torch.clamp_min(torch.sum(ground_ok, -1), 1)
    inlier_frac = inl.gather(-1, best[:, None])[:, 0].double() / n_ground

    # --- least-squares refit on the inliers ---
    w = (inlier.gather(-1, best[:, None, None].expand(b, m, 1))[..., 0]
         & ground_ok).double()
    wsum = torch.clamp_min(torch.sum(w, -1), 3.0)      # (B,)
    mu_i = torch.sum(pts * w[..., None], 1) / wsum[:, None]
    ci = (pts - mu_i[:, None]) * w[..., None]
    n_ref = _least_eigvec_sym3(torch.bmm(ci.transpose(1, 2), ci)
                               / wsum[:, None, None])
    n_ref = n_ref / torch.clamp_min(
        torch.linalg.vector_norm(n_ref, dim=-1, keepdim=True), 1e-9)
    plane = torch.cat([n_ref, -torch.sum(n_ref * mu_i, -1, keepdim=True)],
                      -1)

    # --- alignment transform ---
    up = plane[:, 2:3] < 0
    nrm = torch.where(up, -plane[:, :3], plane[:, :3])  # upward normal
    d_abs = torch.abs(plane[:, 3:])
    plane = torch.cat([nrm, torch.where(up, -plane[:, 3:], plane[:, 3:])],
                      -1)
    ez = device_constant((0.0, 0.0, 1.0), torch.float64, dev)
    q = remove_yaw(quat_from_two_vectors(nrm, ez.expand(b, 3)))
    ident = device_constant((1.0, 0.0, 0.0, 0.0), torch.float64, dev)
    transform = Rigid3(
        torch.where(valid[:, None], q, ident).to(dt),
        torch.where(valid[:, None], ez * d_abs, torch.zeros_like(ez)).to(dt))
    return GroundEstimate(transform, plane.to(dt), valid,
                          inlier_frac.to(dt))


def estimate_ground(points: Tensor, mask: Tensor, cfg,
                    generator: Optional[torch.Generator] = None, *,
                    priority: Optional[Tensor] = None,
                    sample_triplets: Optional[TripletSampler] = None
                    ) -> GroundEstimate:
    """Estimate the ground plane of one scan and the aligning transform:
    the B = 1 case of ``estimate_ground_batch``.

    Args:
      points: (N, 3) padded scan.
      mask: (N,) validity.
      cfg: GroundConfig.
      generator: source of the default draws (any device; the draws are
        moved to ``points.device``).
      priority: optional (N,) uniforms in [0, 1) that rank the subsample.
      sample_triplets: optional ``(ground_ok (M,) bool, H) → (3, H)`` rows.
    """
    batched = None if sample_triplets is None else (
        lambda ground_ok, h: sample_triplets(ground_ok[0], h)[None])
    est = estimate_ground_batch(
        points[None], mask[None], cfg, generator,
        priority=None if priority is None else priority[None],
        sample_triplets=batched)
    return GroundEstimate(
        Rigid3(est.transform.rotation[0], est.transform.translation[0]),
        est.plane[0], est.valid[0], est.inlier_fraction[0])
