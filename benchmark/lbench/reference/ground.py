"""Ground-plane estimate and gravity alignment, plain PyTorch.

A frozen copy of the located query's ground RANSAC (candidates within the
candidate radius, a random fixed-size subsample ranked by drawn
priorities, k-NN PCA normals, a 10-degree pitch histogram of near-vertical
bins, H triplet hypotheses scored by one inlier count, a least-squares
refit, the rotation taking the normal to +Z with its yaw removed, lifted by
the plane distance), written from its description and kept here so that
later changes to the program cannot move the yardstick. ``dtype`` is the
arithmetic after the subsample: float64 as the configuration states, or
float32 for the control. The random draws come from a CPU
``torch.Generator``, scan by scan: (N,) priorities, then (3, H) triplet
uniforms.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


# ------------------------------------------------------------ quaternions
def quat_mul(a: Tensor, b: Tensor) -> Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def _cross(a: Tensor, b: Tensor) -> Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: Tensor, v: Tensor) -> Tensor:
    """v' = v + 2·w·(u×v) + 2·(u×(u×v)) for wxyz quaternions."""
    w, u = q[..., :1], q[..., 1:]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_from_rpy(roll: Tensor, pitch: Tensor, yaw: Tensor) -> Tensor:
    hr, hp, hy = roll * 0.5, pitch * 0.5, yaw * 0.5
    cr, sr = torch.cos(hr), torch.sin(hr)
    cp, sp = torch.cos(hp), torch.sin(hp)
    cy, sy = torch.cos(hy), torch.sin(hy)
    return torch.stack([
        cy * cp * cr + sy * sp * sr,
        cy * cp * sr - sy * sp * cr,
        cy * sp * cr + sy * cp * sr,
        sy * cp * cr - cy * sp * sr,
    ], dim=-1)


def remove_yaw(q: Tensor) -> Tensor:
    """Rz(-yaw(q))·q, yaw the heading of the rotated +X axis."""
    ex = torch.zeros(q.shape[:-1] + (3,), dtype=q.dtype, device=q.device)
    ex[..., 0] = 1.0
    d = quat_rotate(q, ex)
    yaw = torch.atan2(d[..., 1], d[..., 0])
    z = torch.zeros_like(yaw)
    return quat_mul(quat_from_rpy(z, z, -yaw), q)


def quat_from_two_vectors(a: Tensor, b: Tensor) -> Tensor:
    a = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    b = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)
    c = _cross(a, b)
    w = 1.0 + torch.sum(a * b, dim=-1, keepdim=True)
    q = torch.cat([w, c], dim=-1)
    ex = torch.zeros_like(a)
    ex[..., 0] = 1.0
    ez = torch.zeros_like(a)
    ez[..., 2] = 1.0
    alt1, alt2 = _cross(a, ex), _cross(a, ez)
    alt = torch.where(torch.linalg.vector_norm(alt1, dim=-1, keepdim=True)
                      > 0.1, alt1, alt2)
    q = torch.where(w < 1e-6, torch.cat([torch.zeros_like(w), alt], -1), q)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


# ------------------------------------------------------------ eigenvectors
def _smallest_eigvec_3x3(a: Tensor) -> Tensor:
    """Smallest eigenvector of symmetric (..., 3, 3): Cardano eigenvalues,
    then the longest column of (A − λ1)(A − λ2); +Z when degenerate."""
    diag = a.diagonal(dim1=-2, dim2=-1)
    q = diag.sum(-1) / 3.0
    p1 = a[..., 0, 1] ** 2 + a[..., 0, 2] ** 2 + a[..., 1, 2] ** 2
    dq = diag - q[..., None]
    p2 = torch.sum(dq * dq, -1) + 2.0 * p1
    p = torch.sqrt(torch.clamp_min(p2 / 6.0, 1e-20))
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    b = (a - q[..., None, None] * eye) / p[..., None, None]
    r = torch.clamp(torch.linalg.det(b) / 2.0, -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    lam1 = q + 2.0 * p * torch.cos(phi)
    lam3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam2 = 3.0 * q - lam1 - lam3
    c = torch.matmul(a - lam1[..., None, None] * eye,
                     a - lam2[..., None, None] * eye)
    norms = torch.linalg.vector_norm(c, dim=-2)
    best = torch.argmax(norms, dim=-1)
    v = torch.gather(c, -1, best[..., None, None].expand(
        c.shape[:-1] + (1,)))[..., 0]
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    up = torch.zeros_like(v)
    up[..., 2] = 1.0
    degenerate = (p2 < 1e-16) | (n[..., 0] < 1e-12)
    return torch.where(degenerate[..., None], up,
                       v / torch.clamp_min(n, 1e-20))


def _det3(m: Tensor) -> Tensor:
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2]
                            - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2]
                              - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1]
                              - m[..., 1, 1] * m[..., 2, 0]))


def _least_eigvec_sym3(a: Tensor) -> Tensor:
    """Unit eigenvector of the smallest eigenvalue (closed-form λ, then the
    longest cross product of two rows of A − λI); (1, 0, 0) when none."""
    diag = a.diagonal(dim1=-2, dim2=-1)
    q = diag.sum(-1) / 3.0
    dq = diag - q[..., None]
    p2 = (dq * dq).sum(-1) + 2.0 * (a[..., 0, 1] ** 2 + a[..., 0, 2] ** 2
                                    + a[..., 1, 2] ** 2)
    p = torch.sqrt(p2 / 6.0)
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    shifted = a - q[..., None, None] * eye
    tiny = 1e-300 if a.dtype == torch.float64 else 1e-30
    r = torch.clamp(_det3(shifted) / (2.0 * p.clamp_min(tiny) ** 3),
                    -1.0, 1.0)
    lam = q + 2.0 * p * torch.cos(torch.acos(r) / 3.0 + 2.0 * math.pi / 3.0)
    rows = (a - lam[..., None, None] * eye).unbind(-2)
    c = torch.stack([torch.linalg.cross(rows[i], rows[j], dim=-1)
                     for i, j in ((0, 1), (0, 2), (1, 2))], -2)
    norms = torch.linalg.vector_norm(c, dim=-1)
    best = torch.argmax(norms, dim=-1, keepdim=True)
    v = torch.gather(c, -2, best[..., None].expand(c.shape[:-2] + (1, 3)))
    n = norms.gather(-1, best)
    ex = torch.zeros_like(v)
    ex[..., 0] = 1.0
    return torch.where(n[..., None] > 0, v / n.clamp_min(tiny)[..., None],
                       ex)[..., 0, :]


# ------------------------------------------------------------ draws
def ground_draws(b: int, n: int, iters: int, generator: torch.Generator):
    """(b, n) priorities and (b, 3, iters) triplet uniforms, drawn scan by
    scan from a CPU generator, each scan's priorities first."""
    draws = [(torch.rand(n, generator=generator),
              torch.rand((3, iters), generator=generator)) for _ in range(b)]
    return (torch.stack([d[0] for d in draws]),
            torch.stack([d[1] for d in draws]))


def _triplets(uniforms: Tensor, ground_ok: Tensor, h: int) -> Tensor:
    """Rows drawn uniformly over each scan's ground candidates by inverse
    CDF of the uniforms (over all rows when a scan has none)."""
    b, m = ground_ok.shape
    w = ground_ok | ~ground_ok.any(-1, keepdim=True)
    cdf = torch.cumsum(w.long(), -1)
    target = torch.floor(uniforms.to(cdf.device).double()
                         * cdf[:, -1:, None]).long()
    idx = torch.searchsorted(cdf, target.reshape(b, -1), right=True)
    return torch.clamp_max(idx, m - 1).reshape(b, 3, h)


# ------------------------------------------------------------ estimator
def estimate_ground(points: Tensor, mask: Tensor, gcfg: dict,
                    priority: Tensor, uniforms: Tensor,
                    dtype: torch.dtype = torch.float64):
    """(B, N, 3) fp32 scans and (B, N) masks → (rotation (B, 4) wxyz,
    translation (B, 3)), both fp32: T_lidar→ground."""
    dev = points.device
    b = points.shape[0]
    p = points.to(dtype)
    cand_ok = (mask > 0) & (torch.sum(p * p, -1)
                            < gcfg["candidate_radius"] ** 2)
    rows = torch.arange(b, device=dev)[:, None]
    prio = torch.where(cand_ok, priority.to(dev), 2.0)
    take = torch.argsort(prio, dim=-1, stable=True)[:, :gcfg["num_candidates"]]
    pts = p[rows, take]
    ok = cand_ok[rows, take]
    m = pts.shape[1]
    knn = gcfg["knn"]

    sq = torch.sum(pts * pts, -1)
    d2 = (sq[:, :, None] - 2.0 * torch.bmm(pts, pts.transpose(1, 2))
          + sq[:, None, :])
    d2 = torch.where(ok[:, None, :], d2, math.inf)
    nn = torch.topk(d2, knn, dim=-1, largest=False).indices
    nbr = pts[rows[:, :, None], nn]
    c = nbr - nbr.mean(dim=2, keepdim=True)
    cov = torch.einsum("bmki,bmkj->bmij", c, c) / knn
    normal = _smallest_eigvec_3x3(cov)

    nb = gcfg["num_bins"]
    nxy = torch.sqrt(normal[..., 0] ** 2 + normal[..., 1] ** 2)
    theta = (torch.atan2(normal[..., 2], nxy) + math.pi / 2) * (180.0
                                                                / math.pi)
    bins = torch.clamp(torch.floor_divide(theta, 10.0).long(), 0, nb - 1)
    hist = torch.zeros(b * nb, dtype=torch.long, device=dev).scatter_add_(
        0, (bins + rows * nb).reshape(-1), ok.long().reshape(-1)
    ).reshape(b, nb)
    bin_ids = torch.arange(nb, device=dev)
    near_vertical = ((bin_ids <= gcfg["vertical_lo"])
                     | (bin_ids >= gcfg["vertical_hi"]))
    masked = torch.where(near_vertical, hist, -1)
    ground_bin = torch.argmax(masked, dim=-1)
    valid = masked.gather(-1, ground_bin[:, None])[:, 0] > 0
    ground_ok = ok & (bins == ground_bin[:, None])

    h = gcfg["ransac_iters"]
    tri = _triplets(uniforms, ground_ok, h).to(dev)
    p0, p1, p2 = (pts[rows, tri[:, i]] for i in range(3))
    n = torch.linalg.cross(p1 - p0, p2 - p0, dim=-1)
    n = n / torch.clamp_min(torch.linalg.vector_norm(n, dim=-1, keepdim=True),
                            1e-9)
    planes = torch.cat([n, -torch.sum(n * p0, -1, keepdim=True)], -1)
    counts = ~((p1 == p2).all(-1) & (p1 != p0).any(-1))
    dist = torch.abs(torch.bmm(pts, planes[..., :3].transpose(1, 2))
                     + planes[:, None, :, 3])
    thr = torch.tensor(gcfg["inlier_threshold"], dtype=torch.float32,
                       device=dev)
    inlier = dist.float() < thr
    inl = torch.sum(inlier & ground_ok[:, :, None] & counts[:, None, :], 1)
    best = torch.argmax(inl, dim=-1)

    w = (inlier.gather(-1, best[:, None, None].expand(b, m, 1))[..., 0]
         & ground_ok).to(dtype)
    wsum = torch.clamp_min(torch.sum(w, -1), 3.0)
    mu = torch.sum(pts * w[..., None], 1) / wsum[:, None]
    ci = (pts - mu[:, None]) * w[..., None]
    n_ref = _least_eigvec_sym3(torch.bmm(ci.transpose(1, 2), ci)
                               / wsum[:, None, None])
    n_ref = n_ref / torch.clamp_min(
        torch.linalg.vector_norm(n_ref, dim=-1, keepdim=True), 1e-9)
    d = -torch.sum(n_ref * mu, -1, keepdim=True)

    up = n_ref[:, 2:3] < 0
    nrm = torch.where(up, -n_ref, n_ref)
    ez = torch.tensor((0.0, 0.0, 1.0), dtype=dtype, device=dev)
    q = remove_yaw(quat_from_two_vectors(nrm, ez.expand(b, 3)))
    ident = torch.tensor((1.0, 0.0, 0.0, 0.0), dtype=dtype, device=dev)
    rot = torch.where(valid[:, None], q, ident).float()
    trans = torch.where(valid[:, None], ez * torch.abs(d),
                        torch.zeros_like(ez)).float()
    return rot, trans


def align(points: Tensor, rot: Tensor, trans: Tensor) -> Tensor:
    """(B, N, 4) scans rotated into their ground frames in float64 and
    rounded to fp32, the intensity column kept."""
    xyz = (quat_rotate(rot.double()[:, None], points[..., :3].double())
           + trans.double()[:, None]).float()
    return torch.cat([xyz, points[..., 3:]], dim=-1)
