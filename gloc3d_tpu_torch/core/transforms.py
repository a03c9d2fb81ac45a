"""SE(3) / SE(2) rigid transforms and quaternion algebra on tensors.

Port of ``gloc3d_tpu/core/transforms.py`` for the located query, plain and
ground-aligned, for the refiners and for the pose loss: quaternion algebra,
``matrix_to_quat``, the angle-axis maps, Euler extraction, the ground-alignment
helpers (``remove_yaw``, ``quat_from_two_vectors``), ``Rigid3`` / ``Rigid2``
and ``embed_3d``. Quaternions are (w, x, y, z) in the last axis; every
function broadcasts over leading axes and is branch-free (``torch.where``),
as the JAX functions are.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Quaternion algebra (w, x, y, z)
# ---------------------------------------------------------------------------

def quat_identity(dtype=torch.float32, device=None) -> Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_normalize(q: Tensor) -> Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_conj(q: Tensor) -> Tensor:
    """Conjugate == inverse for unit quaternions."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def quat_mul(a: Tensor, b: Tensor) -> Tensor:
    """Hamilton product a*b; composition: (a*b) rotates by b then a."""
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
    """Rotate vector(s) v (..., 3) by quaternion(s) q (..., 4):
    v' = v + 2·w·(u×v) + 2·(u×(u×v))."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_to_matrix(q: Tensor) -> Tensor:
    """Unit quaternion (..., 4) → rotation matrix (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: Tensor) -> Tensor:
    """Rotation matrix (..., 3, 3) → unit quaternion (..., 4), branch-free
    Shepperd: all four candidates are built and the one with the largest
    pivot is taken with ``take_along_dim``, so no value is read back to the
    host."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                      1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1)
    w0, x1, y2, z3 = (torch.sqrt(qw.clamp_min(1e-12)) * 0.5).unbind(-1)
    cands = torch.stack([
        torch.stack([w0, (m21 - m12) / (4 * w0), (m02 - m20) / (4 * w0),
                     (m10 - m01) / (4 * w0)], dim=-1),
        torch.stack([(m21 - m12) / (4 * x1), x1, (m01 + m10) / (4 * x1),
                     (m02 + m20) / (4 * x1)], dim=-1),
        torch.stack([(m02 - m20) / (4 * y2), (m01 + m10) / (4 * y2), y2,
                     (m12 + m21) / (4 * y2)], dim=-1),
        torch.stack([(m10 - m01) / (4 * z3), (m02 + m20) / (4 * z3),
                     (m12 + m21) / (4 * z3), z3], dim=-1),
    ], dim=-2)
    best = torch.stack([tr, m00, m11, m22], dim=-1).argmax(-1)
    q = torch.take_along_dim(cands, best[..., None, None], dim=-2)[..., 0, :]
    return quat_normalize(q)


def angle_axis_to_quat(angle_axis: Tensor) -> Tensor:
    """Angle-axis vector (angle·unit axis) → quaternion; linearised below a
    squared norm of 1e-8 (transform.h:AngleAxisVectorToRotationQuaternion),
    branch-free."""
    sq = (angle_axis * angle_axis).sum(-1, keepdim=True)
    norm = torch.sqrt(sq.clamp_min(1e-24))
    small = sq < 1e-8
    scale = torch.where(small, 0.5, torch.sin(norm / 2.0) / norm)
    w = torch.where(small, 1.0, torch.cos(norm / 2.0))
    return torch.cat([w, scale * angle_axis], dim=-1)


def quat_to_angle_axis(q: Tensor) -> Tensor:
    """Quaternion → angle-axis vector, on the positive-w branch
    (transform.h:RotationQuaternionToAngleAxisVector)."""
    q = quat_normalize(q)
    q = torch.where(q[..., :1] < 0.0, -q, q)
    vec_norm = torch.linalg.vector_norm(q[..., 1:], dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(vec_norm, q[..., :1])
    small = angle < 1e-7
    sin_half = torch.sin(angle / 2.0)
    scale = torch.where(small, 2.0,
                        angle / torch.where(small, 1.0, sin_half))
    return scale * q[..., 1:]


def quat_from_rpy(roll: Tensor, pitch: Tensor, yaw: Tensor) -> Tensor:
    """(roll, pitch, yaw) → quaternion, URDF convention Rz(y)·Ry(p)·Rx(r)."""
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


def rpy_from_quat(q: Tensor):
    """Extract (roll, pitch, yaw), ZYX convention (inverse of quat_from_rpy)."""
    m = quat_to_matrix(q)
    yaw = torch.atan2(m[..., 1, 0], m[..., 0, 0])
    pitch = torch.asin(torch.clamp(-m[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(m[..., 2, 1], m[..., 2, 2])
    return roll, pitch, yaw


def get_yaw(q: Tensor) -> Tensor:
    """Yaw of a rotation: heading of the rotated +X axis."""
    ex = torch.zeros(q.shape[:-1] + (3,), dtype=q.dtype, device=q.device)
    ex[..., 0] = 1.0
    d = quat_rotate(q, ex)
    return torch.atan2(d[..., 1], d[..., 0])


def remove_yaw(q: Tensor) -> Tensor:
    """Rz(-yaw(q)) · q: the same rotation with its ZYX yaw zeroed."""
    yaw = get_yaw(q)
    z = torch.zeros_like(yaw)
    return quat_mul(quat_from_rpy(z, z, -yaw), q)


def quat_from_two_vectors(a: Tensor, b: Tensor) -> Tensor:
    """Shortest-arc rotation taking direction a to b. Antiparallel inputs
    rotate 180° about an axis orthogonal to a (a×ex, or a×ez when a is
    near ±ex)."""
    a = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    b = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)
    c = _cross(a, b)
    d = torch.sum(a * b, dim=-1, keepdim=True)
    w = 1.0 + d
    q = torch.cat([w, c], dim=-1)
    ex = torch.zeros_like(a)
    ex[..., 0] = 1.0
    ez = torch.zeros_like(a)
    ez[..., 2] = 1.0
    alt1 = _cross(a, ex)
    alt2 = _cross(a, ez)
    alt = torch.where(
        torch.linalg.vector_norm(alt1, dim=-1, keepdim=True) > 0.1,
        alt1, alt2)
    q_anti = torch.cat([torch.zeros_like(w), alt], dim=-1)
    q = torch.where(w < 1e-6, q_anti, q)
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# Rigid transforms
# ---------------------------------------------------------------------------

class Rigid3(NamedTuple):
    """SE(3): rotation quaternion (..., 4) wxyz + translation (..., 3).

    Results handed to callers (``LocalizationResult.pose``, stored keyframe
    ground frames) hold numpy arrays; the methods take tensors."""

    rotation: Any
    translation: Any

    def compose(self, other: "Rigid3") -> "Rigid3":
        """self ∘ other: apply ``other`` first."""
        return Rigid3(
            quat_mul(self.rotation, other.rotation),
            quat_rotate(self.rotation, other.translation) + self.translation)

    def inverse(self) -> "Rigid3":
        rinv = quat_conj(self.rotation)
        return Rigid3(rinv, -quat_rotate(rinv, self.translation))

    def apply(self, points: Tensor) -> Tensor:
        """Transform points (..., 3) under broadcasting."""
        return quat_rotate(self.rotation, points) + self.translation


class Rigid2(NamedTuple):
    """SE(2): heading angle (...) + translation (..., 2)."""

    angle: Any
    translation: Any

    def compose(self, other: "Rigid2") -> "Rigid2":
        c, s = torch.cos(self.angle), torch.sin(self.angle)
        ox, oy = other.translation[..., 0], other.translation[..., 1]
        t = torch.stack([c * ox - s * oy, s * ox + c * oy], dim=-1)
        return Rigid2(self.angle + other.angle, t + self.translation)

    def inverse(self) -> "Rigid2":
        c, s = torch.cos(self.angle), torch.sin(self.angle)
        tx, ty = self.translation[..., 0], self.translation[..., 1]
        t = torch.stack([-(c * tx + s * ty), -(-s * tx + c * ty)], dim=-1)
        return Rigid2(-self.angle, t)

    def apply(self, points: Tensor) -> Tensor:
        c, s = torch.cos(self.angle), torch.sin(self.angle)
        x, y = points[..., 0], points[..., 1]
        return torch.stack([c * x - s * y, s * x + c * y],
                           dim=-1) + self.translation


def embed_3d(t: Rigid2) -> Rigid3:
    """SE(2) → SE(3) rotation about +Z."""
    zeros = torch.zeros_like(t.angle)
    q = quat_from_rpy(zeros, zeros, t.angle)
    trans = torch.cat([t.translation, torch.zeros_like(t.translation[..., :1])],
                      dim=-1)
    return Rigid3(q, trans)


def transform_points(t: Rigid3, points: Tensor) -> Tensor:
    """Transform a point set (N, 3) by a single Rigid3."""
    return quat_rotate(t.rotation[None, :], points) + t.translation[None, :]
