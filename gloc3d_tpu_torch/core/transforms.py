"""SE(3) / SE(2) rigid transforms and quaternion algebra on tensors.

Port of ``gloc3d_tpu/core/transforms.py`` for the located query, plain and
ground-aligned, for the refiners and for the pose loss: quaternion algebra,
``matrix_to_quat``, the angle-axis maps, Euler extraction, the ground-alignment
helpers (``remove_yaw``, ``quat_from_two_vectors``), ``Rigid3`` / ``Rigid2``
(which also take the numpy poses that results hold) and ``embed_3d``.
Quaternions are (w, x, y, z) in the last axis; every function broadcasts
over leading axes and is branch-free (``torch.where``), as the JAX
functions are.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
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


def get_angle(q: Tensor) -> Tensor:
    """Non-negative rotation angle of a quaternion."""
    return 2.0 * torch.atan2(torch.linalg.vector_norm(q[..., 1:], dim=-1),
                             torch.abs(q[..., 0]))


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

def _tensors(*xs) -> tuple:
    """``xs`` as tensors. A tensor stays as it is; anything else (a numpy
    array, a number) goes through ``torch.as_tensor`` with its own dtype,
    onto the device of the first tensor among ``xs``, or the CPU when there
    is none. So the numpy poses that results hold compose with tensors on
    any device. A numpy view that torch cannot share (negative strides,
    read-only) is copied first."""
    device = next((x.device for x in xs if isinstance(x, Tensor)), None)
    return tuple(
        x if isinstance(x, Tensor) else torch.as_tensor(
            np.require(x, requirements="CW") if isinstance(x, np.ndarray)
            else x, device=device)
        for x in xs)


class Rigid3(NamedTuple):
    """SE(3): rotation quaternion (..., 4) wxyz + translation (..., 3).

    Results handed to callers (``LocalizationResult.pose``, stored keyframe
    ground frames) hold numpy arrays. The methods take numpy arrays or
    tensors, in the fields and in the operands, and return tensors."""

    rotation: Any
    translation: Any

    @staticmethod
    def identity(dtype=torch.float32, device=None) -> "Rigid3":
        return Rigid3(quat_identity(dtype, device),
                      torch.zeros(3, dtype=dtype, device=device))

    @staticmethod
    def from_matrix(m) -> "Rigid3":
        """From a (..., 4, 4) homogeneous matrix."""
        (m,) = _tensors(m)
        return Rigid3(matrix_to_quat(m[..., :3, :3]), m[..., :3, 3])

    def to_matrix(self) -> Tensor:
        """(..., 4, 4) homogeneous matrix in the translation's dtype and on
        its device, last row (0, 0, 0, 1)."""
        q, t = _tensors(*self)
        m = t.new_zeros(t.shape[:-1] + (4, 4))
        m[..., :3, :3] = quat_to_matrix(q)
        m[..., :3, 3] = t
        m[..., 3, 3] = 1.0
        return m

    def compose(self, other: "Rigid3") -> "Rigid3":
        """self ∘ other: apply ``other`` first."""
        q, t, oq, ot = _tensors(*self, *other)
        return Rigid3(quat_mul(q, oq), quat_rotate(q, ot) + t)

    def inverse(self) -> "Rigid3":
        q, t = _tensors(*self)
        rinv = quat_conj(q)
        return Rigid3(rinv, -quat_rotate(rinv, t))

    def apply(self, points) -> Tensor:
        """Transform points (..., 3) under broadcasting."""
        q, t, points = _tensors(*self, points)
        return quat_rotate(q, points) + t

    def __matmul__(self, other):
        """``compose`` for a Rigid3, ``apply`` for points."""
        if isinstance(other, Rigid3):
            return self.compose(other)
        return self.apply(other)


class Rigid2(NamedTuple):
    """SE(2): heading angle (...) + translation (..., 2); numpy or tensor
    fields and operands, as ``Rigid3``'s."""

    angle: Any
    translation: Any

    @staticmethod
    def identity(dtype=torch.float32, device=None) -> "Rigid2":
        return Rigid2(torch.zeros((), dtype=dtype, device=device),
                      torch.zeros(2, dtype=dtype, device=device))

    def compose(self, other: "Rigid2") -> "Rigid2":
        a, t, oa, ot = _tensors(*self, *other)
        c, s = torch.cos(a), torch.sin(a)
        ox, oy = ot[..., 0], ot[..., 1]
        rot = torch.stack([c * ox - s * oy, s * ox + c * oy], dim=-1)
        return Rigid2(a + oa, rot + t)

    def inverse(self) -> "Rigid2":
        a, t = _tensors(*self)
        c, s = torch.cos(a), torch.sin(a)
        tx, ty = t[..., 0], t[..., 1]
        inv = torch.stack([-(c * tx + s * ty), -(-s * tx + c * ty)], dim=-1)
        return Rigid2(-a, inv)

    def apply(self, points) -> Tensor:
        a, t, points = _tensors(*self, points)
        c, s = torch.cos(a), torch.sin(a)
        x, y = points[..., 0], points[..., 1]
        return torch.stack([c * x - s * y, s * x + c * y], dim=-1) + t


def project_2d(t: Rigid3) -> Rigid2:
    """SE(3) → SE(2) on the XY plane: the yaw and the xy translation."""
    q, trans = _tensors(*t)
    return Rigid2(get_yaw(q), trans[..., :2])


def embed_3d(t: Rigid2) -> Rigid3:
    """SE(2) → SE(3) rotation about +Z."""
    angle, trans = _tensors(*t)
    zeros = torch.zeros_like(angle)
    q = quat_from_rpy(zeros, zeros, angle)
    return Rigid3(q, torch.cat([trans, torch.zeros_like(trans[..., :1])],
                               dim=-1))


def transform_points(t: Rigid3, points) -> Tensor:
    """Transform a point set (N, 3) by a single Rigid3."""
    q, trans, points = _tensors(*t, points)
    return quat_rotate(q[None, :], points) + trans[None, :]
