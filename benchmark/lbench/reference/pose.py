"""6-DoF pose from a 2-D BEV match and the two ground frames, in numpy
float64 rotation matrices.

With T_q, T_db the lidar → ground transforms of the query and the
keyframe and E the match (dx, dy, yaw) lifted to 3-D:
    A = T_db⁻¹ · T_q        gives roll, pitch and dz,
    B = T_db⁻¹ · E · T_q    gives dx, dy and yaw,
and the pose is (Rz(yaw)·Ry(pitch)·Rx(roll), (dx, dy, dz)). Without a
keyframe ground frame: (Rz(yaw), (dx, dy, 0)).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

Rigid = Tuple[np.ndarray, np.ndarray]  # (3, 3) rotation, (3,) translation


def quat_matrix(q) -> np.ndarray:
    w, x, y, z = (float(v) for v in q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def rpy_matrix(roll: float, pitch: float, yaw: float) -> np.ndarray:
    cr, sr, cp, sp = math.cos(roll), math.sin(roll), math.cos(pitch), \
        math.sin(pitch)
    cy, sy = math.cos(yaw), math.sin(yaw)
    return np.array([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr]])


def _compose(a: Rigid, b: Rigid) -> Rigid:
    return a[0] @ b[0], a[0] @ b[1] + a[1]


def _inverse(a: Rigid) -> Rigid:
    return a[0].T, -a[0].T @ a[1]


def compose_6dof(xy_yaw, ground_q: Optional[Rigid],
                 ground_db: Optional[Rigid]) -> Rigid:
    dx, dy, yaw = (float(v) for v in xy_yaw)
    if ground_q is None or ground_db is None:
        return rpy_matrix(0.0, 0.0, yaw), np.array([dx, dy, 0.0])
    lift = (rpy_matrix(0.0, 0.0, yaw), np.array([dx, dy, 0.0]))
    inv = _inverse(ground_db)
    a = _compose(inv, ground_q)
    b = _compose(_compose(inv, lift), ground_q)
    roll = math.atan2(a[0][2, 1], a[0][2, 2])
    pitch = math.asin(max(-1.0, min(1.0, -a[0][2, 0])))
    yaw_b = math.atan2(b[0][1, 0], b[0][0, 0])
    return (rpy_matrix(roll, pitch, yaw_b),
            np.array([b[1][0], b[1][1], a[1][2]]))


def rigid(q, t) -> Rigid:
    """A wxyz quaternion and translation as a (matrix, vector) pair."""
    return quat_matrix(q), np.asarray(t, np.float64)


def rotation_gap_deg(r1: np.ndarray, r2: np.ndarray) -> float:
    """Geodesic angle between two rotation matrices, degrees."""
    cos = (np.trace(r1.T @ r2) - 1.0) / 2.0
    return math.degrees(math.acos(max(-1.0, min(1.0, cos))))
