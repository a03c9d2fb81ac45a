"""Rigid transforms needed by the unaligned located query.

Port of ``gloc3d_tpu/core/transforms.py::quat_from_rpy`` and the ``Rigid3``
container. Quaternions are (w, x, y, z). The rest of that module (compose,
inverse, Euler extraction, ground alignment helpers) comes with the aligned
slice (ROADMAP Queue 1, item 10).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


def quat_from_rpy(roll: torch.Tensor, pitch: torch.Tensor,
                  yaw: torch.Tensor) -> torch.Tensor:
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


class Rigid3(NamedTuple):
    """SE(3): rotation quaternion (..., 4) wxyz + translation (..., 3)."""

    rotation: Any
    translation: Any
