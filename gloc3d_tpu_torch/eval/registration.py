"""6-DoF pose composition from a 2-D BEV match.

Port of ``gloc3d_tpu/eval/registration.py::compose_6dof``, non-aligned
branch: pose = (Rz(yaw), (dx, dy, 0)). The ground-aligned branch needs the
ground estimator and comes with the aligned slice (ROADMAP Queue 1,
item 10).
"""

from __future__ import annotations

from typing import Optional

import torch

from gloc3d_tpu_torch.core.transforms import Rigid3, quat_from_rpy


def compose_6dof(xy_yaw: torch.Tensor, t_q_l2g: Optional[Rigid3] = None,
                 t_db_l2g: Optional[Rigid3] = None) -> Rigid3:
    """(3,) metric (dx, dy, yaw) between the BEV frames → query→db pose."""
    if t_q_l2g is not None or t_db_l2g is not None:
        raise NotImplementedError(
            "ground-aligned composition comes with the aligned slice "
            "(ROADMAP Queue 1, item 10)")
    xy_yaw = torch.as_tensor(xy_yaw, dtype=torch.float32)
    z = torch.zeros((), dtype=xy_yaw.dtype, device=xy_yaw.device)
    q = quat_from_rpy(z, z, xy_yaw[2])
    t = torch.stack([xy_yaw[0], xy_yaw[1], z])
    return Rigid3(q, t)
