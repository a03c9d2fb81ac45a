"""6-DoF pose composition from a 2-D BEV match, and the success metric.

Port of ``gloc3d_tpu/eval/registration.py``: ``compose_6dof``,
``registration_errors`` and the aggregate ``registration_stats``. With
both ground frames given:
    T_rpz   = T_db_l2g⁻¹ · T_q_l2g                    → roll, pitch, dz
    T_yawxy = T_db_l2g⁻¹ · Embed3D(xy_yaw) · T_q_l2g  → dx, dy, yaw
    pose    = (RollPitchYaw(roll, pitch, yaw), (dx, dy, dz));
if either is None (a keyframe ingested without a ground estimate), the
non-aligned branch: pose = (Rz(yaw), (dx, dy, 0)). Roll, pitch and yaw are
canonical ZYX Euler angles, as in the JAX function.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gloc3d_tpu_torch.core.transforms import (
    Rigid2, Rigid3, embed_3d, quat_from_rpy, quat_to_matrix, rpy_from_quat,
)


def _as_rigid(t: Rigid3, device=None) -> Rigid3:
    """Rigid3 of numpy arrays or tensors → fp32 tensors (on ``device``)."""
    return Rigid3(
        torch.as_tensor(t.rotation, dtype=torch.float32, device=device),
        torch.as_tensor(t.translation, dtype=torch.float32, device=device))


def compose_6dof(xy_yaw: torch.Tensor, t_q_l2g: Optional[Rigid3] = None,
                 t_db_l2g: Optional[Rigid3] = None) -> Rigid3:
    """(3,) metric (dx, dy, yaw) between the (possibly ground-aligned) BEV
    frames + the query's and db keyframe's ground transforms → the
    query→db pose (tensors on the CPU)."""
    xy_yaw = torch.as_tensor(xy_yaw, dtype=torch.float32).cpu()
    yaw2d = xy_yaw[2]
    if t_q_l2g is None or t_db_l2g is None:
        z = torch.zeros((), dtype=xy_yaw.dtype)
        q = quat_from_rpy(z, z, yaw2d)
        t = torch.stack([xy_yaw[0], xy_yaw[1], z])
        return Rigid3(q, t)

    t_q, t_db = _as_rigid(t_q_l2g, "cpu"), _as_rigid(t_db_l2g, "cpu")
    t_qg_dbg = embed_3d(Rigid2(yaw2d, xy_yaw[:2]))
    db_inv = t_db.inverse()
    t_rpz = db_inv.compose(t_q)
    t_yawxy = db_inv.compose(t_qg_dbg).compose(t_q)
    roll, pitch, _ = rpy_from_quat(t_rpz.rotation)
    _, _, yaw = rpy_from_quat(t_yawxy.rotation)
    q = quat_from_rpy(roll, pitch, yaw)
    t = torch.stack([t_yawxy.translation[0], t_yawxy.translation[1],
                     t_rpz.translation[2]])
    return Rigid3(q, t)


def registration_errors(pred: Rigid3, gt: Rigid3
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(err_pos_m, err_rot_deg): geodesic rotation error by the trace
    formula, forgiving a 180° flip within 5°, and translation L2. Success
    is err_pos < 1 m and err_rot < 5°."""
    pred, gt = _as_rigid(pred), _as_rigid(gt)
    r_pred = quat_to_matrix(pred.rotation)
    r_gt = quat_to_matrix(gt.rotation)
    err_r = r_gt.transpose(-1, -2) @ r_pred
    tr = err_r.diagonal(dim1=-2, dim2=-1).sum(-1)
    cos = torch.clamp(0.5 * (tr - 1.0), -0.999999, 0.999999)
    err_rot = torch.abs(torch.acos(cos)) * (180.0 / math.pi)
    err_rot = torch.where(torch.abs(err_rot - 180.0) < 5.0,
                          torch.abs(err_rot - 180.0), err_rot)
    err_pos = torch.linalg.vector_norm(gt.translation - pred.translation,
                                       dim=-1)
    return err_pos, err_rot


class RegistrationStats(NamedTuple):
    success_rate: float
    mean_rot_err: float
    std_rot_err: float
    mean_pos_err: float
    std_pos_err: float
    num_success: int
    num_total: int


def registration_stats(
    err_pos: np.ndarray, err_rot: np.ndarray, attempted: np.ndarray,
    pos_thresh: float = 1.0, rot_thresh: float = 5.0,
) -> RegistrationStats:
    """Aggregate like registration_recalls (global_localization.cpp:270-335):
    success = attempted & thresholds; means over successes only; rate over
    all queries (failed registrations count in the denominator)."""
    err_pos = np.asarray(err_pos)
    err_rot = np.asarray(err_rot)
    attempted = np.asarray(attempted).astype(bool)
    ok = attempted & (err_pos < pos_thresh) & (err_rot < rot_thresh)
    n = len(err_pos)
    if ok.sum() == 0:
        return RegistrationStats(0.0, 0.0, 0.0, 0.0, 0.0, 0, n)
    return RegistrationStats(
        success_rate=float(ok.sum()) / max(n, 1),
        mean_rot_err=float(err_rot[ok].mean()),
        std_rot_err=float(err_rot[ok].std()),
        mean_pos_err=float(err_pos[ok].mean()),
        std_pos_err=float(err_pos[ok].std()),
        num_success=int(ok.sum()),
        num_total=n,
    )
