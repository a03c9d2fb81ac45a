"""NCLT dataset binding: the port's copy of the JAX package's
``data/nclt.py``.

Reproduces dataset/nclt_i2i.py / nclt_s2s.py semantics: velodyne_sync scans
named by microsecond timestamp, RTK ground truth CSV interpolated (nearest)
to scan timestamps (nclt_i2i.py:84-99), lat/lng → local ENU with the
spherical small-angle approximation r = 6.4e6 m (nclt_i2i.py:60-82), NaN/Inf
filtering (nclt_i2i.py:148-157), train session 2012-01-08 / val 2013-04-05
(nclt_i2i.py:101-107), every 5th frame, 20 % held-out queries.

Layout expected:
  ROOT/SESSION/velodyne_sync/*.bin        (packed uint16 format)
  ROOT/SESSION/groundtruth_SESSION.csv    (RTK: t, ?, num_sats, lat, lng, alt)
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from gloc3d_tpu_torch.data.kitti import SplitIndex
from gloc3d_tpu_torch.data.readers import interpolate_nearest, nclt_rtk_to_enu

TRAIN_SESSION = "2012-01-08"
VAL_SESSION = "2013-04-05"


def session_frames(
    root: str, session: str, skip_frames: int = 5
) -> Tuple[List[str], np.ndarray]:
    """(scan paths, (N, 3) ENU positions) for every skip-th valid frame."""
    vel_dir = os.path.join(root, session, "velodyne_sync")
    files = sorted(
        f for f in os.listdir(vel_dir) if f.endswith(".bin")
    )
    ts = np.array([int(os.path.splitext(f)[0]) for f in files], np.float64)

    gt_path = os.path.join(root, session, f"groundtruth_{session}.csv")
    gps = np.loadtxt(gt_path, delimiter=",")
    order = np.argsort(gps[:, 0])
    gps = gps[order]
    interp = interpolate_nearest(gps[:, 0], gps[:, 3:6], ts)
    lat, lng, alt = interp[:, 0], interp[:, 1], interp[:, 2]
    enu = nclt_rtk_to_enu(lat, lng, alt)

    valid = np.isfinite(enu).all(axis=1)
    keep = np.nonzero(valid)[0][::skip_frames]
    return (
        [os.path.join(vel_dir, files[i]) for i in keep],
        enu[keep],
    )


def generate_split(
    root: str,
    which: str = "train",
    skip_frames: int = 5,
    query_fraction: float = 0.2,
    seed: int = 0,
    session: Optional[str] = None,
) -> SplitIndex:
    session = session or (TRAIN_SESSION if which == "train" else VAL_SESSION)
    files, enu = session_frames(root, session, skip_frames)
    utm = enu[:, :2]
    poses = np.tile(np.eye(4), (len(files), 1, 1))
    poses[:, :3, 3] = enu

    rng = np.random.RandomState(seed)
    n = len(files)
    nq = int(n * query_fraction)
    q_index = rng.choice(n, nq, replace=False)
    q_set = set(q_index.tolist())
    db_idx = [i for i in range(n) if i not in q_set]
    return SplitIndex(
        db_files=[files[i] for i in db_idx],
        q_files=[files[i] for i in q_index],
        db_poses=poses[db_idx], q_poses=poses[q_index],
        utm_db=utm[db_idx], utm_q=utm[q_index],
    )
