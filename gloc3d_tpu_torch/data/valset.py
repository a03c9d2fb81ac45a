"""Valset text export for external evaluators: the port's copy of the JAX
package's ``data/valset.py``.

Reimplements the semantics of the reference's write_valset_to_txt
(dataset/kitti_i2i.py:76-122): two plain-text artifacts that let third-party
C++ evaluators (LiDAR-Iris, ScanContext, M2DP in the reference's study)
consume the exact db/query split.

  index file:  "numDb numQ\n", then one scan path per line (db scans first,
               then query scans), then per query a line "qIdx: i j k ..."
               listing ground-truth-positive db indices whose planar distance
               falls in the requested band (easy <=5 m / medium 5-10 m /
               hard 10-15 m).
  pose file:   one "qx qy qz qw tx ty tz\n" line per scan, db first then
               queries. NOTE: the quaternion is written (x, y, z, w) to match
               the reference artifact (scipy as_quat order); the project's
               internal convention is (w, x, y, z).

Inside this framework the npz SplitIndex (data/kitti.py) is the canonical
split artifact — this export exists for reproducibility and external-tool
parity only.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

BANDS = {"easy": (0.0, 5.0), "medium": (5.0, 10.0), "hard": (10.0, 15.0)}


def _quat_xyzw_from_matrix(rot: np.ndarray) -> np.ndarray:
    """Rotation matrix → quaternion in scipy (x, y, z, w) order.

    Shepperd's method; branch on the largest diagonal term for stability.
    """
    m = np.asarray(rot, np.float64)
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] >= m[1, 1] and m[0, 0] >= m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] >= m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([x, y, z, w], np.float64)
    return q / np.linalg.norm(q)


def banded_positives(
    utm_db: np.ndarray, utm_q: np.ndarray, band: str
) -> Tuple[list, list]:
    """Per-query db indices and distances within the band's distance window."""
    lo, hi = BANDS[band]
    d = np.linalg.norm(
        np.asarray(utm_q, np.float64)[:, None, :]
        - np.asarray(utm_db, np.float64)[None, :, :],
        axis=-1,
    )
    idx, dist = [], []
    for qi in range(d.shape[0]):
        keep = np.nonzero((d[qi] >= lo) & (d[qi] <= hi))[0]
        idx.append(keep)
        dist.append(d[qi][keep])
    return idx, dist


def write_valset(split, index_path: str, pose_path: str,
                 band: str = "easy", max_pairs: int | None = None,
                 seed: int = 0) -> None:
    """Write the two-file valset artifact for a SplitIndex-like object.

    ``split`` needs db_files/q_files (scan paths), db_poses/q_poses
    ((N, 4, 4) lidar poses), and utm_db/utm_q ((N, 2) planar positions).

    max_pairs: optionally cap the exported (query, db) pairs by uniform
    random sampling — the nuScenes exporter's ≤100-pair subsample
    (nuscenes_s2s.py:277-334; its random.sample sits inside the per-query
    loop, progressively re-thinning — the ≤max_pairs capability is
    reproduced here with a single unbiased draw over all banded pairs).
    Queries left with no pairs are omitted from the pair lines, as in the
    reference artifact.
    """
    if band not in BANDS:
        raise ValueError(f"band must be one of {sorted(BANDS)}, got {band!r}")
    pos_idx, _ = banded_positives(split.utm_db, split.utm_q, band)
    if max_pairs is not None:
        flat = [(qi, int(i)) for qi, keep in enumerate(pos_idx) for i in keep]
        rng = np.random.RandomState(seed)
        take = rng.choice(len(flat), min(max_pairs, len(flat)),
                          replace=False) if flat else []
        chosen = sorted(flat[i] for i in take)
        pos_idx = [
            np.array([db for q, db in chosen if q == qi], np.int64)
            for qi in range(len(pos_idx))
        ]
    with open(index_path, "w") as f:
        f.write(f"{len(split.db_files)} {len(split.q_files)}\n")
        for p in list(split.db_files) + list(split.q_files):
            f.write(f"{p}\n")
        for qi, keep in enumerate(pos_idx):
            if max_pairs is not None and len(keep) == 0:
                continue
            f.write(f"{qi}:" + "".join(f"{int(i)} " for i in keep) + "\n")
    with open(pose_path, "w") as f:
        for pose in list(split.db_poses) + list(split.q_poses):
            q = _quat_xyzw_from_matrix(pose[:3, :3])
            t = np.asarray(pose[:3, 3], np.float64)
            f.write(f"{q[0]} {q[1]} {q[2]} {q[3]} {t[0]} {t[1]} {t[2]}\n")


def read_valset(index_path: str, pose_path: str):
    """Parse the artifact back (round-trip check / external-result import).

    Returns (db_files, q_files, positives, poses) with poses (Ndb+Nq, 4, 4)
    reconstructed from the quaternion lines.
    """
    with open(index_path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    n_db, n_q = (int(x) for x in lines[0].split())
    files = lines[1:1 + n_db + n_q]
    positives = []
    for ln in lines[1 + n_db + n_q:]:
        if not ln.strip():
            continue
        _, rest = ln.split(":", 1)
        positives.append(np.array([int(t) for t in rest.split()], np.int64))
    poses = []
    with open(pose_path) as f:
        for ln in f:
            v = [float(t) for t in ln.split()]
            if not v:
                continue
            x, y, z, w = v[:4]
            # quaternion (x,y,z,w) → rotation matrix
            q = np.array([w, x, y, z])
            q = q / np.linalg.norm(q)
            ww, xx, yy, zz = q
            rot = np.array([
                [1 - 2 * (yy**2 + zz**2), 2 * (xx * yy - ww * zz),
                 2 * (xx * zz + ww * yy)],
                [2 * (xx * yy + ww * zz), 1 - 2 * (xx**2 + zz**2),
                 2 * (yy * zz - ww * xx)],
                [2 * (xx * zz - ww * yy), 2 * (yy * zz + ww * xx),
                 1 - 2 * (xx**2 + yy**2)],
            ])
            m = np.eye(4)
            m[:3, :3] = rot
            m[:3, 3] = v[4:7]
            poses.append(m)
    return files[:n_db], files[n_db:], positives, np.stack(poses)
