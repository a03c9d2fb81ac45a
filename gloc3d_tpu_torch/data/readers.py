"""Pure-numpy scan decoders and pose parsing: the port's copy of the JAX
package's ``data/readers.py``.

Formats match the reference exactly:
  KITTI:    float32 × 4 per point (x, y, z, intensity)
            (save_probability_img.cpp:65-88, kitti_s2s.py:219-227)
  nuScenes: float32 × 5 per point (x, y, z, intensity, dt)
            (save_probability_img.cpp:90-113)
  NCLT:     8-byte records: uint16 x,y,z scaled 0.005 m offset −100 m +
            uint8 intensity + uint8 laser id (nclt_s2s.py:41-70)
"""

from __future__ import annotations

import os
import numpy as np


def read_kitti_bin(path: str) -> np.ndarray:
    data = np.fromfile(path, dtype=np.float32)
    return data.reshape(-1, 4)


def read_nuscenes_bin(path: str) -> np.ndarray:
    data = np.fromfile(path, dtype=np.float32).reshape(-1, 5)
    return data[:, :4].copy()


def read_nclt_bin(path: str) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.uint8)
    raw = raw[: (len(raw) // 8) * 8].reshape(-1, 8)
    xyz_u16 = raw[:, :6].copy().view("<u2").reshape(-1, 3)
    xyz = xyz_u16.astype(np.float32) * 0.005 - 100.0
    intensity = raw[:, 6].astype(np.float32)
    return np.concatenate([xyz, intensity[:, None]], axis=1)


# --------------------------------------------------------------------- KITTI

def read_kitti_poses(path: str) -> np.ndarray:
    """poses/SS.txt → (N, 4, 4) cam0 poses (12 floats per line)."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    n = rows.shape[0]
    out = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
    out[:, :3, :] = rows
    return out


def read_kitti_calib(path: str) -> np.ndarray:
    """calib.txt → T_cam0_velo (the 'Tr:' line), (4, 4)."""
    with open(path) as f:
        for line in f:
            if line.startswith("Tr"):
                vals = np.array(line.split(":")[1].split(), np.float64)
                t = np.eye(4)
                t[:3, :] = vals.reshape(3, 4)
                return t
    raise ValueError(f"no 'Tr' line in {path}")


def kitti_velo_poses(poses_cam0: np.ndarray, t_cam0_velo: np.ndarray
                     ) -> np.ndarray:
    """LiDAR-frame poses: T_w_velo = T_w_cam0 · T_cam0_velo
    (kitti_s2s.py:53-80 semantics)."""
    return poses_cam0 @ t_cam0_velo[None]


# ---------------------------------------------------------------------- NCLT

def nclt_rtk_to_enu(lat: np.ndarray, lng: np.ndarray, alt: np.ndarray,
                    lat0: float | None = None, lng0: float | None = None
                    ) -> np.ndarray:
    """RTK GPS → local ENU meters, small-angle sphere approximation with
    r = 6.4e6 m (nclt_i2i.py:60-82)."""
    r = 6400000.0
    lat0 = lat[0] if lat0 is None else lat0
    lng0 = lng[0] if lng0 is None else lng0
    x = np.sin(lat - lat0) * r
    y = np.sin(lng - lng0) * r * np.cos(lat0)
    return np.stack([x, y, alt], axis=1)


def interpolate_nearest(ts_src: np.ndarray, values: np.ndarray,
                        ts_query: np.ndarray) -> np.ndarray:
    """Nearest-sample interpolation of rows of ``values`` at query times
    (the scipy interp1d(kind='nearest') use in nclt_i2i.py:84-99)."""
    idx = np.searchsorted(ts_src, ts_query)
    idx = np.clip(idx, 1, len(ts_src) - 1)
    left = ts_query - ts_src[idx - 1]
    right = ts_src[idx] - ts_query
    nearest = np.where(left <= right, idx - 1, idx)
    return values[nearest]
