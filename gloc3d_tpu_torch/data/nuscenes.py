"""nuScenes dataset binding: the port's copy of the JAX package's
``data/nuscenes.py``.

The reference (dataset/nuscenes_s2s.py, byte-identical nuscenes_i2i.py) walks
nuscenes-devkit for scenes in 'singapore-onenorth' (:167), takes each sample's
LIDAR_TOP ego pose as the position (:209-275), aggregates up to ``nsweeps``
previous lidar sweeps into the reference sample's ego frame as 5-dim
(x, y, z, reflectance, dt) points (get_lidar_data, :82-136), and exports
≤100 sampled val pairs (:277-334). The devkit is an optional dependency
here: when installed, ``build_manifest`` extracts the same tables (including
the per-sample sweep chains); ``generate_split`` and ``aggregate_sweeps``
only need the manifest npz, keeping the binding usable (and testable) in
devkit-less environments.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np

from gloc3d_tpu_torch.data.kitti import SplitIndex
from gloc3d_tpu_torch.data.readers import read_nuscenes_bin

DEFAULT_LOCATION = "singapore-onenorth"


def build_manifest(dataroot: str, out_path: str,
                   location: str = DEFAULT_LOCATION,
                   version: str = "v1.0-trainval",
                   nsweeps: int = 1) -> None:
    """Extract (lidar path, ego pose) per sample via nuscenes-devkit.

    With nsweeps > 1 the manifest additionally records, per sample, the
    chain of up to ``nsweeps`` sweep files (the sample's own LIDAR_TOP plus
    its ``prev`` predecessors), each sweep's sensor→reference-ego transform
    (car_from_global · global_from_car · car_from_current, the composition
    of nuscenes_s2s.py:101-123), and its time lag dt = t_ref − t_sweep —
    everything ``aggregate_sweeps`` needs without the devkit.
    """
    try:
        from nuscenes.nuscenes import NuScenes
        from pyquaternion import Quaternion
    except ImportError as e:  # pragma: no cover - optional dependency
        raise ImportError(
            "nuscenes-devkit is required to build a manifest; install it or "
            "provide a prebuilt manifest npz"
        ) from e

    def tf(rec, inverse=False):
        m = np.eye(4)
        m[:3, :3] = Quaternion(rec["rotation"]).rotation_matrix
        m[:3, 3] = rec["translation"]
        return np.linalg.inv(m) if inverse else m

    nusc = NuScenes(version=version, dataroot=dataroot, verbose=False)
    files, poses = [], []
    sweep_files, sweep_tf, sweep_dt, sweep_valid = [], [], [], []
    for scene in nusc.scene:
        log = nusc.get("log", scene["log_token"])
        if log["location"] != location:
            continue
        token = scene["first_sample_token"]
        while token:
            sample = nusc.get("sample", token)
            sd = nusc.get("sample_data", sample["data"]["LIDAR_TOP"])
            ego = nusc.get("ego_pose", sd["ego_pose_token"])
            files.append(os.path.join(dataroot, sd["filename"]))
            poses.append(tf(ego))
            if nsweeps > 1:
                car_from_global = tf(ego, inverse=True)
                ref_time = 1e-6 * sd["timestamp"]
                sf = [""] * nsweeps
                st = np.zeros((nsweeps, 4, 4))
                sdt = np.zeros(nsweeps)
                sv = np.zeros(nsweeps, bool)
                cur = sd
                for si in range(nsweeps):
                    cur_ego = nusc.get("ego_pose", cur["ego_pose_token"])
                    cur_cs = nusc.get(
                        "calibrated_sensor", cur["calibrated_sensor_token"])
                    sf[si] = os.path.join(dataroot, cur["filename"])
                    st[si] = car_from_global @ tf(cur_ego) @ tf(cur_cs)
                    sdt[si] = ref_time - 1e-6 * cur["timestamp"]
                    sv[si] = True
                    if cur["prev"] == "":
                        break
                    cur = nusc.get("sample_data", cur["prev"])
                sweep_files.append(sf)
                sweep_tf.append(st)
                sweep_dt.append(sdt)
                sweep_valid.append(sv)
            token = sample["next"]
    kw = dict(files=np.array(files), poses=np.stack(poses))
    if nsweeps > 1:
        kw.update(
            sweep_files=np.array(sweep_files), sweep_tf=np.stack(sweep_tf),
            sweep_dt=np.stack(sweep_dt), sweep_valid=np.stack(sweep_valid),
        )
    np.savez(out_path, **kw)


def aggregate_sweeps(
    sweep_files: np.ndarray,      # (nsweeps,) file paths ("" = unused slot)
    sweep_tf: np.ndarray,         # (nsweeps, 4, 4) sensor→reference-ego
    sweep_dt: np.ndarray,         # (nsweeps,) time lags, seconds
    sweep_valid: np.ndarray,      # (nsweeps,) bool
    max_points: int,
    min_distance: float = 1.0,
    read_fn: Callable[[str], np.ndarray] = read_nuscenes_bin,
) -> Tuple[np.ndarray, np.ndarray]:
    """Multi-sweep lidar aggregation (nuscenes_s2s.py:82-136 semantics).

    Each sweep's cloud is close-point filtered (|x| < min_distance AND
    |y| < min_distance removed — LidarPointCloud.remove_close), transformed
    into the reference sample's ego frame, and tagged with its time lag;
    rows are (x, y, z, reflectance, dt). Output is padded/trimmed to
    ``max_points`` with a validity mask (the framework's static-shape
    convention; sweeps are concatenated reference-sample-first so trimming
    drops the oldest points, matching the reference's front-to-back order).
    """
    chunks = []
    for si in range(len(sweep_files)):
        if not bool(sweep_valid[si]):
            continue
        raw = np.asarray(read_fn(str(sweep_files[si])), np.float32)
        xyz, rest = raw[:, :3], raw[:, 3:4]
        close = (np.abs(xyz[:, 0]) < min_distance) & (
            np.abs(xyz[:, 1]) < min_distance)
        xyz, rest = xyz[~close], rest[~close]
        t = np.asarray(sweep_tf[si], np.float32)
        xyz = xyz @ t[:3, :3].T + t[:3, 3]
        dt = np.full((len(xyz), 1), np.float32(sweep_dt[si]))
        chunks.append(np.concatenate([xyz, rest, dt], axis=1))
    pts = (np.concatenate(chunks) if chunks
           else np.zeros((0, 5), np.float32))
    out = np.zeros((max_points, 5), np.float32)
    n = min(len(pts), max_points)
    out[:n] = pts[:n]
    mask = np.zeros(max_points, np.float32)
    mask[:n] = 1.0
    return out, mask


def generate_split(
    manifest_path: str,
    skip_frames: int = 1,
    query_fraction: float = 0.2,
    seed: int = 0,
) -> SplitIndex:
    """Split a manifest into db/queries (same scheme as KITTI/NCLT)."""
    d = np.load(manifest_path, allow_pickle=False)
    files = [str(f) for f in d["files"]][::skip_frames]
    poses = d["poses"][::skip_frames]
    utm = poses[:, :2, 3]

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
