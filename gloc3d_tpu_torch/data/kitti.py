"""KITTI odometry dataset binding: the port's copy of the JAX package's
``data/kitti.py``.

Reproduces the reference split semantics (kitti_i2i.py:124-204) directly from
the KITTI *odometry* layout (sequences/SS/velodyne/*.bin + poses/SS.txt +
calib.txt), without the pykitti raw/odometry pairing: train sequences
{00,01,02,04,05,06,07,10}, val {08,09}, every ``skip_frames``-th frame, 20 %
of frames held out (without replacement) as queries, positives radius 20 m,
nontrivial positives 10 m. Planar positions come from the lidar-frame pose
translation (the raw-GPS UTM of the reference differs by a bounded offset;
distances between nearby frames — all that the thresholds consume — match).

Produces a SplitIndex (paths + poses + positions), from which scan batches
are loaded via the native loader and turned into a TripletDataset or fed to
the pipeline and the evaluator.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from gloc3d_tpu_torch.data.dataset import TripletDataset
from gloc3d_tpu_torch.data.native import load_scan_batch, masks_from_counts
from gloc3d_tpu_torch.data.readers import (
    kitti_velo_poses, read_kitti_calib, read_kitti_poses,
)

TRAIN_SEQUENCES = ("00", "01", "02", "04", "05", "06", "07", "10")
VAL_SEQUENCES = ("08", "09")


@dataclasses.dataclass
class SplitIndex:
    """db/query file lists with lidar poses and planar positions."""

    db_files: List[str]
    q_files: List[str]
    db_poses: np.ndarray   # (Ndb, 4, 4)
    q_poses: np.ndarray    # (Nq, 4, 4)
    utm_db: np.ndarray     # (Ndb, 2)
    utm_q: np.ndarray      # (Nq, 2)
    pos_dist_thr: float = 20.0
    nontriv_pos_dist: float = 10.0

    def save(self, path: str) -> None:
        np.savez(
            path,
            db_files=np.array(self.db_files), q_files=np.array(self.q_files),
            db_poses=self.db_poses, q_poses=self.q_poses,
            utm_db=self.utm_db, utm_q=self.utm_q,
            thresholds=np.array([self.pos_dist_thr, self.nontriv_pos_dist]),
        )

    @classmethod
    def load(cls, path: str) -> "SplitIndex":
        d = np.load(path, allow_pickle=False)
        thr = d["thresholds"]
        return cls(
            db_files=[str(s) for s in d["db_files"]],
            q_files=[str(s) for s in d["q_files"]],
            db_poses=d["db_poses"], q_poses=d["q_poses"],
            utm_db=d["utm_db"], utm_q=d["utm_q"],
            pos_dist_thr=float(thr[0]), nontriv_pos_dist=float(thr[1]),
        )


def sequence_frames(root: str, seq: str, skip_frames: int = 5
                    ) -> Tuple[List[str], np.ndarray]:
    """(velodyne file paths, lidar poses) for every skip-th frame of a
    sequence in the odometry layout."""
    seq_dir = os.path.join(root, "sequences", seq)
    velo_dir = os.path.join(seq_dir, "velodyne")
    files = sorted(
        os.path.join(velo_dir, f) for f in os.listdir(velo_dir)
        if f.endswith(".bin")
    )
    poses_cam = read_kitti_poses(os.path.join(root, "poses", f"{seq}.txt"))
    t_cam_velo = read_kitti_calib(os.path.join(seq_dir, "calib.txt"))
    poses_velo = kitti_velo_poses(poses_cam, t_cam_velo)
    n = min(len(files), len(poses_velo))
    idx = list(range(0, n, skip_frames))
    return [files[i] for i in idx], poses_velo[idx]


def generate_split(
    root: str,
    which: str = "train",
    skip_frames: int = 5,
    query_fraction: float = 0.2,
    seed: int = 0,
    sequences: Optional[Sequence[str]] = None,
) -> SplitIndex:
    """Build the train/val split with the 20 % held-out-query scheme."""
    if sequences is None:
        sequences = TRAIN_SEQUENCES if which == "train" else VAL_SEQUENCES
    files_all: List[str] = []
    poses_all: List[np.ndarray] = []
    for seq in sequences:
        f, p = sequence_frames(root, seq, skip_frames)
        files_all.extend(f)
        poses_all.append(p)
    poses = np.concatenate(poses_all)
    utm = poses[:, :2, 3]

    rng = np.random.RandomState(seed)
    n = len(files_all)
    nq = int(n * query_fraction)
    q_index = rng.choice(n, nq, replace=False)
    q_set = set(q_index.tolist())
    db_idx = [i for i in range(n) if i not in q_set]
    return SplitIndex(
        db_files=[files_all[i] for i in db_idx],
        q_files=[files_all[i] for i in q_index],
        db_poses=poses[db_idx], q_poses=poses[q_index],
        utm_db=utm[db_idx], utm_q=utm[q_index],
    )


def load_split_scans(split: SplitIndex, max_points: int = 122480,
                     num_threads: int = 8):
    """Decode all scans of a split with the native loader →
    TripletDataset (s2s inputs, with masks and poses)."""
    db, db_counts = load_scan_batch(split.db_files, "kitti", max_points,
                                    num_threads)
    q, q_counts = load_scan_batch(split.q_files, "kitti", max_points,
                                  num_threads)
    return TripletDataset(
        db_inputs=db, q_inputs=q,
        utm_db=split.utm_db, utm_q=split.utm_q,
        db_masks=masks_from_counts(db_counts, max_points),
        q_masks=masks_from_counts(q_counts, max_points),
        db_poses=split.db_poses, q_poses=split.q_poses,
    )


def audit_sequence_overlap(
    seq_positions: dict,
) -> List[Tuple[str, str]]:
    """Report sequence pairs whose trajectory bounding boxes intersect.

    The reference's split-design audit (eval_sequence_overlap,
    kitti_s2s.py:507-563): train/val sequences must not share territory or
    val queries leak into the training map. Takes {seq_name: (N, 2) planar
    positions} (any frame, any dataset — the reference hardcodes KITTI raw
    OXTS→ENU; here the caller supplies positions, e.g. SplitIndex.utm_* or
    sequence_frames poses) and returns the intersecting pairs, ordered as
    enumerated. KITTI odometry's known answer: 07 intersects 08.
    """
    names = list(seq_positions)
    boxes = {}
    for name in names:
        p = np.asarray(seq_positions[name], dtype=np.float64)
        if p.ndim != 2 or p.shape[1] < 2 or len(p) == 0:
            raise ValueError(f"sequence {name!r}: need (N>=1, >=2) positions")
        boxes[name] = (p[:, 0].min(), p[:, 1].min(),
                       p[:, 0].max(), p[:, 1].max())
    hits: List[Tuple[str, str]] = []
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            ax0, ay0, ax1, ay1 = boxes[a]
            bx0, by0, bx1, by1 = boxes[b]
            if max(ax0, bx0) <= min(ax1, bx1) and max(ay0, by0) <= min(ay1, by1):
                hits.append((a, b))
    return hits
