"""End-to-end global-localization evaluator (GlocEvaluator parity): the
port's ``gloc3d_tpu/eval/evaluator.py``.

Drives the port's GlobalLocalizer over a db/query split and reports what
registration/global_localization.cpp reports:
  - recognition recall@{1,5,10,20} over queries with GT positives
    (:221-268), with failed_detect_indices dumped;
  - registration success rate (err_pos < 1 m ∧ err_rot < 5°, 180° flip
    forgiven) + mean/std errors over successes (:270-335), with
    failed_registration_indices dumped;
  - latency: db build per scan, locate per query, and the p50 / p95 of the
    per-query time of each ``locate_batch`` call after the first, on the
    host clock. Each ``locate_batch`` call ends in a host read of its
    results, so a call's time includes its device work.

Distance-banded variants (easy ≤5 m / medium 5-10 m / hard 10-15 m,
kitti_i2i.py:96-122 write_valset_to_txt) are reported when poses are given.
Ground-truth poses and errors are computed with the port's Rigid3 on the
localizer's device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from gloc3d_tpu_torch.core.transforms import Rigid3, get_yaw
from gloc3d_tpu_torch.data.dataset import TripletDataset
from gloc3d_tpu_torch.data.viz import match_overlay, save_png
from gloc3d_tpu_torch.eval.recall import recall_at_n
from gloc3d_tpu_torch.eval.registration import (
    registration_errors, registration_stats,
)
from gloc3d_tpu_torch.pipeline import GlobalLocalizer


@dataclasses.dataclass
class EvalReport:
    recognition_recall: Dict[int, float]
    registration: Dict[str, float]
    banded_success: Dict[str, float]
    latency_ms: Dict[str, float]
    failed_detect_indices: List[int]
    failed_registration_indices: List[int]

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["recognition_recall"] = {str(k): v for k, v in
                                   self.recognition_recall.items()}
        return json.dumps(d, indent=2)


def _relative_pose(db_pose: np.ndarray, q_pose: np.ndarray,
                   device=None) -> Rigid3:
    """GT query pose in the db keyframe frame: T_db⁻¹ · T_q
    (global_localization.cpp:287), composed in float64, as an fp32 Rigid3
    on ``device``."""
    rel = torch.as_tensor(np.linalg.inv(db_pose) @ q_pose,
                          dtype=torch.float32, device=device)
    return Rigid3.from_matrix(rel)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pad(a: Optional[np.ndarray], n: int, fill: str):
    """``a`` grown to ``n`` rows: zero rows or copies of its last row."""
    if a is None or len(a) == n:
        return a
    extra = (np.zeros_like(a[:1]) if fill == "zeros" else a[-1:])
    return np.concatenate([a, np.repeat(extra, n - len(a), 0)])


def _rows(ds: TripletDataset, which: str, sl) -> tuple:
    """(inputs, masks, origins) of the db or query rows ``sl``."""
    return tuple(None if a is None else a[sl] for a in (
        getattr(ds, f"{which}_inputs"), getattr(ds, f"{which}_masks"),
        getattr(ds, f"{which}_origins")))


def _one_query(ds: TripletDataset, qi: int) -> tuple:
    return tuple(None if a is None else a[None]
                 for a in _rows(ds, "q", qi))


def evaluate_split(
    localizer: GlobalLocalizer,
    ds: TripletDataset,
    out_dir: Optional[str] = None,
    batch: int = 8,
    n_values=(1, 5, 10, 20),
) -> EvalReport:
    """Build the db from ds.db_inputs in batches of ``batch`` (the last
    padded with zero scans, dropped again after), then locate the queries
    in batches of ``batch`` (the last padded with copies of its last
    query). With ``out_dir``, write eval_report.json, the failure dumps
    under failure_cases/ and the failed-index files."""
    t = localizer.cfg.train
    dev = localizer.device
    nq = ds.num_q

    # ---- db build ----
    t0 = time.perf_counter()
    for i in range(0, ds.num_db, batch):
        end = min(i + batch, ds.num_db)
        localizer.add_keyframes(*(_pad(a, batch, "zeros")
                                  for a in _rows(ds, "db", slice(i, end))))
        localizer.keyframes = localizer.keyframes[:end]
    localizer.bank.truncate(ds.num_db)
    build_s = time.perf_counter() - t0

    positives = ds.eval_positives(t.pos_dist_thr)
    have_poses = ds.db_poses is not None and ds.q_poses is not None

    preds = []
    err_pos = np.full(nq, np.inf)
    err_rot = np.full(nq, np.inf)
    attempted = np.zeros(nq, bool)
    q_dists = np.full(nq, np.inf)
    failed_reg: List[int] = []
    detect_s = 0.0
    batch_times: List[float] = []

    for start in range(0, nq, batch):
        sl = slice(start, min(start + batch, nq))
        q_in, q_mk, q_or = (_pad(a, batch, "last")
                            for a in _rows(ds, "q", sl))
        t0 = time.perf_counter()
        results = localizer.locate_batch(q_in, q_mk, q_or)
        batch_times.append(time.perf_counter() - t0)
        detect_s += batch_times[-1]
        for j, res in enumerate(results[: sl.stop - sl.start]):
            qi = start + j
            preds.append(np.asarray(res.candidates))
            if not res.success:
                failed_reg.append(qi)
                continue
            attempted[qi] = True
            if have_poses:
                gt = _relative_pose(ds.db_poses[res.db_index], ds.q_poses[qi],
                                    dev)
                pred = Rigid3(torch.as_tensor(res.pose.rotation, device=dev),
                              torch.as_tensor(res.pose.translation,
                                              device=dev))
                ep, er = registration_errors(pred, gt)
                err_pos[qi] = float(ep)
                err_rot[qi] = float(er)
                q_dists[qi] = float(torch.linalg.vector_norm(
                    gt.translation[:2]))

    preds_arr = np.stack(preds) if preds else np.zeros((0, 1), int)
    rec = recall_at_n(preds_arr, positives, n_values)
    hit1 = (
        np.take_along_axis(positives, preds_arr, axis=1).any(axis=1)
        if nq else np.zeros(0, bool)
    )
    failed_detect = [i for i in range(nq)
                     if positives[i].any() and not hit1[i]]

    stats = registration_stats(err_pos, err_rot, attempted)
    banded = {}
    if have_poses:
        bands = {"easy": (0.0, 5.0), "medium": (5.0, 10.0),
                 "hard": (10.0, 15.0)}
        ok = attempted & (err_pos < 1.0) & (err_rot < 5.0)
        for name, (lo, hi) in bands.items():
            in_band = (q_dists >= lo) & (q_dists < hi) & np.isfinite(q_dists)
            banded[name] = (
                float((ok & in_band).sum()) / max(int(in_band.sum()), 1)
            )

    # the tail excludes the first call, which carries the one-time work
    # (kernel loads, cuFFT plans, allocator growth); the average keeps it,
    # timing the whole eval as the reference does
    tail = batch_times[1:] or batch_times
    report = EvalReport(
        recognition_recall=rec,
        registration={
            "success_rate": stats.success_rate,
            "mean_rot_err_deg": stats.mean_rot_err,
            "std_rot_err_deg": stats.std_rot_err,
            "mean_pos_err_m": stats.mean_pos_err,
            "std_pos_err_m": stats.std_pos_err,
            "num_success": stats.num_success,
            "num_total": stats.num_total,
        },
        banded_success=banded,
        latency_ms={
            "db_build_per_scan": build_s / max(ds.num_db, 1) * 1000,
            "locate_per_query": detect_s / max(nq, 1) * 1000,
            "locate_per_query_p50": (
                float(np.percentile(tail, 50)) / batch * 1000
                if batch_times else 0.0),
            "locate_per_query_p95": (
                float(np.percentile(tail, 95)) / batch * 1000
                if batch_times else 0.0),
        },
        failed_detect_indices=failed_detect,
        failed_registration_indices=failed_reg,
    )
    if out_dir:
        _write_artifacts(localizer, ds, out_dir, report, preds_arr,
                         positives, have_poses)
    return report


def _write_artifacts(localizer: GlobalLocalizer, ds: TripletDataset,
                     out_dir: str, report: EvalReport, preds_arr: np.ndarray,
                     positives: np.ndarray, have_poses: bool) -> None:
    """eval_report.json, failure_cases/ and the failed-index files."""
    failed_detect = report.failed_detect_indices
    failed_reg = report.failed_registration_indices
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "eval_report.json"), "w") as f:
        f.write(report.to_json())
    # failure-case dumps (main.py:200-273 failure_case parity): for each
    # false-negative query, its BEV next to its top prediction and one GT
    # positive
    fc_dir = os.path.join(out_dir, "failure_cases")
    os.makedirs(fc_dir, exist_ok=True)
    # host_mirror=False keyframes carry no host-side image to dump
    with_images = bool(localizer.keyframes
                       and localizer.keyframes[0].image is not None)
    for qi in failed_detect[:50] if with_images else []:
        _, _, bev, _ = localizer.detect(*_one_query(ds, qi))
        top1 = int(preds_arr[qi, 0])
        gt_idx = int(np.nonzero(positives[qi])[0][0])
        np.savez(
            os.path.join(fc_dir, f"query_{qi}.npz"),
            query=(_host(bev.image[0]) * 255).astype(np.uint8),
            top_prediction=localizer.keyframes[top1].image,
            gt_positive=localizer.keyframes[gt_idx].image,
            top_prediction_idx=top1, gt_idx=gt_idx,
        )
    # registration-failure overlays (i2i_util.py:540-620 /
    # loop_detector.cpp:224-232): the query BEV warped by the GROUND-TRUTH
    # relative pose onto its top-1 candidate, a PNG where an image backend
    # is installed
    for qi in failed_reg[:20] if with_images and have_poses else []:
        _, _, bev, _ = localizer.detect(*_one_query(ds, qi))
        top1 = int(np.clip(preds_arr[qi, 0], 0, len(localizer.keyframes) - 1))
        kf = localizer.keyframes[top1]
        gt = _relative_pose(ds.db_poses[top1], ds.q_poses[qi])
        xy_yaw = np.array([float(gt.translation[0]), float(gt.translation[1]),
                           float(get_yaw(gt.rotation))])
        ov = match_overlay(
            _host(bev.image[0]), _host(bev.origin_xy[0]),
            kf.image, np.asarray(kf.origin_xy), xy_yaw,
            float(np.asarray(bev.resolution)))
        save_png(os.path.join(
            fc_dir, f"reg_fail_overlay_{qi}_vs_{top1}.png"), ov)
    # reference-format failure dumps (global_localization.cpp:258-267)
    with open(os.path.join(out_dir, "failed_detect_indices.txt"), "w") as f:
        f.write(" ".join(str(i) for i in failed_detect) + "\n")
    with open(os.path.join(out_dir,
                           "failed_registration_indices.txt"), "w") as f:
        f.write(" ".join(str(i) for i in failed_reg) + "\n")
