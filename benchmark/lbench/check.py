"""Whether what the timed path produced is correct: the program's map and a
seeded sample of the queries it answered in the window, held to the plain
reference computed anew from the same scans, weights and draws.

The numbers compared (each against the cell's limit in
``limits/<cell>.json``):

- ``ground_gap``: the keyframes' ground transforms, the largest
  difference of a quaternion (sign-aligned) or translation component;
- ``store_px``: pixels of the keyframes' store images that differ from
  the reference's BEV images (an origin off by more than 1e-4 m counts
  the whole image);
- ``bank_gap``: the bank, the largest ‖program − reference‖ / ‖reference‖
  of a real keyframe's row (the filler rows must be the ones handed in);
- ``d2_gap``: each returned candidate's distance against the reference's
  distance of the same row, over the reference query's squared norm;
- ``rank_gap``: the reference's distance of the r-th returned candidate
  less the reference's r-th smallest, over the same norm (near ties may
  swap, a wrong ranking may not);
- ``success_mismatch``, ``db_mismatch``: queries whose success or
  returned keyframe differs from the reference's registration of the same
  candidates;
- ``score_gap``, ``xy_gap_m``, ``yaw_gap_deg``: the registration of the
  returned keyframe;
- ``pose_gap_m``, ``pose_gap_deg``: the 6-DoF pose.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from lbench.reference import pose as rpose

NAMES = ("ground_gap", "store_px", "bank_gap", "d2_gap", "rank_gap",
         "success_mismatch", "db_mismatch", "score_gap", "xy_gap_m",
         "yaw_gap_deg", "pose_gap_m", "pose_gap_deg")


class Answer(NamedTuple):
    """One query's answer as the program returned it."""
    success: bool
    db_index: int
    candidates: np.ndarray
    d2: np.ndarray
    score: float
    xy_yaw: Optional[np.ndarray]
    rotation: Optional[np.ndarray]      # (3, 3)
    translation: Optional[np.ndarray]   # (3,)


class MapState(NamedTuple):
    """The program's map: bank rows (M, D), the real keyframes' store
    images (R, S, S) and origins (R, 2), their ground (R, 4), (R, 3)."""
    bank: torch.Tensor
    images: torch.Tensor
    origins: torch.Tensor
    ground_q: np.ndarray
    ground_t: np.ndarray


def _wrap(a: float) -> float:
    return abs(math.remainder(a, 2 * math.pi))


def compare_map(prog: MapState, ref: dict, filler: torch.Tensor
                ) -> Dict[str, float]:
    n_real = ref["image"].shape[0]
    rq = ref["rot"].cpu().numpy().astype(np.float64)
    rt = ref["trans"].cpu().numpy().astype(np.float64)
    pq = np.asarray(prog.ground_q, np.float64)
    sign = np.where((pq * rq).sum(-1, keepdims=True) < 0, -1.0, 1.0)
    ground = max(float(np.abs(pq * sign - rq).max()),
                 float(np.abs(np.asarray(prog.ground_t) - rt).max()))
    img = prog.images.to(ref["image"].device)
    px = int((img != ref["image"]).sum())
    org = (prog.origins.to(ref["origin"].device) - ref["origin"]).abs()
    px += int((org.amax(-1) > 1e-4).sum()) * int(img[0].numel())
    bank = prog.bank.to(ref["desc"].device).float()
    real = bank[:n_real]
    want = ref["desc"].float()
    gap = float(((real - want).norm(dim=-1)
                 / want.norm(dim=-1).clamp_min(1e-12)).max())
    fill = bank[n_real:]
    same = (fill.shape == filler.shape
            and bool((fill == filler.to(fill.device)).all()))
    return {"ground_gap": ground, "store_px": float(px),
            "bank_gap": gap if same else math.inf}


def compare_queries(answers: List[Answer], ref: dict) -> Dict[str, float]:
    """``answers`` of one batch of queries against ``Reference.locate``'s
    output for the same scans and the program's candidates."""
    out = {k: 0.0 for k in NAMES[3:]}
    q = ref["q"]["desc"].float()
    norm = (q * q).sum(-1).cpu().numpy()
    all_d2 = ref["all_d2"].cpu().numpy()
    ref_d2 = ref["d2"].cpu().numpy()
    for i, a in enumerate(answers):
        cand = np.asarray(a.candidates, np.int64)
        k = len(ref_d2[i])
        if (len(cand) != k or len(set(cand.tolist())) != k
                or cand.min() < 0 or cand.max() >= all_d2.shape[1]):
            out["rank_gap"] = math.inf
            continue
        mine = all_d2[i, cand]
        out["d2_gap"] = max(out["d2_gap"], float(
            np.abs(np.asarray(a.d2, np.float64) - mine).max() / norm[i]))
        out["rank_gap"] = max(out["rank_gap"], float(
            (mine - ref_d2[i]).max() / norm[i]))
        success, db, score, xy_yaw, p = ref["results"][i]
        out["success_mismatch"] += float(a.success != success)
        out["db_mismatch"] += float(a.db_index != db)
        if a.success != success or a.db_index != db:
            continue
        out["score_gap"] = max(out["score_gap"], abs(a.score - score))
        if not success:
            continue
        dxy = float(np.abs(np.asarray(a.xy_yaw[:2]) - xy_yaw[:2]).max())
        out["xy_gap_m"] = max(out["xy_gap_m"], dxy)
        out["yaw_gap_deg"] = max(out["yaw_gap_deg"], math.degrees(
            _wrap(float(a.xy_yaw[2]) - float(xy_yaw[2]))))
        out["pose_gap_m"] = max(out["pose_gap_m"], float(
            np.abs(np.asarray(a.translation, np.float64) - p[1]).max()))
        out["pose_gap_deg"] = max(out["pose_gap_deg"], rpose.rotation_gap_deg(
            np.asarray(a.rotation, np.float64), p[0]))
    return out


def worst(parts: List[Dict[str, float]]) -> Dict[str, float]:
    """The largest reading of each number over the parts; the counts
    summed."""
    out: Dict[str, float] = {}
    for p in parts:
        for k, v in p.items():
            if k.endswith("mismatch"):
                out[k] = out.get(k, 0.0) + v
            else:
                out[k] = max(out.get(k, 0.0), v)
    return out


def verdict(readings: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number the cell has no limit for fails."""
    table = {k: {"value": readings.get(k, math.inf),
                 "limit": limits.get(k)} for k in NAMES}
    ok = all(v["limit"] is not None and v["value"] <= v["limit"]
             for v in table.values())
    return ok, table
