"""Online SLAM loop-closure session on the port: the descriptor bank
proposes, ``GlobalLocalizer.match_keyframe`` verifies.

The port's copy of ``examples/slam_session.py``. Every new keyframe
queries the map built so far with the most recent frames excluded
(``DescriptorBank.query(..., exclude_recent=True)``, the gate of
``detect_loop``); a loop closure is a proposal under the metric gate that
the 2-D matcher registers. On a synthetic walled world:

1. the metric gate is calibrated on held-out validation poses (a seeded
   model's descriptor scale is arbitrary, so a deployment tunes the gate on
   a validation run like this one), at 4× the closest distinct-place pair,
   generous because the matcher verifies;
2. lap 1 around a square course maps every frame; no closure may verify,
   since every place is new;
3. lap 2 revisits the course with pose noise; each frame's proposals are
   verified with ``match_keyframe`` against one extraction of the frame
   (``bev=`` / ``ground=``), and the recovered relative (x, y, yaw) is held
   to the reference's success gate (1 m / 5°) and 80 % of the frames must
   close.

    python -m gloc3d_tpu_torch.examples.slam_session [--device cpu]
        [--lap 20] [--points 4096]

It runs on the card unless ``--device cpu`` is given; the defaults are the
JAX example's sizes (a 256² BEV). The search excludes the most recent 30 %
of a lap (6 of the JAX example's 20 poses). ``run`` returns the session's
figures and raises ``RuntimeError`` when a check fails.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Tuple

import numpy as np

from gloc3d_tpu_torch import (
    BEVConfig, GlobalLocalizer, IndexConfig, MatchConfig, ModelConfig,
    PipelineConfig, VoxelConfig, build_model, init_params,
)

POS_GATE_M, YAW_GATE_DEG, MIN_CLOSED = 1.0, 5.0, 0.8


def make_world(seed: int = 7, n_walls: int = 160,
               extent: float = 120.0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    walls = []
    for _ in range(n_walls):
        x0, y0 = rng.uniform(-extent, extent, 2)
        ang = rng.uniform(0, np.pi)
        ts = rng.uniform(0, rng.uniform(4, 12), 220)
        walls.append(np.stack([x0 + np.cos(ang) * ts, y0 + np.sin(ang) * ts,
                               rng.uniform(0, 3, 220)], 1))
    return np.concatenate(walls).astype(np.float32)


def scan_at(world: np.ndarray, x, y, yaw, seed: int, n_pts: int):
    """A noisy (n_pts, 4) scan with intensities from pose (x, y, yaw)."""
    r = np.random.RandomState(seed)
    rel = world[:, :2] - np.array([x, y])
    pts = world[np.linalg.norm(rel, axis=1) < 35]
    c, s = np.cos(-yaw), np.sin(-yaw)
    px, py = pts[:, 0] - x, pts[:, 1] - y
    out = np.stack([c * px - s * py, s * px + c * py, pts[:, 2]], 1)
    out = np.concatenate(
        [out + r.normal(0, 0.03, out.shape), r.uniform(0, 1, (len(out), 1))],
        1).astype(np.float32)
    pad = np.zeros((n_pts, 4), np.float32)
    sel = (r.choice(len(out), n_pts, replace=False)
           if len(out) > n_pts else np.arange(len(out)))
    pad[: len(sel)] = out[sel]
    mask = np.zeros(n_pts, np.float32)
    mask[: len(sel)] = 1.0
    return pad, mask


def square_lap(n: int, half: float = 60.0) -> List[Tuple[float, float,
                                                          float]]:
    """n poses around a square course, heading along the track."""
    poses = []
    for t in np.linspace(0, 1, n, endpoint=False):
        if t < 0.25:
            poses.append((-half + 8 * half * t, -half, 0.0))
        elif t < 0.5:
            poses.append((half, -half + 8 * half * (t - 0.25), np.pi / 2))
        elif t < 0.75:
            poses.append((half - 8 * half * (t - 0.5), half, np.pi))
        else:
            poses.append((-half, half - 8 * half * (t - 0.75), -np.pi / 2))
    return poses


def run(device: str = "cuda", lap_len: int = 20, n_pts: int = 4096,
        log=print) -> Dict[str, float]:
    """One session; returns its figures (closures, proposals, pose
    errors) and raises RuntimeError when a check fails."""
    image_size = 256
    exclude_recent = round(0.3 * lap_len)
    cfg = PipelineConfig(
        bev=BEVConfig(image_size=image_size, max_points=n_pts),
        voxel=VoxelConfig(max_points=n_pts),
        model=ModelConfig(encoder="pointpillar", encoder_dim=128),
        index=IndexConfig(dim=128, top_k=3,
                          num_exclude_recent=exclude_recent, capacity=128),
        match=MatchConfig(image_size=image_size, min_overlap_pixels=24,
                          min_peak_ratio=1.1),
    )
    world = make_world()
    model = init_params(build_model(cfg.model, cfg.voxel), seed=0)
    loc = GlobalLocalizer(cfg, model, device=device, device_keyframes=True)
    lap = square_lap(lap_len)
    rng = np.random.RandomState(1)

    def extract(pts, mask):
        return loc.extract(pts[None], mask[None])

    # ---- the metric gate, from held-out validation poses ----------------
    val_poses = [(rng.uniform(-55, 55), rng.uniform(-55, 55),
                  rng.uniform(0, 2 * np.pi)) for _ in range(12)]
    vdesc = np.stack([
        extract(*scan_at(world, x, y, yaw, 5000 + i, n_pts))[0][0].cpu()
        .numpy() for i, (x, y, yaw) in enumerate(val_poses)])
    d2v = ((vdesc[:, None] - vdesc[None]) ** 2).sum(-1)
    min_interplace = float(d2v[np.triu_indices(len(val_poses), k=1)].min())
    x, y, yaw = val_poses[0]
    d = extract(*scan_at(world, x + 1.0, y - 0.5, yaw + 0.1, 6000,
                         n_pts))[0][0].cpu().numpy()
    revisit_d2 = float(((d - vdesc[0]) ** 2).sum())
    gate = 4.0 * min_interplace
    loc.bank.cfg = loc.bank.cfg.replace(metric_dist_threshold=gate)
    log(f"gate calibrated on {len(val_poses)} validation poses: {gate:.3e} "
        f"(revisit d² {revisit_d2:.3e}, min inter-place "
        f"{min_interplace:.3e})")

    def propose(desc) -> List[int]:
        """Gated top-3 non-recent candidates, best first."""
        if len(loc.bank) <= exclude_recent + cfg.index.top_k:
            return []
        d2c, idxc = loc.bank.query(desc, k=3, exclude_recent=True)
        return [int(j) for j, dd in zip(idxc[0], d2c[0]) if dd < gate]

    # ---- lap 1: map online; the matcher must reject every alias ---------
    kf_poses = []
    proposals, verified_lap1 = 0, []
    for i, (x, y, yaw) in enumerate(lap):
        pts, mask = scan_at(world, x, y, yaw, i, n_pts)
        desc, bev, grd = extract(pts, mask)
        for db_idx in propose(desc):
            proposals += 1
            if loc.match_keyframe(db_index=db_idx, bev=bev,
                                  ground=grd).success:
                verified_lap1.append((i, db_idx))
                break
        loc.add_keyframes(pts[None], mask[None])
        kf_poses.append((x, y, yaw))
    if verified_lap1:
        raise RuntimeError(f"lap 1 verified closures: {verified_lap1}")
    log(f"lap 1: {len(lap)} keyframes mapped, {proposals} descriptor "
        f"proposals, 0 verified")

    # ---- lap 2: revisits with pose noise must close and register --------
    closures, pos_errs, yaw_errs = 0, [], []
    for i, (x, y, yaw) in enumerate(lap):
        dx, dy = rng.uniform(-2, 2, 2)
        dyaw = rng.uniform(-0.3, 0.3)
        pts, mask = scan_at(world, x + dx, y + dy, yaw + dyaw, 1000 + i,
                            n_pts)
        desc, bev, grd = extract(pts, mask)
        cands = propose(desc)
        loc.add_keyframes(pts[None], mask[None])
        kf_poses.append((x + dx, y + dy, yaw + dyaw))
        res, db_idx = None, -1
        for db_idx in cands:
            res = loc.match_keyframe(db_index=db_idx, bev=bev, ground=grd)
            if res.success:
                break
        if res is None or not res.success:
            continue
        closures += 1
        kx, ky, kyaw = kf_poses[db_idx]
        gx, gy = x + dx - kx, y + dy - ky
        c, s = np.cos(-kyaw), np.sin(-kyaw)
        mx, my, myaw = res.match_xy_yaw
        pos_errs.append(float(np.hypot(mx - (c * gx - s * gy),
                                       my - (s * gx + c * gy))))
        yerr = (myaw - (yaw + dyaw - kyaw) + np.pi) % (2 * np.pi) - np.pi
        yaw_errs.append(abs(float(yerr)))

    out = {"lap": len(lap), "closures": closures,
           "lap1_proposals": proposals,
           "max_pos_err_m": max(pos_errs, default=float("nan")),
           "mean_pos_err_m": float(np.mean(pos_errs)) if pos_errs
           else float("nan"),
           "max_yaw_err_deg": float(np.degrees(max(yaw_errs, default=0.0)))}
    log(f"lap 2: {closures}/{len(lap)} loop closures registered; "
        f"relative-pose error mean {out['mean_pos_err_m']:.3f} m, max "
        f"{out['max_pos_err_m']:.3f} m / {out['max_yaw_err_deg']:.2f}°")
    if closures < int(MIN_CLOSED * len(lap)):
        raise RuntimeError(f"too few closures: {closures}/{len(lap)}")
    if (out["max_pos_err_m"] >= POS_GATE_M
            or out["max_yaw_err_deg"] >= YAW_GATE_DEG):
        raise RuntimeError("closure poses outside the 1 m / 5° gate")
    log("OK: the session closed its loops within the 1 m / 5° gate")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--lap", type=int, default=20, help="poses per lap")
    p.add_argument("--points", type=int, default=4096,
                   help="scan size (padded points)")
    a = p.parse_args(argv)
    run(a.device, a.lap, a.points)
    return 0


if __name__ == "__main__":
    sys.exit(main())
