#!/usr/bin/env python3
"""Drive the PyTorch port's s2s located query once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. the card (torch's name, and nvidia-smi's name and power limit);
  2. build kernel K1 (csrc/segment_sum.cu) from the checkout, and report
     whether the native scan loader built or its numpy fallback is in use;
  3. K1 against its plain PyTorch version on the card: the main-path shape
     with real `starts` from the host pass, pillar 0 holding > 50k rows,
     and empty segments; error relative to per-segment L1 mass (bound
     1e-5); CUDA-event times of both at the main-path shape;
  4. the located query at full PipelineConfig.s2s() width (122 480-point
     scans, 768² BEV, top-20, 120 coarse / 11 fine rotations) with the
     folded bf16 serving model from the port's seeded init: 16 keyframes
     and 8 `locate` queries in a synthetic walled world; every query must
     succeed within 1 m and 5° of the ground-truth pose relative to the
     keyframe it returns, K1 must have launched on that path, and one query
     is checked against the same code on the CPU (plain kernel versions);
  5. timings: detect at bench.py's shape (synthetic scan, 10 000 × 128
     bank, top-20) and the located query, with the card's name and power
     limit beside them.
The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero before those.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
K1_SOURCE = "gloc3d_tpu_torch/csrc/segment_sum.cu"
K1_REPLACES = "gloc3d_tpu/ops/pallas_scatter.py:106"
N_KEYFRAMES, N_QUERIES = 16, 8
POS_TOL_M, ROT_TOL_DEG = 1.0, 5.0


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ----------------------------------------------------------------- world
def make_world(seed: int = 0, n_walls: int = 300, extent: float = 100.0,
               pts_per_m: float = 100.0) -> np.ndarray:
    """Vertical walls 5-15 m long, 0-3 m high, ~100 points per metre."""
    rng = np.random.RandomState(seed)
    walls = []
    for _ in range(n_walls):
        x0, y0 = rng.uniform(-extent, extent, 2)
        ang, length = rng.uniform(0, np.pi), rng.uniform(5, 15)
        m = int(length * pts_per_m)
        ts = rng.uniform(0, length, m)
        walls.append(np.stack([x0 + np.cos(ang) * ts, y0 + np.sin(ang) * ts,
                               rng.uniform(0.0, 3.0, m)], 1))
    return np.concatenate(walls).astype(np.float32)


def scan_at(world: np.ndarray, pose, n_pad: int, seed: int,
            view_radius: float = 70.0, n_ground: int = 40000):
    """Observe the world from (x, y, yaw): walls within range plus a
    sensor-centred ground ring (dense near the sensor, as a LiDAR sees it),
    shuffled and padded to n_pad rows of (x, y, z, intensity)."""
    x, y, yaw = pose
    rng = np.random.RandomState(seed)
    rel = world[:, :2] - np.array([x, y], np.float32)
    keep = np.linalg.norm(rel, axis=1) < view_radius
    c, s = np.cos(-yaw), np.sin(-yaw)
    px, py = rel[keep, 0], rel[keep, 1]
    wall = np.stack([c * px - s * py, s * px + c * py, world[keep, 2]], 1)
    r = rng.uniform(3.0, 40.0, n_ground)
    th = rng.uniform(0, 2 * np.pi, n_ground)
    ground = np.stack([r * np.cos(th), r * np.sin(th),
                       np.full(n_ground, -1.73)], 1)
    pts = np.concatenate([wall, ground]).astype(np.float32)
    pts = pts[rng.permutation(len(pts))][:n_pad]
    out = np.zeros((n_pad, 4), np.float32)
    out[: len(pts), :3] = pts
    out[: len(pts), 3] = rng.uniform(0, 1, len(pts))
    mask = np.zeros(n_pad, np.float32)
    mask[: len(pts)] = 1.0
    return out, mask


def bench_query_scan(n_pts: int):
    """bench.py::load_query_scan's synthetic scan (100 000 points uniform in
    the pillar grid), padded to n_pts."""
    pts = np.zeros((1, n_pts, 4), np.float32)
    rng = np.random.RandomState(0)
    n_real = 100000
    pts[0, :n_real, 0] = rng.uniform(-35, 35, n_real)
    pts[0, :n_real, 1] = rng.uniform(-20, 20, n_real)
    pts[0, :n_real, 2] = rng.uniform(-2, 3, n_real)
    pts[0, :n_real, 3] = rng.uniform(0, 1, n_real)
    mask = np.zeros((1, n_pts), np.float32)
    mask[0, :n_real] = 1.0
    return pts, mask


def relative_pose(db, q):
    """Ground-truth 2-D pose of the query in the db keyframe's frame."""
    c, s = np.cos(-db[2]), np.sin(-db[2])
    dx, dy = q[0] - db[0], q[1] - db[1]
    dyaw = math.remainder(q[2] - db[2], 2 * math.pi)
    return np.array([c * dx - s * dy, s * dx + c * dy]), dyaw


# ---------------------------------------------------------------- timing
def cuda_ms(torch, fn, iters: int, flush=None) -> float:
    """Mean device time of fn() over iters launches (CUDA events); with
    ``flush`` the L2 cache is overwritten before each launch."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    cold = flush is not None
    for _ in range(iters if cold else 1):
        if cold:
            flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(1 if cold else iters):
            fn()
        e1.record()
        torch.cuda.synchronize()
        total += e0.elapsed_time(e1)
    return total / iters


def host_ms(torch, fn, iters: int) -> float:
    """Median host wall time of fn() ending in a device synchronise."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


# ---------------------------------------------------------------- phases
def phase_device(torch):
    check(torch.cuda.is_available(), "no CUDA device: torch.cuda."
          "is_available() is False")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[device] torch: {name}; count {torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(card)
    # fp32 comparisons below must not run convolutions in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return name, card


def phase_build():
    from gloc3d_tpu_torch._shared import native
    from gloc3d_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.load("segment_sum")
    took = time.perf_counter() - t0
    regs = [ln.split(":", 1)[1].strip() for ln in build.build_log.get(
        "segment_sum", "").splitlines() if "registers" in ln]
    print(f"[build] K1 {K1_SOURCE}: {took:.2f} s "
          f"(nvcc {build.build_seconds.get('segment_sum', 0.0):.2f} s); "
          f"ptxas: {' | '.join(regs) or 'cached build'}")
    lib = native._load_library()
    print("[build] native scan loader: "
          + ("built (native/scan_loader.cpp)" if lib is not None
             else "NOT built, numpy fallback of data/native.py in use"))


def phase_k1(torch, cfg, world, card):
    from gloc3d_tpu_torch._shared import native
    from gloc3d_tpu_torch.kernels import segment_sum as ss

    dev = torch.device("cuda")
    vc = cfg.voxel
    n = vc.max_points
    gen = torch.Generator(device=dev).manual_seed(0)

    def host_starts(pts, mask):
        counts = np.asarray(mask.sum(axis=1), np.int64)
        out = native.compute_voxel_stats_host_sorted(
            pts, counts, vc.xbound, vc.ybound, vc.zbound, crop=False)
        return torch.from_numpy(out[5]).to(dev)

    full = scan_at(world, (0.0, 0.0, 0.0), n, seed=1)
    sparse = scan_at(world, (0.0, 0.0, 0.0), n, seed=2)
    sparse[1][60000:] = 0.0  # 62k padding rows alias into pillar 0
    sparse[0][60000:] = 0.0
    ids = torch.tensor([1, 1, 2, 2, 2, 4, 4, 9], device=dev)
    cases = {
        "main path (1, 122480, 64)": host_starts(full[0][None],
                                                  full[1][None]),
        "pillar 0 > 50k rows": host_starts(sparse[0][None], sparse[1][None]),
        "empty segments (8, 64), V=12": torch.searchsorted(
            ids, torch.arange(13, device=dev)).int()[None],
    }
    worst, main_err, main_x = 0.0, None, None
    for label, starts in cases.items():
        rows = int(starts[0, -1])
        x = torch.randn((1, rows, 64), generator=gen, device=dev)
        got = ss.segment_sum_sorted(x, starts)
        torch.cuda.synchronize()
        plain = ss.segment_sum_sorted_plain(x, starts)
        l1 = ss.segment_sum_sorted_plain(x.abs(), starts).double()
        diff = (got - plain).double().abs()
        rel = float((diff / l1.clamp_min(1e-30)).max())
        check(bool(torch.isfinite(got).all()), f"K1 {label}: non-finite")
        empty = (starts[0, 1:] == starts[0, :-1])
        check(bool((got[0, empty] == 0).all()),
              f"K1 {label}: empty segments not zero")
        p0 = int(starts[0, 1] - starts[0, 0])
        print(f"[k1] {label}: pillar-0 rows {p0}, empty segments "
              f"{int(empty.sum())}, max |kernel - plain| "
              f"{float(diff.max()):.3e}, relative to per-segment L1 mass "
              f"{rel:.3e} (bound 1e-5)")
        worst = max(worst, rel)
        if main_err is None:
            main_err, main_x, main_starts = float(diff.max()), x, starts
    check(worst < 1e-5, f"K1 disagrees with its plain version: {worst:.3e}")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    times = {}
    for label, fn in (("plain", ss.segment_sum_sorted_plain),
                      ("kernel", ss.segment_sum_sorted),
                      ("kernel", ss.segment_sum_sorted),
                      ("plain", ss.segment_sum_sorted_plain)):
        warm = cuda_ms(torch, lambda: fn(main_x, main_starts), 50)
        cold = cuda_ms(torch, lambda: fn(main_x, main_starts), 20, flush)
        times.setdefault(label, []).append((warm, cold))
    k = np.mean(times["kernel"], axis=0)
    p = np.mean(times["plain"], axis=0)
    print(f"[k1] time at (1, 122480, 64) on {card}: kernel {k[0]:.4f} ms "
          f"L2-warm / {k[1]:.4f} ms L2-flushed; plain {p[0]:.4f} / "
          f"{p[1]:.4f} ms (order plain, kernel, kernel, plain)")
    return main_err, float(k[1]), float(p[1])


def build_serving_model(torch, cfg, dtype: str):
    """The folded serving model from the port's seeded init: seed the
    standard model, fold its BatchNorms, load into the fold_bn=True model."""
    from gloc3d_tpu_torch.convert import fold_batch_norm
    from gloc3d_tpu_torch.models.descriptor import build_model, init_params

    std = init_params(build_model(
        cfg.model.replace(fold_bn=False, compute_dtype=dtype), cfg.voxel),
        seed=0)
    with torch.no_grad():  # non-trivial BN statistics, so folding matters
        g = torch.Generator().manual_seed(1)
        for m in std.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.copy_(0.1 * torch.randn(
                    m.running_mean.shape, generator=g))
                m.running_var.uniform_(0.5, 2.0, generator=g)
    served = build_model(cfg.model.replace(fold_bn=True, compute_dtype=dtype),
                         cfg.voxel)
    served.load_state_dict(fold_batch_norm(std.state_dict()))
    return served.eval()


def phase_located_query(torch, cfg, world, device="cuda"):
    from gloc3d_tpu_torch.kernels import segment_sum as ss
    from gloc3d_tpu_torch.pipeline import GlobalLocalizer

    n = cfg.voxel.max_points
    rng = np.random.RandomState(7)
    grid = np.linspace(-7.5, 7.5, 4)
    kf_poses = [(x, y, rng.uniform(-np.pi, np.pi)) for x in grid
                for y in grid]
    q_poses = [(rng.uniform(-6, 6), rng.uniform(-6, 6),
                rng.uniform(-np.pi, np.pi)) for _ in range(N_QUERIES)]
    kf = [scan_at(world, p, n, seed=100 + i) for i, p in enumerate(kf_poses)]
    qs = [scan_at(world, p, n, seed=200 + i) for i, p in enumerate(q_poses)]
    fill = np.mean([q[1].sum() for q in qs]) / n
    print(f"[locate] world {len(world)} points; scans fill {fill:.1%} of the "
          f"{n}-point pad; gates min_score {cfg.match.min_score}, "
          f"min_overlap_pixels {cfg.match.min_overlap_pixels}")

    model = build_serving_model(torch, cfg, "bfloat16")
    loc = GlobalLocalizer(cfg, model, device=torch.device(device))
    ss.segment_sum_sorted.launches = 0
    for i in range(0, N_KEYFRAMES, 4):
        loc.add_keyframes(np.stack([k[0] for k in kf[i:i + 4]]),
                          np.stack([k[1] for k in kf[i:i + 4]]))
    results = [loc.locate(*q) for q in qs]
    launches = ss.segment_sum_sorted.launches
    print(f"[locate] K1 launches on the main path: {launches}")
    check(launches >= N_KEYFRAMES // 4 + N_QUERIES,
          f"K1 launched {launches} times on the main path")

    check(len(loc.bank) == N_KEYFRAMES, "bank size")
    descs = loc.bank.data
    check(bool(torch.isfinite(descs).all()) and descs.shape == (
        N_KEYFRAMES, cfg.index.dim), "keyframe descriptors")
    worst_pos = worst_rot = 0.0
    for i, (res, qp) in enumerate(zip(results, q_poses)):
        check(res.success, f"query {i} did not localize "
              f"(score {res.match_score:.3f})")
        check(len(res.candidates) == cfg.index.top_k, "top-k length")
        t_gt, yaw_gt = relative_pose(kf_poses[res.db_index], qp)
        q = res.pose.rotation
        yaw = 2.0 * math.atan2(q[3], q[0])
        pos_err = float(np.linalg.norm(res.pose.translation[:2] - t_gt))
        rot_err = abs(math.degrees(math.remainder(yaw - yaw_gt, 2 * math.pi)))
        worst_pos, worst_rot = max(worst_pos, pos_err), max(worst_rot,
                                                            rot_err)
        print(f"[locate] query {i}: db {res.db_index} (top-1 "
              f"{res.candidates[0]}), score {res.match_score:.3f}, "
              f"error {pos_err:.3f} m / {rot_err:.3f} deg")
        check(pos_err < POS_TOL_M and rot_err < ROT_TOL_DEG,
              f"query {i}: pose error {pos_err:.3f} m / {rot_err:.3f} deg")
    print(f"[locate] {N_QUERIES}/{N_QUERIES} localized; worst error "
          f"{worst_pos:.3f} m / {worst_rot:.3f} deg "
          f"(bound {POS_TOL_M} m / {ROT_TOL_DEG} deg)")
    return loc, kf, qs, launches


def phase_reference(torch, cfg, kf, qs):
    """One query on the card against the same port code on the CPU (plain
    kernel versions), in fp32 with TF32 off."""
    from gloc3d_tpu_torch.pipeline import GlobalLocalizer

    out = {}
    for dev in ("cuda", "cpu"):
        model = build_serving_model(torch, cfg, "float32")
        loc = GlobalLocalizer(cfg, model, device=torch.device(dev))
        loc.add_keyframes(np.stack([k[0] for k in kf[:2]]),
                          np.stack([k[1] for k in kf[:2]]))
        res = loc.locate(*qs[0])
        out[dev] = (loc.bank.data.cpu().numpy(), res)
    d_gpu, r_gpu = out["cuda"]
    d_cpu, r_cpu = out["cpu"]
    derr = float(np.abs(d_gpu - d_cpu).max())
    print(f"[reference] fp32 descriptors card vs CPU: max |diff| {derr:.2e} "
          f"(bound atol 2e-4 + rtol 2e-3); success {r_gpu.success}/"
          f"{r_cpu.success}, db {r_gpu.db_index}/{r_cpu.db_index}")
    check(np.allclose(d_gpu, d_cpu, atol=2e-4, rtol=2e-3),
          "card descriptors disagree with the CPU reference")
    check(r_gpu.success == r_cpu.success
          and r_gpu.db_index == r_cpu.db_index, "card locate != CPU locate")
    if r_gpu.success:
        perr = float(np.abs(r_gpu.match_xy_yaw - r_cpu.match_xy_yaw).max())
        print(f"[reference] match (dx, dy, yaw) card vs CPU: max |diff| "
              f"{perr:.2e}")
        check(perr <= 0.2 + 1e-3, "card pose disagrees with the CPU pose")


def phase_timing(torch, cfg, loc, qs, card):
    from gloc3d_tpu_torch._shared import native
    from gloc3d_tpu_torch.ops.topk import l2_topk
    from gloc3d_tpu_torch.pipeline import GlobalLocalizer

    n = cfg.voxel.max_points
    pts, mask = bench_query_scan(n)
    det = GlobalLocalizer(cfg, loc.model, device=torch.device("cuda"))
    det.bank.add(np.random.RandomState(0).randn(10000, cfg.index.dim)
                 .astype(np.float32))
    detect = host_ms(torch, lambda: det.detect(pts, mask), 20)

    # host half (stats + sort + BEV) and device half (forward + top-20)
    vc = cfg.voxel
    counts = np.asarray(mask.sum(axis=1), np.int64)
    t0 = time.perf_counter()
    for _ in range(5):
        host = native.compute_voxel_stats_host_sorted(
            pts, counts, vc.xbound, vc.ybound, vc.zbound, crop=False,
            per_point=True)
        native.compute_bev_host(pts, counts, cfg.bev)
    host_pass = (time.perf_counter() - t0) / 5 * 1e3
    d = [torch.from_numpy(a).cuda() for a in host]
    bank = det.bank.data

    def fwd_topk():
        with torch.no_grad():
            desc = det.model(d[0], d[1], voxel_stats=tuple(d[2:]))
            return l2_topk(desc, bank, cfg.index.top_k)

    dev_detect = cuda_ms(torch, fwd_topk, 20)
    print(f"[timing] detect at bench.py's shape (122480-point pad, 10000 x "
          f"{cfg.index.dim} bank, top-{cfg.index.top_k}) on {card}: "
          f"end to end {detect:.3f} ms (host clock, median of 20); host "
          f"stats + BEV pass {host_pass:.3f} ms; device forward + top-k "
          f"{dev_detect:.3f} ms (CUDA events)")

    locate = host_ms(torch, lambda: [loc.locate(*q) for q in qs], 3) / len(qs)
    _, _, bev, _ = loc.detect(qs[0][0][None], qs[0][1][None])
    rows = np.arange(cfg.index.top_k) % len(loc.keyframes)
    m1 = cuda_ms(torch, lambda: loc._match(bev.image[0], bev.origin_xy[0],
                                           rows[:1]), 5)
    mk = cuda_ms(torch, lambda: loc._match(bev.image[0], bev.origin_xy[0],
                                           rows), 3)
    print(f"[timing] located query (16 keyframes, staged first) on {card}: "
          f"{locate:.3f} ms per query (host clock, {len(qs)} queries x 3); "
          f"registration K=1 {m1:.3f} ms, K={cfg.index.top_k} {mk:.3f} ms "
          f"(CUDA events around the call: candidate upload and host gaps "
          f"included)")


def main() -> int:
    import torch

    name, card = phase_device(torch)
    sys.path.insert(0, REPO)
    from gloc3d_tpu_torch import PipelineConfig

    cfg = PipelineConfig.s2s()
    cfg = cfg.replace(model=cfg.model.replace(fold_bn=True))
    phase_build()
    world = make_world()
    k1_err, k1_ms, k1_plain_ms = phase_k1(torch, cfg, world, card)
    loc, kf, qs, launches = phase_located_query(torch, cfg, world)
    phase_reference(torch, cfg, kf, qs)
    phase_timing(torch, cfg, loc, qs, card)
    print(json.dumps({"kernels": [{
        "name": "segment_sum_sorted", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": launches,
        "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
