#!/usr/bin/env python3
"""Drive the PyTorch port's s2s and i2i located queries, the refinement
stage, the SLAM submap, s2s, i2i and pose training, the packed and
pillar-sorted PointPillar and the evaluator over a dataset read from disk
once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. the card (torch's name, and nvidia-smi's name and power limit);
  2. build kernels K1 (csrc/segment_sum.cu) and K2 (csrc/pillar_bin_sums.cu)
     from the checkout, one nvcc each, started together, and the port's host
     pass (gloc3d_tpu_torch/native/scan_loader.cpp, g++); any build failure
     fails the smoke;
  3. K1 against its plain PyTorch version on the card: the main-path shape
     with real `starts` from the host pass, pillar 0 holding > 50k rows,
     empty segments, every row in one segment (segment 0, a middle one),
     batch 3 with different `starts` per item, and C in {2, 4, 62, 66,
     256} (C=4: PointPillarSorted's statistics payload);
     error relative to per-segment L1 mass (bound 1e-5), empty segments
     exactly 0; CUDA-event times of both at the main-path shape; pillar 0
     bit-equal over four launches on the main-path input;
  4. K2 against its plain version on the card, on the inputs the
     all-device path gives it for a real scan before and after alignment
     ((1, 122480, 4) pillar statistics with counts, (1, 122480, 64) PointNet
     features), pillar 0 holding > 80k rows, every row in pillar 0, empty
     pillars, C in {1, 3, 4, 65, 256} on the scan's ids and features at a
     4-byte offset; error relative to per-pillar L1 mass (bound 1e-5),
     counts exactly equal, empty pillars exactly 0; CUDA-event times of
     both; pillar 0 bit-equal over four launches on each main-path input;
  5. the located query on the host-stats path at full PipelineConfig.s2s()
     width (122 480-point scans, 768² BEV, top-20, 120 coarse / 11 fine
     rotations) with the folded bf16 serving model from the port's seeded
     init (NetVLAD clusters initialised from local features, see
     vlad_centroids): 16 keyframes and 8 `locate` queries in a synthetic
     walled world;
     every query must succeed within 1 m and 5° of the ground-truth pose
     relative to the keyframe it returns, K1 must have launched on that
     path, and one query is checked against the same code on the CPU;
  6. the gravity-aligned located query on the all-device path
     (align_ground=True, host_stats=False; 4096-candidate, 256-hypothesis
     ground RANSAC): 16 keyframes on a 0.75 m grid and 8 queries, scans
     tilted by up to 3° in roll and pitch at sensor heights of 1.6-1.9 m
     (the layout is explained at aligned_world_scans); every query must
     localize within 1 m / 5° of the 6-DoF ground truth with |dz| < 0.3 m,
     every keyframe height must come back within 0.15 m, and K2 must have
     launched twice per keyframe batch and per query;
  7. the same queries with align_ground=True, host_stats=True against
     host_stats=False, both with the fp32 model: same keyframe, pose within
     0.2 m / 0.5°, K1 launched;
  8. one aligned query on the card against the same port code on the CPU
     (fp32, TF32 off, the same draws): same ground transform, equal BEV,
     descriptors within atol 2e-4 + rtol 2e-3, same keyframe;
  9. the serving path, fast_match(fm=True) with the device keyframe store
     and no host mirror: locate_fused on the host-stats map of phase 5
     (K1 launches counted) and on the aligned map of phase 6 (K2 launches
     counted), every query held to that phase's gates (a failing query's
     BEVs go to smoke_out/); locate = locate_batch = locate_fused on the
     fp32 host-stats map (success, keyframe, candidates equal, (dx, dy,
     yaw) within 1e-4) and locate = locate_fused on the aligned map with
     the same draws; bench.py's fused cells (10 000-row bank with the
     real descriptor at row 5 000, a 10 000-row store, bf16, fold_bn),
     host stats and aligned all-device: row 5 000 found, per-query host
     clock of locate_fused and locate, host syncs per call, a traced
     locate_fused's device busy time, and registration at K=1 and K=20
     with the fm preset and the default matcher (CUDA events and device
     busy time); one fm-preset locate_fused query card vs CPU (fp32, same
     keyframe, (dx, dy) within one 0.4 m fine cell, yaw within one bin);
 10. [map-scale], tools/bench_bank.py's settings: 1 000 000 unit-norm rows
     at D = 128 and 512, top-20, a planted near-duplicate of row 123, on
     the flat fp32 and int8 banks and the IVF index with fp32 and int8
     cells (1024 cells of 2048 rows, nprobe 32, the quantizer trained on
     65 536 rows): build times, device bytes, per-query times at Q = 1 and
     8 split into the distance pass and the selection beside the bound
     (bytes read / 3.35 TB/s), the two int8 products and torch.topk beside
     the stable sort; the planted row at rank 1, int8 rank 1 = fp32 rank 1,
     IVF at full probe = flat, exclude_after, one IVF query card = CPU on
     one loaded layout, int8 and IVF save / load on the card;
 11. [city], tools/bench_city.py's map: 100 000 keyframes on the IVF +
     int8 bank (1024 cells, nprobe 32) with the device store and no host
     mirror, host stats, the fm preset, bench.py's scan planted at row
     50 000: locate_fused returns and registers it; per-query time beside
     the 10 000-row flat fused cell's, device bytes, build time;
 12. timings with the card's name and power limit: detect at bench.py's
     shape and the located query, host-stats and all-device (the default); the aligned detect and locate,
     the aligned stage split, and the device's idle share over one aligned
     query from a torch.profiler trace;
 13. the i2i path at PipelineConfig.i2i() (VGG16 + NetVLAD-FC, 64 clusters x
     512, FC 32 768 → 512, bf16, 768² BEV; seeded weights, NetVLAD
     initialised from the VGG feature maps of the aligned map's db BEVs):
     a. bench.py's i2i cell: detect (forward + top-20 over a random
        10 000 x 512 bank) per query at B=1 and B=8 (CUDA events), the
        forward's FLOPs from its conv shapes, achieved TFLOP/s and
        i2i_forward_mfu against 989 TFLOP/s dense bf16, a traced detect's
        device busy time, kernel count and device time by class;
     b. the paper's configuration, align_ground=True on the tilted map of
        phase 6 (16 keyframes, 8 queries) held to its gates, per-query
        time, its stages and the idle share;
     c. image inputs on the serving configuration (fast_match(fm=True),
        device store, no host mirror): the located world's BEVs rendered
        by the port as (B, S, S, 3) images with origins, image queries
        held to phase 5's gates; locate = locate_fused (bf16) and locate
        = locate_batch = locate_fused (fp32: same db_index and candidate
        set, (dx, dy, yaw) within 1e-4); per-query time, host syncs;
     d. card vs CPU, fp32 with TF32 off in cuDNN and matmul: one 768²
        forward (relative L2 error of the descriptor, limit 1e-3) and one
        aligned i2i located query (same keyframe, pose within 1e-3 m);
 14. training at full width on each path, all-device then host-stats (24 db
     + 8 query scans, init_vlad_from_data, the default step of 24 clouds):
     one epoch with K1 / K2 launch and backward counts, a finite loss, a
     nonzero gradient for every encoder parameter and changed parameters;
     every kernel launch of one cache batch and one step held to its plain
     version; step and cache-refresh times, peak memory, a traced step;
 15. both kernels' autograd Functions against autograd through the plain
     versions at (24, 122480, 64): forward (bound 1e-5 of L1 mass), gradient
     (bound 1e-6), backward times;
 16. one fp32 step on each path, card against CPU at a 16 384-point pad:
     loss within rtol 1e-4, gradients within twice the CPU's own floor
     (mkldnn convolutions off against on);
 17. each kernel alone at the main path's and the train step's shapes: its
     device time from torch.profiler (L2-warm and L2-flushed), its bound,
     the wrapper's time (K2's with and without its id-range check, and the
     check alone), the plain version's, and the time of the one PyTorch
     call computing the same function (K1: torch.segment_reduce; K2:
     index_add_ + bincount).
 18. [refine], after the i2i phases: (a) the ICP polish
     (match.refine_icp, 4096-point clouds, 10 iterations, 1 m gate) at
     full width with the fp32 serving model on the host-stats located map
     (16 keyframes, 8 queries: the located gates, the mean position error
     at most the unrefined map's, locate = locate_batch, match_keyframe on
     the host mirror and on the device store = locate for the keyframe
     locate returns, K1 launches) and with the bf16 model on the aligned
     all-device map (6-DoF gates, mean 6-DoF position error at most the
     aligned phase's, K2 launches); one refined query card vs CPU and the
     ICP alone on the same clouds and seed; (b) the port's SLAM example
     (gloc3d_tpu_torch/examples/slam_session.py) at its default size: no
     closure on lap 1, lap 2 within 1 m / 5°; (c) tools/bench_refine.py's
     five rows at its shapes (icp_point_to_point 4096 vs 4096, 20
     iterations; refine_match_icp on two 768² BEVs; build_ndt_grid_3d
     into 100x100x12 at 1 m; ndt_refine_3d, 35 iterations;
     ergodic_rp_sweep_match, 49 BEVs at 768², fm preset) and
     contour_virtual_cloud on a 768² BEV: CUDA-event ms, a traced call's
     busy ms, idle share and kernels, host syncs per call, card vs CPU
     within stated bounds; the connected-components sweeps at 768².
 19. [submap], after [refine], at tools/bench_submap.py's shapes
     (BEVConfig(z_min=-4, z_max=4), ±100 m: the high grid 1000x1000x40 at
     0.2 m, the low 400x400x16 at 0.5 m): ten 122 480-pad sweeps of the
     walled world from (1.5 i, 0.4 i) m at yaw 0.06 i, i < 10; ms per
     dual-grid Submap3D.insert (a world sweep and bench.py's scan) and host
     syncs; project_to_bev of the 10-sweep high grid to 768²; one sweep's
     insert and projection card vs CPU, bit-equal; match_scan and
     match_scan_fast on the 512² centre crop with sweep 0's 4096-point
     virtual scan at R = 64, 256 and the local R = 32 ±0.15 rad (a
     certified fast result must be the exhaustive optimum), match_scan at
     R = 64 card vs CPU (the same optimum); fast against exhaustive at the
     Olson-bound R on bench_submap.py's offset query (4.0, -2.0, 0.35 rad,
     σ 0.10 m); match_full_submap(fallback="full") and cmd_match_submap's
     composition (scan_to_bev → bev_to_virtual_points →
     match_full_submap) recovering that offset within one cell and one
     angular step; cuFFT against float64 direct sums (fine and coarse
     FFT) below the certificate's 0.05-count slack.
 20. [i2i-train], after training: PipelineConfig.i2i() (VGG16 +
     NetVLAD-FC, bf16) at 768² on the training world's BEVs rendered by the
     port (24 db, 8 queries; margin 10 so that every batch takes a step),
     NetVLAD from init_vlad_from_data, the reference's freeze mask
     (models/encoders.py::train_mask): one epoch (the loss finite, every
     trainable parameter with a nonzero gradient and moved, every frozen
     one bit-unchanged), two timing epochs (median warm step, cache refresh
     per image, peak memory, the step's conv FLOPs against 989 TFLOP/s);
     one fp32 step card vs CPU at a 128² crop (loss rtol 1e-4, gradients
     within twice the CPU's mkldnn-on-vs-off floor); one step each of
     AlexNet, MobileNetV2 and ResNet18 under their masks;
 21. [pose-train]: make_pose_model(PipelineConfig.s2s()) at the 140 x 80
     grid, 4 walled-world scan pairs at the 122 480 pad with their
     relative pose as gt, Adam 1e-3, 25 steps on the fixed batch: JAX's
     criterion (min < 0.7 x the largest of the first three losses), K2
     launches and backward calls counted, every K2 launch of one step
     against its plain version, one fp32 step card vs CPU at a 16 384-point
     pad, predict_pose (4, 6) and finite; step ms, peak memory;
 22. [packed]: one full-pad scan through PointPillar (K2),
     PointPillarPacked (pack_points, K2) and PointPillarSorted (the host
     pass, K1 on the 4-channel payload and the 64-channel features) from
     one fp32 state dict: pillar means within 1e-5 and outputs within 1e-4
     of PointPillar's largest; forward times, launches.
 23. [eval], after [submap]: one KITTI odometry sequence written into a
     temporary directory (sequences/08/velodyne/NNNNNN.bin, poses/08.txt,
     calib.txt): 50 walled-world scans at the 122 480-point pad, 2 m
     apart with yaw changes, cam0 poses written through a non-identity Tr;
     generate_split (40 db, 10 queries) and load_split_scans through the
     port's native loader, the scans bit-equal to the written ones and the
     velodyne poses within 1e-5; one more query, 140 m from every frame;
     evaluate_split (batch 8, recall@{1, 5, 10, 20}) with the folded bf16
     model on the host-stats path (K1) and the aligned all-device path
     (K2): the full EvalReport, K1 / K2 launches, every launch of one
     evaluator batch against its plain version (bound 1e-5 of L1 mass),
     gates: (a) on the fp32 host-stats map the evaluator's per-query
     results = locate's query by query, (b) num_total = 11, success rate
     and recall@5 at least 2/3, mean position error below 1 m, (c) the far
     query a failed registration with its overlay rendered (a PNG only
     where matplotlib is installed), npz dumps exactly for the failed
     detections, the failed-index files written, (d) the CPU's fp32 run
     on the first 16 db and 4 queries = the card's (candidates,
     successes, failed indices; errors within 1e-3 m / 1e-3 rad); db
     build per scan, locate per query, p50 / p95 beside the card's name
     and power limit.
The kernel-only times of phase 17 come from complete traces only (both
kernels of every traced call); a timing with none in six traces prints
that it was not measured.
`python3 chip_smoke.py --kernels` runs phases 1-4 and 17 only;
`python3 chip_smoke.py --submap` phases 1 and 19 only;
`python3 chip_smoke.py --eval` phases 1, 2 and 23 only;
`--i2i-train`, `--pose-train` and `--packed` run phases 1, 2 and the
phase (or phases) named, alone;
`--seed N` seeds the map-scale rows (default 0).
The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero before those.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
K1_SOURCE = "gloc3d_tpu_torch/csrc/segment_sum.cu"
K1_REPLACES = "gloc3d_tpu/ops/pallas_scatter.py:106"
K2_SOURCE = "gloc3d_tpu_torch/csrc/pillar_bin_sums.cu"
K2_REPLACES = "gloc3d_tpu/ops/pallas_scatter.py:45"
N_KEYFRAMES, N_QUERIES = 16, 8
N_TRAIN_Q = 8  # training queries; 24 db scans (training_dataset)
POS_TOL_M, ROT_TOL_DEG = 1.0, 5.0
MAX_TILT, HEIGHTS = math.radians(3.0), (1.6, 1.9)
DZ_TOL_M, HEIGHT_TOL_M = 0.3, 0.15


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


def rpy_matrix(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """Rz(yaw)·Ry(pitch)·Rx(roll), the convention of quat_from_rpy."""
    cr, sr, cp, sp = math.cos(roll), math.sin(roll), math.cos(pitch), \
        math.sin(pitch)
    cy, sy = math.cos(yaw), math.sin(yaw)
    return np.array([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr]])


def tilted_scan_at(world: np.ndarray, pose, attitude, n_pad: int, seed: int,
                   view_radius: float = 70.0, n_ground: int = 40000):
    """Observe the world from a sensor at (x, y, yaw) with (roll, pitch,
    height): walls within range standing on the ground plane z = 0 plus a
    sensor-centred ground ring, in the sensor frame (world → sensor by the
    inverse attitude), shuffled and padded to n_pad rows of (x, y, z,
    intensity)."""
    x, y, yaw = pose
    roll, pitch, height = attitude
    rng = np.random.RandomState(seed)
    rel = world[:, :2] - np.array([x, y], np.float32)
    keep = np.linalg.norm(rel, axis=1) < view_radius
    walls = np.concatenate([rel[keep], world[keep, 2:3]], 1)
    r = rng.uniform(3.0, 40.0, n_ground)
    th = rng.uniform(0, 2 * np.pi, n_ground)
    ground = np.stack([r * np.cos(th), r * np.sin(th),
                       np.zeros(n_ground)], 1)
    pts = np.concatenate([walls, ground]).astype(np.float64)
    pts[:, 2] -= height
    pts = (pts @ rpy_matrix(roll, pitch, yaw)).astype(np.float32)
    pts = pts[rng.permutation(len(pts))][:n_pad]
    out = np.zeros((n_pad, 4), np.float32)
    out[: len(pts), :3] = pts
    out[: len(pts), 3] = rng.uniform(0, 1, len(pts))
    mask = np.zeros(n_pad, np.float32)
    mask[: len(pts)] = 1.0
    return out, mask


def pose6(torch, pose, attitude):
    """World pose of a tilted sensor as the port's Rigid3."""
    from gloc3d_tpu_torch.core.transforms import Rigid3, quat_from_rpy

    x, y, yaw = pose
    roll, pitch, height = attitude
    q = quat_from_rpy(*(torch.tensor(float(a), dtype=torch.float64)
                        for a in (roll, pitch, yaw)))
    return Rigid3(q, torch.tensor([x, y, height], dtype=torch.float64))


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
    from gloc3d_tpu_torch.data import native
    from gloc3d_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.load_all()
    took = time.perf_counter() - t0
    for name, source in (("segment_sum", K1_SOURCE),
                         ("pillar_bin_sums", K2_SOURCE)):
        regs = [ln.split(":", 1)[1].strip() for ln in build.build_log.get(
            name, "").splitlines() if "registers" in ln]
        print(f"[build] {source}: nvcc "
              f"{build.build_seconds.get(name, 0.0):.2f} s; ptxas: "
              f"{' | '.join(regs) or 'cached build'}")
    print(f"[build] both kernels built and loaded in {took:.2f} s "
          f"(one nvcc each, started together)")
    t0 = time.perf_counter()
    try:
        native.load_library()
    except RuntimeError as e:
        raise SmokeFailure(f"the port's host pass did not build: {e}")
    print(f"[build] host pass gloc3d_tpu_torch/native/scan_loader.cpp: "
          f"built and loaded in {time.perf_counter() - t0:.2f} s "
          f"({os.path.relpath(native.library_path(), REPO)})")


def phase_k1(torch, cfg, world, card):
    from gloc3d_tpu_torch.data import native
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
    other = scan_at(world, (20.0, -10.0, 1.0), n, seed=3)
    ids = torch.tensor([1, 1, 2, 2, 2, 4, 4, 9], device=dev)
    main_starts = host_starts(full[0][None], full[1][None])
    v = main_starts.shape[-1] - 1

    def one_segment(k):  # every row in segment k
        st = torch.full_like(main_starts, n)
        st[0, :k + 1] = 0
        return st

    def rand(b, c, rows=n):
        return torch.randn((b, rows, c), generator=gen, device=dev)

    main_x = rand(1, 64)
    cases = {
        "main path (1, 122480, 64)": (main_x, main_starts),
        "pillar 0 > 50k rows": (rand(1, 64), host_starts(sparse[0][None],
                                                         sparse[1][None])),
        "empty segments (8, 64), V=12": (rand(1, 64, 8), torch.searchsorted(
            ids, torch.arange(13, device=dev)).int()[None]),
        "every row in segment 0 (1, 122480, 64)": (rand(1, 64),
                                                   one_segment(0)),
        f"every row in segment {v // 2} (1, 122480, 64)": (
            rand(1, 64), one_segment(v // 2)),
        "batch 3, different starts (3, 122480, 64)": (
            rand(3, 64), host_starts(*(np.stack(a) for a in zip(
                full, sparse, other)))),
    }
    for c in (2, 4, 62, 66, 256):  # C=4: PointPillarSorted's payload
        cases[f"C={c} (1, 122480, {c}), the scan's starts"] = (
            rand(1, c), main_starts)
    worst, main_err = 0.0, None
    for label, (x, starts) in cases.items():
        rel, err = check_k1(torch, label, x, starts)
        empty = int((starts[..., 1:] == starts[..., :-1]).sum())
        p0 = (starts[..., 1] - starts[..., 0]).tolist()
        print(f"[k1] {label}: pillar-0 rows {p0}, empty segments "
              f"{empty}, max |kernel - plain| {err:.3e}, relative to "
              f"per-segment L1 mass {rel:.3e} (bound 1e-5)")
        worst = max(worst, rel)
        if main_err is None:
            main_err = err
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
    return main_err, float(k[1]), float(p[1]), (main_x, main_starts)


def check_k1(torch, label, x, starts):
    """Launch K1 on (x, starts) and hold it to its plain version: finite,
    empty segments exactly 0. Returns (max error relative to per-segment L1
    mass, max |kernel - plain|)."""
    from gloc3d_tpu_torch.kernels import segment_sum as ss

    got = ss.segment_sum_sorted(x, starts)
    torch.cuda.synchronize()
    plain = ss.segment_sum_sorted_plain(x, starts)
    l1 = ss.segment_sum_sorted_plain(x.abs(), starts).double()
    diff = (got - plain).double().abs()
    check(bool(torch.isfinite(got).all()), f"K1 {label}: non-finite")
    empty = starts[..., 1:] == starts[..., :-1]
    check(bool((got[empty] == 0).all()),
          f"K1 {label}: empty segments not zero")
    return (float((diff / l1.clamp_min(1e-30)).max()),
            float(diff.max()))


def check_k2(torch, label, x, ids, nv):
    """Launch K2 on (x, ids, V) and hold it to its plain version: finite,
    counts exactly equal, empty pillars exactly 0. Returns (max error
    relative to per-pillar L1 mass, max |kernel - plain|, plain counts)."""
    from gloc3d_tpu_torch.kernels import bin_sums as bs

    got, cnt = bs.pillar_bin_sums(x, ids, nv)
    torch.cuda.synchronize()
    plain, p_cnt = bs.pillar_bin_sums_plain(x, ids, nv)
    l1, _ = bs.pillar_bin_sums_plain(x.abs(), ids, nv)
    diff = (got - plain).double().abs()
    check(bool(torch.isfinite(got).all()), f"K2 {label}: non-finite")
    check(torch.equal(cnt, p_cnt), f"K2 {label}: counts differ")
    check(bool((got[p_cnt == 0] == 0).all()),
          f"K2 {label}: empty pillars not zero")
    return (float((diff / l1.double().clamp_min(1e-30)).max()),
            float(diff.max()), p_cnt)


def record_launches(fn):
    """Run fn() and return copies of the arguments of every K1 and K2
    launch it made: {"K1": [(values, starts)], "K2": [(features, ids, V)]},
    whether through a plain wrapper or an autograd Function (the kernels
    still run; outside any counted window)."""
    from gloc3d_tpu_torch.kernels import bin_sums, segment_sum

    targets = {"K1": (segment_sum, "_launch"), "K2": (bin_sums, "_launch")}
    calls = {key: [] for key in targets}
    real = {key: getattr(mod, attr) for key, (mod, attr) in targets.items()}

    def recorder(key):
        def launch(*args):
            calls[key].append(tuple(
                a.detach().clone() if hasattr(a, "detach") else a
                for a in args))
            return real[key](*args)
        return launch

    for key, (mod, attr) in targets.items():
        setattr(mod, attr, recorder(key))
    try:
        fn()
    finally:
        for key, (mod, attr) in targets.items():
            setattr(mod, attr, real[key])
    return calls


def phase_k2(torch, cfg, world, card, centroids):
    from gloc3d_tpu_torch.kernels import bin_sums as bs
    from gloc3d_tpu_torch.pipeline import GlobalLocalizer

    dev = torch.device("cuda")
    n = cfg.voxel.max_points
    pts, mask = tilted_scan_at(world, (1.0, -2.0, 0.5), (0.03, -0.04, 1.75),
                               n, seed=5)
    # the fp32 model: full fp32 features, not bf16 values that sum exactly
    model = build_serving_model(torch, cfg, "float32", centroids)
    inputs, main_path = {}, {}
    for aligned in (False, True):
        loc = GlobalLocalizer(cfg, model, device=dev, host_stats=False,
                              align_ground=aligned)
        calls = record_launches(
            lambda: loc.extract(pts[None], mask[None]))["K2"]
        check(len(calls) == 2, f"K2 called {len(calls)} times per scan")
        tag = "aligned" if aligned else "raw"
        inputs[f"statistics (1, {n}, 4), {tag} scan"] = calls[0]
        inputs[f"features (1, {n}, 64), {tag} scan"] = calls[1]
        main_path = {"statistics": calls[0], "features": calls[1]}
    feats, ids, v = main_path["features"]
    gen = torch.Generator(device=dev).manual_seed(0)
    crowded = ids.clone()
    extra = torch.randperm(n, generator=gen, device=dev)[:90000]
    crowded[0, extra] = 0  # spread through the scan, as out-of-grid rows are
    small_ids = torch.tensor([[1, 1, 2, 2, 2, 4, 4, 9]], dtype=torch.int32,
                             device=dev)
    inputs["pillar 0 > 80k rows (1, 122480, 64)"] = (
        torch.randn(feats.shape, generator=gen, device=dev), crowded, v)
    inputs["empty pillars (1, 8, 64), V=12"] = (
        torch.randn((1, 8, 64), generator=gen, device=dev), small_ids, 12)
    inputs["every row in pillar 0 (1, 122480, 64)"] = (
        torch.randn(feats.shape, generator=gen, device=dev),
        torch.zeros_like(ids), v)
    for c in (1, 3, 4, 65, 256):
        inputs[f"C={c} (1, {n}, {c}), the scan's ids"] = (
            torch.randn((1, n, c), generator=gen, device=dev), ids, v)
    # rows that are not 16-byte aligned: the scalar-load specialisations
    odd = torch.empty(feats.numel() + 1, device=dev)[1:].view(feats.shape)
    odd.copy_(feats)
    inputs["features at a 4-byte offset (1, 122480, 64)"] = (odd, ids, v)

    worst, main_err = 0.0, None
    for label, (x, i, nv) in inputs.items():
        rel, err, p_cnt = check_k2(torch, label, x, i, nv)
        print(f"[k2] {label}: pillar-0 rows {int(p_cnt[0, 0])}, empty "
              f"pillars {int((p_cnt == 0).sum())} of {nv}, counts equal, max "
              f"|kernel - plain| {err:.3e}, relative to per-pillar L1 mass "
              f"{rel:.3e} (bound 1e-5)")
        worst = max(worst, rel)
        if label.startswith("pillar 0"):
            check(int(p_cnt[0, 0]) > 80000, "the crowded case has <= 80k "
                  "rows in pillar 0")
        if x is main_path["features"][0]:
            main_err = err
    check(worst < 1e-5, f"K2 disagrees with its plain version: {worst:.3e}")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    times = {}
    for label in ("statistics", "features"):
        x, i, nv = main_path[label]
        per = {}
        for kind, fn in (("plain", bs.pillar_bin_sums_plain),
                         ("kernel", bs._launch), ("kernel", bs._launch),
                         ("plain", bs.pillar_bin_sums_plain)):
            warm = cuda_ms(torch, lambda: fn(x, i, nv), 50)
            cold = cuda_ms(torch, lambda: fn(x, i, nv), 20, flush)
            per.setdefault(kind, []).append((warm, cold))
        wrapper = cuda_ms(torch, lambda: bs.pillar_bin_sums(x, i, nv), 50)
        k = np.mean(per["kernel"], axis=0)
        p = np.mean(per["plain"], axis=0)
        times[label] = (float(k[1]), float(p[1]))
        print(f"[k2] time, {label} {tuple(x.shape)} of the aligned scan, on "
              f"{card}: kernel {k[0]:.4f} ms L2-warm / {k[1]:.4f} ms "
              f"L2-flushed; plain {p[0]:.4f} / {p[1]:.4f} ms (order plain, "
              f"kernel, kernel, plain); wrapper with its id-range check "
              f"{wrapper:.4f} ms L2-warm")
    return main_err, times["features"][0], times["features"][1], main_path


def check_k1_pillar0_determinism(torch, x, starts):
    """Four launches on the main path's input give bit-equal pillar-0 rows
    (K1 adds the partials of blocks inside one segment in a fixed order).
    Returns whether they did."""
    from gloc3d_tpu_torch.kernels import segment_sum as ss

    first = ss.segment_sum_sorted(x, starts)[..., 0, :]
    same = all(torch.equal(first, ss.segment_sum_sorted(x, starts)[..., 0, :])
               for _ in range(3))
    print(f"[k1] main path {tuple(x.shape)}: pillar 0 over four launches "
          f"bit-equal {same} ({int(starts[0, 1] - starts[0, 0])} rows)")
    check(same, "K1: pillar 0 differs between launches")
    return same


def check_k2_pillar0_determinism(torch, main_path):
    """Two launches on the same input give bit-equal pillar-0 rows (and
    counts): K2 sums pillar 0 through per-block partials in a fixed order.
    Run on both of the main path's binnings."""
    from gloc3d_tpu_torch.kernels import bin_sums as bs

    for label, (x, ids, v) in main_path.items():
        first = bs.pillar_bin_sums(x, ids, v)
        same = all(
            torch.equal(first[0][..., 0, :], again[0][..., 0, :])
            and torch.equal(first[1], again[1])
            for again in (bs.pillar_bin_sums(x, ids, v) for _ in range(3)))
        print(f"[k2] {label} {tuple(x.shape)}: pillar 0 over four launches "
              f"bit-equal {same} ({int(first[1][..., 0].sum())} rows)")
        check(same, f"K2 {label}: pillar 0 differs between launches")


def seeded_standard_model(torch, cfg, dtype: str):
    """The port's seeded init with non-trivial BatchNorm statistics (so
    that folding matters), BatchNorms unfolded, in eval mode."""
    from gloc3d_tpu_torch.models.descriptor import build_model, init_params

    std = init_params(build_model(
        cfg.model.replace(fold_bn=False, compute_dtype=dtype), cfg.voxel),
        seed=0)
    with torch.no_grad():
        g = torch.Generator().manual_seed(1)
        for m in std.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.copy_(0.1 * torch.randn(
                    m.running_mean.shape, generator=g))
                m.running_var.uniform_(0.5, 2.0, generator=g)
    return std.eval()


def vlad_centroids(torch, cfg, scans, device="cuda", seed=0):
    """NetVLAD's data init, as the reference initialises its clusters from
    local features: K normalised local features of the seeded fp32 encoder,
    sampled from the feature maps of ``scans``. The seeded init's
    centroids (uniform in [0, 1)) dwarf the unit-norm features, so every
    scan's descriptor is nearly the same (distances² ~1e-6) and retrieval
    would rank keyframes by rounding noise."""
    model = seeded_standard_model(torch, cfg, "float32").to(device)
    with torch.no_grad():
        feats = model.encoder(
            torch.from_numpy(np.stack([s[0] for s in scans])).to(device),
            torch.from_numpy(np.stack([s[1] for s in scans])).to(device))
    f = torch.nn.functional.normalize(
        feats.reshape(-1, feats.shape[-1]).float(), dim=-1).cpu()
    pick = torch.randperm(f.shape[0], generator=torch.Generator(
    ).manual_seed(seed))[: cfg.model.num_clusters]
    return f[pick]


def build_serving_model(torch, cfg, dtype: str, centroids=None,
                        alpha: float = 30.0):
    """The folded serving model from the port's seeded init: seed the
    standard model, give NetVLAD ``centroids`` (and assignment weights
    alpha·centroids) where given, fold its BatchNorms, load into the
    fold_bn=True model."""
    from gloc3d_tpu_torch.convert import fold_batch_norm
    from gloc3d_tpu_torch.models.descriptor import build_model

    std = seeded_standard_model(torch, cfg, dtype)
    if centroids is not None:
        with torch.no_grad():
            std.pool.centroids.copy_(centroids)
            std.pool.conv.weight.copy_(alpha * centroids[:, :, None, None])
    served = build_model(cfg.model.replace(fold_bn=True, compute_dtype=dtype),
                         cfg.voxel)
    served.load_state_dict(fold_batch_norm(std.state_dict()))
    return served.eval()


def build_map(torch, cfg, model, kf, device="cuda", **kw):
    """A GlobalLocalizer on ``device`` with its map built from the scans
    ``kf`` in batches of 4."""
    from gloc3d_tpu_torch.pipeline import GlobalLocalizer

    loc = GlobalLocalizer(cfg, model, device=torch.device(device), **kw)
    for i in range(0, len(kf), 4):
        loc.add_keyframes(np.stack([k[0] for k in kf[i:i + 4]]),
                          np.stack([k[1] for k in kf[i:i + 4]]))
    return loc


def located_world_scans(world, n: int):
    """16 keyframes on a 5 m grid with random headings and 8 queries
    within it at random headings: ((poses, scans) of the keyframes, (poses,
    scans) of the queries)."""
    rng = np.random.RandomState(7)
    grid = np.linspace(-7.5, 7.5, 4)
    kf_poses = [(x, y, rng.uniform(-np.pi, np.pi)) for x in grid
                for y in grid]
    q_poses = [(rng.uniform(-6, 6), rng.uniform(-6, 6),
                rng.uniform(-np.pi, np.pi)) for _ in range(N_QUERIES)]
    kf = [scan_at(world, p, n, seed=100 + i) for i, p in enumerate(kf_poses)]
    qs = [scan_at(world, p, n, seed=200 + i) for i, p in enumerate(q_poses)]
    return (kf_poses, kf), (q_poses, qs)


def check_located(tag, results, kf_poses, q_poses, top_k):
    """Every result localized within POS_TOL_M / ROT_TOL_DEG of the
    ground-truth 2-D pose relative to the keyframe it returns."""
    worst_pos = worst_rot = 0.0
    for i, (res, qp) in enumerate(zip(results, q_poses)):
        check(res.success, f"{tag} query {i} did not localize "
              f"(score {res.match_score:.3f})")
        check(len(res.candidates) == top_k, "top-k length")
        t_gt, yaw_gt = relative_pose(kf_poses[res.db_index], qp)
        q = res.pose.rotation
        yaw = 2.0 * math.atan2(q[3], q[0])
        pos_err = float(np.linalg.norm(res.pose.translation[:2] - t_gt))
        rot_err = abs(math.degrees(math.remainder(yaw - yaw_gt, 2 * math.pi)))
        worst_pos, worst_rot = max(worst_pos, pos_err), max(worst_rot,
                                                            rot_err)
        print(f"[{tag}] query {i}: db {res.db_index} (top-1 "
              f"{res.candidates[0]}), score {res.match_score:.3f}, "
              f"error {pos_err:.3f} m / {rot_err:.3f} deg")
        check(pos_err < POS_TOL_M and rot_err < ROT_TOL_DEG,
              f"{tag} query {i}: pose error {pos_err:.3f} m / "
              f"{rot_err:.3f} deg")
    print(f"[{tag}] {len(results)}/{len(results)} localized; worst error "
          f"{worst_pos:.3f} m / {worst_rot:.3f} deg "
          f"(bound {POS_TOL_M} m / {ROT_TOL_DEG} deg)")


def phase_located_query(torch, cfg, lq_set, centroids, device="cuda"):
    from gloc3d_tpu_torch.kernels import segment_sum as ss

    n = cfg.voxel.max_points
    (kf_poses, kf), (q_poses, qs) = lq_set
    fill = np.mean([q[1].sum() for q in qs]) / n
    print(f"[locate] {len(kf)} keyframes, {len(qs)} queries; scans fill "
          f"{fill:.1%} of the {n}-point pad; gates min_score "
          f"{cfg.match.min_score}, "
          f"min_overlap_pixels {cfg.match.min_overlap_pixels}")

    model = build_serving_model(torch, cfg, "bfloat16", centroids)
    ss.segment_sum_sorted.launches = 0
    loc = build_map(torch, cfg, model, kf, device, host_stats=True)
    results = [loc.locate(*q) for q in qs]
    launches = ss.segment_sum_sorted.launches
    print(f"[locate] K1 launches on the main path: {launches}")
    check(launches >= N_KEYFRAMES // 4 + N_QUERIES,
          f"K1 launched {launches} times on the main path")

    check(len(loc.bank) == N_KEYFRAMES, "bank size")
    descs = loc.bank.data
    check(bool(torch.isfinite(descs).all()) and descs.shape == (
        N_KEYFRAMES, cfg.index.dim), "keyframe descriptors")
    check_located("locate", results, kf_poses, q_poses, cfg.index.top_k)
    return loc, kf, qs, launches


def phase_reference(torch, cfg, kf, qs, centroids):
    """One query on the card against the same port code on the CPU (plain
    kernel versions), in fp32 with TF32 off."""
    from gloc3d_tpu_torch.pipeline import GlobalLocalizer

    out = {}
    for dev in ("cuda", "cpu"):
        model = build_serving_model(torch, cfg, "float32", centroids)
        loc = GlobalLocalizer(cfg, model, device=torch.device(dev),
                              host_stats=True)
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


def aligned_world_scans(world, n: int):
    """16 keyframes on a 0.75 m grid and 8 queries within 0.5 m of a
    keyframe, each scan with its own roll and pitch (±3°) and sensor height
    (1.6-1.9 m), all headed within ±0.3 rad of one direction.

    The map is compact because the reference's composition (kept by the
    port) takes roll, pitch and dz from the two ground frames alone: dz
    misses the db frame's tilt times the horizontal offset, and roll/pitch
    miss the heading difference. With exact estimates that alone is, over
    every query-keyframe pair of this layout, at most 0.19 m and 1.9° (at
    5 m spacing 1.2 m), and the seeded-init model retrieves no better than
    any keyframe of the map."""
    rng = np.random.RandomState(11)
    grid = np.linspace(-1.125, 1.125, 4)
    heading = 0.7

    def attitude():
        return (rng.uniform(-MAX_TILT, MAX_TILT),
                rng.uniform(-MAX_TILT, MAX_TILT), rng.uniform(*HEIGHTS))

    kf_poses = [(x, y, heading + rng.uniform(-0.3, 0.3)) for x in grid
                for y in grid]
    kf_att = [attitude() for _ in kf_poses]
    near = rng.permutation(len(kf_poses))[:N_QUERIES]
    q_poses = [(kf_poses[j][0] + rng.uniform(-0.5, 0.5),
                kf_poses[j][1] + rng.uniform(-0.5, 0.5),
                heading + rng.uniform(-0.3, 0.3)) for j in near]
    q_att = [attitude() for _ in q_poses]
    kf = [tilted_scan_at(world, p, a, n, seed=300 + i)
          for i, (p, a) in enumerate(zip(kf_poses, kf_att))]
    qs = [tilted_scan_at(world, p, a, n, seed=400 + i)
          for i, (p, a) in enumerate(zip(q_poses, q_att))]
    return (kf_poses, kf_att, kf), (q_poses, q_att, qs)


def run_aligned(torch, cfg, model, kf, qs, host_stats: bool, seed: int = 0,
                device="cuda"):
    """Build the aligned map in batches of 4 and locate every query."""
    loc = build_map(torch, cfg, model, kf, device, host_stats=host_stats,
                    align_ground=True, seed=seed)
    return loc, [loc.locate(*q) for q in qs]


def check_aligned(torch, tag, results, kf_set, q_set):
    """Every result localized in 6-DoF within POS_TOL_M / ROT_TOL_DEG of
    the ground truth relative to the keyframe it returns, |dz| < DZ_TOL_M."""
    from gloc3d_tpu_torch.eval.registration import registration_errors

    kf_poses, kf_att, _ = kf_set
    q_poses, q_att, _ = q_set
    worst = [0.0, 0.0, 0.0]
    for i, (res, qp, qa) in enumerate(zip(results, q_poses, q_att)):
        check(res.success, f"{tag} query {i} did not localize "
              f"(score {res.match_score:.3f})")
        gt = pose6(torch, kf_poses[res.db_index], kf_att[res.db_index]
                   ).inverse().compose(pose6(torch, qp, qa))
        e_pos, e_rot = (float(e) for e in registration_errors(res.pose, gt))
        dz = abs(float(res.pose.translation[2]) - float(gt.translation[2]))
        worst = [max(a, b) for a, b in zip(worst, (e_pos, e_rot, dz))]
        print(f"[{tag}] query {i}: db {res.db_index} (top-1 "
              f"{res.candidates[0]}), score {res.match_score:.3f}, 6-DoF "
              f"error {e_pos:.3f} m / {e_rot:.3f} deg, |dz error| {dz:.3f} m")
        check(e_pos < POS_TOL_M and e_rot < ROT_TOL_DEG and dz < DZ_TOL_M,
              f"{tag} query {i}: error {e_pos:.3f} m / {e_rot:.3f} deg / "
              f"dz {dz:.3f} m")
    print(f"[{tag}] {len(results)}/{len(results)} localized in 6-DoF; worst "
          f"{worst[0]:.3f} m / {worst[1]:.3f} deg, |dz| {worst[2]:.3f} m "
          f"(bounds {POS_TOL_M} m / {ROT_TOL_DEG} deg / {DZ_TOL_M} m)")


def phase_aligned_query(torch, cfg, model, kf_set, q_set):
    from gloc3d_tpu_torch.kernels import bin_sums as bs

    kf_poses, kf_att, kf = kf_set
    q_poses, q_att, qs = q_set
    print(f"[aligned] {len(kf)} keyframes, {len(qs)} queries; roll/pitch "
          f"within ±{math.degrees(MAX_TILT):.0f} deg, sensor heights "
          f"{HEIGHTS[0]}-{HEIGHTS[1]} m; ground RANSAC "
          f"{cfg.ground.num_candidates} candidates x "
          f"{cfg.ground.ransac_iters} hypotheses")
    bs.pillar_bin_sums.launches = 0
    loc, results = run_aligned(torch, cfg, model, kf, qs, host_stats=False)
    launches = bs.pillar_bin_sums.launches
    need = 2 * (len(kf) // 4 + len(qs))
    print(f"[aligned] K2 launches on the all-device aligned path: "
          f"{launches} (at least {need})")
    check(launches >= need, f"K2 launched {launches} times, < {need}")

    worst_h = 0.0
    for i, (k, att) in enumerate(zip(loc.keyframes, kf_att)):
        check(k.ground is not None, f"keyframe {i} has no ground frame")
        worst_h = max(worst_h, abs(float(k.ground.translation[2]) - att[2]))
    print(f"[aligned] keyframe heights: worst error {worst_h:.4f} m "
          f"(bound {HEIGHT_TOL_M} m)")
    check(worst_h < HEIGHT_TOL_M, f"keyframe height error {worst_h:.3f} m")

    check_aligned(torch, "aligned", results, kf_set, q_set)
    return loc, results, launches


def phase_aligned_hoststats(torch, cfg, kf_set, q_set, centroids):
    """The aligned queries through host_stats=True against host_stats=False,
    both with the fp32 model: in bf16 the two binnings' last-bit
    differences can reorder keyframes of this compact map whose
    descriptors tie within bf16 rounding."""
    from gloc3d_tpu_torch.eval.registration import registration_errors
    from gloc3d_tpu_torch.kernels import segment_sum as ss

    model = build_serving_model(torch, cfg, "float32", centroids)
    _, dev_results = run_aligned(torch, cfg, model, kf_set[2], q_set[2],
                                 host_stats=False)
    ss.segment_sum_sorted.launches = 0
    _, results = run_aligned(torch, cfg, model, kf_set[2], q_set[2],
                             host_stats=True)
    launches = ss.segment_sum_sorted.launches
    worst_t = worst_r = 0.0
    for i, (a, b) in enumerate(zip(results, dev_results)):
        check(a.success and b.success and a.db_index == b.db_index,
              f"host-stats aligned query {i}: db {a.db_index} vs "
              f"{b.db_index}")
        e_t, e_r = (float(e) for e in registration_errors(a.pose, b.pose))
        worst_t, worst_r = max(worst_t, e_t), max(worst_r, e_r)
    print(f"[aligned-host] fp32 model, host_stats=True vs False: same "
          f"keyframe for {len(results)}/{len(results)} queries; pose within "
          f"{worst_t:.4f} m / {worst_r:.4f} deg (bound 0.2 m / 0.5 deg; "
          f"0.0810 deg is the metric's arccos floor); K1 launches "
          f"{launches}")
    check(worst_t < 0.2 and worst_r < 0.5, "host-stats aligned pose differs")
    check(launches >= len(kf_set[2]) // 4 + len(results),
          f"K1 launched {launches} times on the host-stats aligned path")


def phase_aligned_reference(torch, cfg, kf_set, q_set, centroids,
                            devices=("cuda", "cpu")):
    """One aligned query on the card against the same port code on the CPU
    (plain kernel versions), fp32 with TF32 off, the same draws."""
    out = {}
    kf, qs = kf_set[2][:2], q_set[2][:1]
    for dev in devices:
        model = build_serving_model(torch, cfg, "float32", centroids)
        loc, _ = run_aligned(torch, cfg, model, kf, [], host_stats=False,
                             seed=5, device=dev)
        _, _, bev, ground = loc.detect(qs[0][0][None], qs[0][1][None])
        res = loc.locate(*qs[0])
        out[dev] = (loc, bev, ground, res)
    (l_g, b_g, g_g, r_g), (l_c, b_c, g_c, r_c) = (out[d] for d in devices)
    gq = max(float((g_g.transform.rotation.cpu()
                    - g_c.transform.rotation).abs().max()),
             float((g_g.transform.translation.cpu()
                    - g_c.transform.translation).abs().max()))
    gk = max(float(np.abs(a.ground.rotation - b.ground.rotation).max())
             for a, b in zip(l_g.keyframes, l_c.keyframes))
    same_bev = bool(torch.equal(b_g.image.cpu(), b_c.image)) and all(
        np.array_equal(a.image, b.image)
        for a, b in zip(l_g.keyframes, l_c.keyframes))
    d_g, d_c = l_g.bank.data.cpu().numpy(), l_c.bank.data.cpu().numpy()
    derr = float(np.abs(d_g - d_c).max())
    print(f"[aligned-reference] card vs CPU: ground transform max |diff| "
          f"query {gq:.2e}, keyframes {gk:.2e}; BEV images equal "
          f"{same_bev}; fp32 descriptors max |diff| {derr:.2e} (bound atol "
          f"2e-4 + rtol 2e-3); success {r_g.success}/{r_c.success}, db "
          f"{r_g.db_index}/{r_c.db_index}")
    check(same_bev, "card BEV differs from the CPU BEV")
    check(np.allclose(d_g, d_c, atol=2e-4, rtol=2e-3),
          "card descriptors disagree with the CPU reference")
    check(r_g.success == r_c.success and r_g.db_index == r_c.db_index,
          "card aligned locate != CPU aligned locate")


def serving_localizer(torch, cfg, model, kf, device="cuda", **kw):
    """The serving configuration: the fast_match(fm=True) matcher and the
    device keyframe store without a host mirror, its map built from ``kf``
    in batches of 4."""
    return build_map(torch, cfg.fast_match(fm=True), model, kf, device,
                     device_keyframes=True, host_mirror=False, **kw)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def fused_results(loc, qs, tag):
    """locate_fused on every query; where one does not localize, its BEV
    and its top candidates' BEVs (from the device store) go to
    smoke_out/ (git-ignored) for a look at the matcher there, before the
    gate fails."""
    results = [loc.locate_fused(*q) for q in qs]
    for i, (res, q) in enumerate(zip(results, qs)):
        if res.success:
            continue
        _, bev, _ = loc.extract(q[0][None], q[1][None])
        images, origins = loc._candidates(res.candidates[:3])
        out = os.path.join(REPO, "smoke_out")
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, f"fused_{tag}_query{i}.npz")
        np.savez(path, query=_host(bev.image[0]),
                 query_origin=_host(bev.origin_xy[0]),
                 candidates=res.candidates, images=_host(images),
                 origins=_host(origins))
        print(f"[fused] {tag} query {i} failed: BEVs written to "
              f"{os.path.relpath(path, REPO)}")
    return results


def same_results(tag, a, b, xy_tol=1e-4, ranked=True):
    """Two runs of the same queries: success and keyframe equal, the same
    candidates (in the same order, or as a set when not ``ranked``), (dx,
    dy, yaw) within xy_tol. Returns the largest (dx, dy, yaw) difference
    and the number of candidate ranks that differ."""
    worst, swapped = 0.0, 0
    for i, (x, y) in enumerate(zip(a, b)):
        same = (np.array_equal(x.candidates, y.candidates) if ranked else
                np.array_equal(np.sort(x.candidates), np.sort(y.candidates)))
        swapped += int((x.candidates != y.candidates).sum())
        check(x.success == y.success and x.db_index == y.db_index and same,
              f"{tag} query {i}: success {x.success}/{y.success}, db "
              f"{x.db_index}/{y.db_index}, candidates {x.candidates} / "
              f"{y.candidates}")
        if x.success:
            d = float(np.abs(x.match_xy_yaw - y.match_xy_yaw).max())
            worst = max(worst, d)
            check(d <= xy_tol, f"{tag} query {i}: xy_yaw differs by {d:.3e}")
    return worst, swapped


def phase_fused_query(torch, cfg, lq_set, kf_set, q_set, centroids):
    """The serving path (fast_match(fm=True), the device store without a
    host mirror, locate_fused) at full width on both fused variants, held
    to the gates of the located-query phases; then locate, locate_batch and
    locate_fused held to one another. Returns the K1 and K2 launches of the
    two fused runs."""
    from gloc3d_tpu_torch.kernels import bin_sums as bs
    from gloc3d_tpu_torch.kernels import segment_sum as ss

    (kf_poses, kf), (q_poses, qs) = lq_set
    model = build_serving_model(torch, cfg, "bfloat16", centroids)
    ss.segment_sum_sorted.launches = 0
    loc = serving_localizer(torch, cfg, model, kf, host_stats=True)
    results = fused_results(loc, qs, "host-stats")
    k1 = ss.segment_sum_sorted.launches
    print(f"[fused] host-stats locate_fused, fm preset, device store (no "
          f"host mirror): K1 launches {k1}; store {tuple(loc._kf_store.shape)}"
          f" uint8, {loc._kf_store.numel() / 2**20:.1f} MiB")
    check(k1 >= N_KEYFRAMES // 4 + N_QUERIES, f"K1 launched {k1} times")
    check(all(k.image is None for k in loc.keyframes),
          "host_mirror=False kept images on the host")
    check_located("fused", results, kf_poses, q_poses, cfg.index.top_k)

    bs.pillar_bin_sums.launches = 0
    a_loc = serving_localizer(torch, cfg, model, kf_set[2], align_ground=True)
    a_results = fused_results(a_loc, q_set[2], "aligned")
    k2 = bs.pillar_bin_sums.launches
    need = 2 * (len(kf_set[2]) // 4 + len(q_set[2]))
    print(f"[fused] aligned all-device locate_fused: K2 launches {k2} (at "
          f"least {need})")
    check(k2 >= need, f"K2 launched {k2} times, < {need}")
    check_aligned(torch, "fused-aligned", a_results, kf_set, q_set)

    # locate = locate_batch = locate_fused on one map, with the fp32 model
    # (a batch of 8 may take other GEMM kernels than a batch of 1, and bf16
    # rounding then reorders keyframes whose descriptors nearly tie)
    loc32 = serving_localizer(torch, cfg, build_serving_model(
        torch, cfg, "float32", centroids), kf, host_stats=True)
    r_loc = [loc32.locate(*q) for q in qs]
    r_batch = loc32.locate_batch(np.stack([q[0] for q in qs]),
                                 np.stack([q[1] for q in qs]))
    r_fused = [loc32.locate_fused(*q) for q in qs]
    d1, _ = same_results("locate vs locate_batch", r_loc, r_batch)
    d2, _ = same_results("locate vs locate_fused", r_loc, r_fused)
    # the aligned map: the all-device forward sums all pillars but pillar 0
    # with K2's float atomics, whose order varies between launches, so two
    # extractions of one scan differ in their last bits, and keyframes whose
    # distances nearly tie may swap ranks, the top one included (which then
    # changes the registered keyframe). So locate and locate_fused share one
    # extraction and are held equal, ranks and all; a second extraction
    # with the same ground draws counts the ranks the atomics swap
    d3, swaps = 0.0, 0
    extract = a_loc.extract
    for i, q in enumerate(q_set[2]):
        memo = []

        def extract_once(*args, memo=memo):
            if not memo:
                memo.append(extract(*args))
            return memo[0]

        a_loc._gen.manual_seed(100 + i)
        a_loc.extract = extract_once
        try:
            x, y = a_loc.locate(*q), a_loc.locate_fused(*q)
        finally:
            del a_loc.extract
        d, _ = same_results("aligned locate vs locate_fused", [x], [y])
        d3 = max(d3, d)
        a_loc._gen.manual_seed(100 + i)
        swaps += int((a_loc.locate_fused(*q).candidates != y.candidates).sum())
    print(f"[fused] fp32 host-stats map: locate = locate_batch = "
          f"locate_fused for {len(qs)}/{len(qs)} queries "
          f"({sum(r.success for r in r_loc)} localized); xy_yaw max |diff| "
          f"{d1:.2e} / {d2:.2e}; aligned bf16 map: locate = locate_fused on "
          f"one extraction, max |diff| {d3:.2e} (bound 1e-4); a second "
          f"extraction with the same draws swapped {swaps} of "
          f"{len(q_set[2]) * cfg.index.top_k} candidate ranks (K2's atomics)")
    return k1, k2


def count_syncs(torch, fn) -> int:
    """Host synchronisations of one call of fn(), as
    torch.cuda.set_sync_debug_mode("warn") reports them (not counting the
    mode's own once-per-process notice that it is a prototype)."""
    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message)
               and "prototype" not in str(w.message) for w in caught)


def phase_fused_cell(torch, cfg, centroids, card):
    """bench.py's fused cells: a 10 000-row bank of random rows with the
    real descriptor planted at row 5 000, a 10 000-row device store holding
    its BEV there, fold_bn=True and the fm preset, bench.py's synthetic
    query scan; host stats and aligned all-device."""
    from gloc3d_tpu_torch.core.transforms import Rigid3
    from gloc3d_tpu_torch.pipeline import GlobalLocalizer, Keyframe

    n_map, jrow = 10000, 5000
    n = cfg.voxel.max_points
    fcfg = cfg.replace(index=cfg.index.replace(capacity=n_map)).fast_match(
        fm=True)
    pts, mask = bench_query_scan(n)
    model = build_serving_model(torch, cfg, "bfloat16", centroids)
    rows = np.random.RandomState(0).randn(n_map, cfg.index.dim).astype(
        np.float32)
    dev = torch.device("cuda")
    s = fcfg.bev.image_size
    for label, kw in (("host stats", dict(host_stats=True)),
                      ("aligned all-device", dict(align_ground=True))):
        loc = GlobalLocalizer(fcfg, model, device=dev, device_keyframes=True,
                              host_mirror=False, **kw)
        desc, bev, ground = loc.extract(pts, mask)
        loc.bank.add(rows)
        loc.bank._bank[jrow] = desc[0]
        loc._kf_store = torch.zeros((n_map, s, s // 8), dtype=torch.uint8,
                                    device=dev)
        loc._kf_origins = torch.zeros((n_map, 2), device=dev)
        loc._kf_cap = n_map
        loc._store_keyframes(bev.image[:1], bev.origin_xy[:1], offset=jrow)
        g = None if ground is None else Rigid3(
            _host(ground.transform.rotation[0]),
            _host(ground.transform.translation[0]))
        loc.keyframes = [Keyframe(None, None, g)] * n_map
        res = loc.locate_fused(pts[0], mask[0])
        check(res.success and res.db_index == jrow,
              f"{label} fused cell: success {res.success}, db "
              f"{res.db_index} (want {jrow})")
        def fused():
            return loc.locate_fused(pts[0], mask[0])

        def plain():
            return loc.locate(pts[0], mask[0])

        # order fused, locate, locate, fused: the host clock drifts
        t = [host_ms(torch, f, 10) for f in (fused, plain, plain, fused)]
        syncs = (count_syncs(torch, plain), count_syncs(torch, fused))
        busy, wall, n_k, by_class = device_idle_share(torch, fused)
        print(f"[fused-cell] {label}, {n_map}-row bank and store "
              f"({loc._kf_store.numel() / 1e6:.1f} MB), fm preset, bf16, on "
              f"{card}: locate_fused {t[0]:.3f} / {t[3]:.3f} ms per query, "
              f"locate (same map and store) {t[1]:.3f} / {t[2]:.3f} ms (host "
              f"clock, median of 10 each, in the order fused, locate, "
              f"locate, fused; db {res.db_index}, score "
              f"{res.match_score:.3f}); host syncs per call "
              f"(set_sync_debug_mode): locate {syncs[0]}, locate_fused "
              f"{syncs[1]}")
        print(f"[fused-cell] {label}: traced locate_fused, device busy "
              f"{busy:.3f} ms of {wall:.3f} ms wall, idle share "
              f"{1 - busy / wall:.3f}, {n_k} kernels (torch.profiler; "
              f"against the untraced {t[0]:.3f} ms the idle share is "
              f"{max(0.0, 1 - busy / t[0]):.3f}); device ms by class: "
              + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
                  by_class.items(), key=lambda kv: -kv[1])))
        if label != "host stats":
            continue
        flat_ms = (t[0], t[3])
        q_img = torch.as_tensor(bev.image[0], device=dev)
        q_org = torch.as_tensor(bev.origin_xy[0], device=dev)
        configs = [(name, mcfg, k) for name, mcfg in (
            ("fm preset", fcfg.match), ("default matcher", cfg.match))
            for k in (1, cfg.index.top_k)]
        times = {c[0::2]: [] for c in configs}
        for order in (configs, configs[::-1]):
            for name, mcfg, k in order:
                loc.cfg = fcfg.replace(match=mcfg)
                idx = torch.full((k,), jrow, dtype=torch.long, device=dev)
                times[name, k].append(cuda_ms(
                    torch, lambda: loc._match(q_img, q_org, idx), 20))
        parts = []
        for name, mcfg, k in configs:
            loc.cfg = fcfg.replace(match=mcfg)
            idx = torch.full((k,), jrow, dtype=torch.long, device=dev)
            busy, _, n_k, _ = device_idle_share(
                torch, lambda: loc._match(q_img, q_org, idx))
            a, b = times[name, k]
            parts.append(f"{name} K={k} {a:.3f} / {b:.3f} ms (device busy "
                         f"{busy:.3f} ms, {n_k} kernels)")
        loc.cfg = fcfg
        print(f"[fused-cell] registration on {card} (CUDA events around the "
              f"store gather + match, mean of 20, query image on the device, "
              f"in one order and then the reverse; device busy from one "
              f"torch.profiler trace): " + "; ".join(parts))
    return flat_ms


def phase_fused_reference(torch, cfg, lq_set, centroids,
                          devices=("cuda", "cpu")):
    """One fm-preset locate_fused query on the card against the same port
    code on the CPU, fp32 with TF32 off: same success and keyframe, (dx,
    dy) within one fine cell (0.4 m at fine_downsample=2), yaw within one
    fine bin."""
    (_, kf), (_, qs) = lq_set
    out = {}
    for dev in devices:
        model = build_serving_model(torch, cfg, "float32", centroids)
        loc = serving_localizer(torch, cfg, model, kf[:2], device=dev,
                                host_stats=True)
        out[dev] = loc.locate_fused(*qs[0])
    a, b = (out[d] for d in devices)
    mcfg = cfg.fast_match(fm=True).match
    cell = cfg.bev.resolution * mcfg.fine_downsample
    fine_bin = math.radians(mcfg.refine_span_deg
                            / (mcfg.refine_rotations - 1))
    print(f"[fused-reference] fm preset, card vs CPU: success "
          f"{a.success}/{b.success}, db {a.db_index}/{b.db_index}")
    check(a.success == b.success and a.db_index == b.db_index,
          "card locate_fused != CPU locate_fused")
    if a.success:
        dxy = float(np.abs(a.match_xy_yaw[:2] - b.match_xy_yaw[:2]).max())
        dyaw = abs(math.remainder(float(a.match_xy_yaw[2]
                                        - b.match_xy_yaw[2]), 2 * math.pi))
        print(f"[fused-reference] (dx, dy) max |diff| {dxy:.2e} m (bound "
              f"{cell} m), yaw |diff| {math.degrees(dyaw):.2e} deg (bound "
              f"{math.degrees(fine_bin):.2f} deg)")
        check(dxy <= cell + 1e-3 and dyaw <= fine_bin + 1e-4,
              "card pose disagrees with the CPU pose")


# ---------------------------------------------------------------- map scale
MAP_N, MAP_DIMS, MAP_K, MAP_ROW = 1_000_000, (128, 512), 20, 123
IVF_CELLS, IVF_CAP, IVF_PROBE, IVF_TRAIN = 1024, 2048, 32, 65536
CITY_N = 100_000
HBM_BYTES_PER_S = 3.35e12


def map_rows(torch, n: int, d: int, seed: int, device: str = "cuda"):
    """tools/bench_bank.py's map: n unit-norm rows from ``seed``, made on
    the device, and 8 queries: row MAP_ROW and 7 other rows, each with
    0.02 Gaussian noise per element (the planted near-duplicates). Returns
    (rows, queries, the rows each query was made from)."""
    g = torch.Generator(device=device).manual_seed(seed)
    rows = torch.randn((n, d), generator=g, device=device)
    rows /= rows.norm(dim=1, keepdim=True)
    at = torch.tensor([MAP_ROW] + [(n // 8) * i + 7 for i in range(1, 8)],
                      device=device)
    return rows, rows[at] + 0.02 * torch.randn((8, d), generator=g,
                                               device=device), at


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def search_times(torch, dist_fn, sel_fn, n_bytes: int) -> dict:
    """CUDA-event ms of a search's distance pass, its selection on that
    pass's output, and the whole, mean of 20 each; the bound is n_bytes
    over the card's memory rate."""
    out = dist_fn()
    t = {"distance_ms": cuda_ms(torch, dist_fn, 20),
         "select_ms": cuda_ms(torch, lambda: sel_fn(out), 20),
         "search_ms": cuda_ms(torch, lambda: sel_fn(dist_fn()), 20),
         "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3}
    return t


def phase_map_scale(torch, card, seed: int = 0, device: str = "cuda"):
    """tools/bench_bank.py's settings on the port's four map-scale banks:
    flat fp32, flat int8 (DescriptorBank) and IVF with fp32 and int8 cells
    (IVFBank: IVF_CELLS cells of capacity IVF_CAP, nprobe IVF_PROBE, the
    quantizer trained on IVF_TRAIN rows, 10 Lloyd steps as bench_bank.py
    runs), MAP_N unit-norm rows at each D of MAP_DIMS, top-MAP_K. Prints
    each bank's build time (host clock), device bytes and per-query time at
    Q=1 and Q=8 split into the distance pass and the selection (a stable
    sort of the whole row), beside the bound (bytes read / 3.35 TB/s),
    and the two candidate int8 products (cuBLASLt int8 against an fp32
    product of the int8 values) and torch.topk beside the sort. Checks:
    the planted row at rank 1 everywhere; int8 rank 1 = fp32 rank 1; IVF
    at full probe = the flat search (first D); exclude_after hides ids ≥
    its bound; one IVF query of each cell kind card = CPU on one loaded
    layout, and both flat int8 and IVF files through save / load on the
    card (first D)."""
    summary = {}
    for d in MAP_DIMS:
        summary.update(map_scale_at(torch, card, d, seed,
                                    torch.device(device)))
        torch.cuda.empty_cache()
    return summary


def map_scale_at(torch, card, d: int, seed: int, dev) -> dict:
    """phase_map_scale at one D; its tensors are freed when it returns."""
    from gloc3d_tpu_torch.config import IndexConfig
    from gloc3d_tpu_torch.index.bank import DescriptorBank
    from gloc3d_tpu_torch.index.ivf import IVFBank, select_ids
    from gloc3d_tpu_torch.ops.topk import (
        int8_dots, l2_topk, quantize_rows, select_topk,
    )

    summary = {}
    rows, queries, at = map_rows(torch, MAP_N, d, seed, dev.type)
    host = rows.cpu().numpy()
    banks = {}
    for quant in ("none", "int8"):
        t0 = time.perf_counter()
        b = DescriptorBank(IndexConfig(dim=d, capacity=MAP_N,
                                       top_k=MAP_K, quantize=quant),
                           device=dev)
        b.add(rows)
        torch.cuda.synchronize()
        banks["flat " + quant] = (b, time.perf_counter() - t0)
    t0 = time.perf_counter()
    ivf32 = IVFBank(d, IVF_CELLS, IVF_CAP, IVF_PROBE, device=dev)
    ivf32.train(host[:IVF_TRAIN], torch.Generator().manual_seed(seed),
                iters=10)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    for quant, ivf in (("none", ivf32), ("int8", None)):
        t0 = time.perf_counter()
        if ivf is None:  # the same quantizer: rank 1 held to fp32's
            ivf = IVFBank(d, IVF_CELLS, IVF_CAP, IVF_PROBE,
                          quantize=quant, device=dev)
            ivf.centroids = ivf32.centroids
        ivf.add(host)
        ivf.device_arrays()
        torch.cuda.synchronize()
        banks["IVF " + quant] = (ivf, t_train + time.perf_counter() - t0)
    del rows

    lines, rank1 = [], {}
    for name, (b, build) in banks.items():
        flat = isinstance(b, DescriptorBank)
        if flat:
            held = nbytes(b._bank, getattr(b, "_scales", None),
                          getattr(b, "_bsq", None))
            valid = torch.ones(MAP_N, dtype=torch.bool, device=dev)
        else:
            held = nbytes(b.centroids, *b.device_arrays())
            # one slot of every table: its row, norm, scale and id
            per_slot = nbytes(*(t[0, 0] for t in b.device_arrays()
                                if t is not None))
        idx = b.query_device(queries, MAP_K)[1]
        idx = idx.cpu().numpy()
        rank1[name] = idx[:, 0]
        check(idx[0, 0] == MAP_ROW, f"D={d} {name}: rank 1 is row "
              f"{idx[0, 0]}, not the planted {MAP_ROW}")
        parts = []
        for qn in (1, 8):
            q = queries[:qn]
            if flat:
                n_bytes = held + q.numel() * 4
                t = search_times(
                    torch, lambda: b.distances(q, valid),
                    lambda x: select_topk(x, MAP_K), n_bytes)
            else:
                probe = l2_topk(q, b.centroids, b.nprobe)[1]
                n_cells = len(torch.unique(probe))
                n_bytes = (nbytes(b.centroids, q)
                           + n_cells * b.cell_capacity * per_slot)
                t = search_times(
                    torch, lambda: b.distances(q),
                    lambda x: select_ids(*x, MAP_K), n_bytes)
            parts.append(
                f"Q={qn}: search {t['search_ms']:.4f} ms "
                f"({t['search_ms'] / qn:.4f} per query; distance pass "
                f"{t['distance_ms']:.4f}, selection {t['select_ms']:.4f};"
                f" bound {t['bound_ms']:.4f} ms for "
                f"{n_bytes / 1e6:.1f} MB read)")
            summary[f"D={d} {name} Q={qn}"] = t
        extra = ("" if flat else f"; train {t_train:.2f} s of it, "
                 f"shared by both cell kinds; max cell "
                 f"{int(b._sizes.max())} of {b.cell_capacity}")
        lines.append(f"[map-scale] D={d} {name}: build {build:.2f} s "
                     f"(host clock{extra}), device bytes "
                     f"{held / 1e9:.3f} GB; " + "; ".join(parts))
    for line in lines:
        print(line)
    hits = {k: int((v == at.cpu().numpy()).sum()) for k, v in
            rank1.items()}
    for kind in ("flat", "IVF"):
        check(np.array_equal(rank1[kind + " int8"],
                             rank1[kind + " none"]),
              f"D={d} {kind}: int8 rank 1 {rank1[kind + ' int8']} != "
              f"fp32 {rank1[kind + ' none']}")
    print(f"[map-scale] D={d}: int8 rank 1 = fp32 rank 1 for 8/8 "
          f"queries, flat and IVF; planted rows at rank 1: {hits}")

    # the int8 product: cuBLASLt int8 against fp32 of the int8 values
    bq = banks["flat int8"][0]._bank
    prods = []
    for qn in (1, 8):
        qq = quantize_rows(queries[:qn])[0]
        prods.append(
            f"Q={qn} int8_dots {cuda_ms(torch, lambda: int8_dots(bq, qq), 20):.4f} ms, "
            f"fp32 product of the int8 values (cast included) "
            f"{cuda_ms(torch, lambda: bq.float() @ qq.float().t(), 20):.4f} ms")
        x = banks["flat none"][0].distances(queries[:qn])
        prods.append(
            f"Q={qn} selection: stable sort "
            f"{cuda_ms(torch, lambda: select_topk(x, MAP_K), 20):.4f} ms,"
            f" torch.topk {cuda_ms(torch, lambda: torch.topk(x, MAP_K, largest=False), 20):.4f} ms")
    print(f"[map-scale] D={d} N={MAP_N} on {card}: " + "; ".join(prods))

    ex = banks["IVF int8"][0].query_device(queries[:1], MAP_K,
                                           exclude_after=MAP_ROW)[1]
    fb = banks["flat int8"][0]
    fb.cfg = fb.cfg.replace(num_exclude_recent=MAP_N - MAP_ROW)
    ex_flat = fb.query_device(queries[:1], MAP_K, exclude_recent=True)[1]
    for name, e in (("IVF", ex), ("flat", ex_flat)):
        e = e.cpu().numpy()
        check(((e < MAP_ROW) | (e == -1)).all() and MAP_ROW not in e,
              f"D={d} {name} int8 exclude: ids {e}")
    print(f"[map-scale] D={d}: exclude below row {MAP_ROW} holds on IVF"
          f" int8 and flat int8 (ids < {MAP_ROW})")

    if d == MAP_DIMS[0]:
        phase_map_scale_checks(torch, banks, queries, dev)
    return summary


def phase_map_scale_checks(torch, banks, queries, dev):
    """IVF at full probe against the flat search; card vs CPU on one saved
    layout; flat int8 and IVF files through save / load on the card."""
    from gloc3d_tpu_torch.index.bank import DescriptorBank
    from gloc3d_tpu_torch.index.ivf import IVFBank

    for quant in ("none", "int8"):
        ivf, flat = banks["IVF " + quant][0], banks["flat " + quant][0]
        got = ivf.query_device(queries[:1], MAP_K, nprobe=IVF_CELLS)[1]
        want = flat.query_device(queries[:1], MAP_K)[1]
        check(torch.equal(got.cpu(), want.cpu()),
              f"IVF {quant} at nprobe {IVF_CELLS} != flat: {got} / {want}")
    print(f"[map-scale] IVF at nprobe={IVF_CELLS} = flat top-{MAP_K} ids, "
          f"fp32 and int8")
    with tempfile.TemporaryDirectory() as tmp:
        for quant in ("none", "int8"):
            path = os.path.join(tmp, f"ivf_{quant}.npz")
            banks["IVF " + quant][0].save(path)
            out = {}
            for where in (dev, torch.device("cpu")):
                back = IVFBank.load(path, device=where)
                out[where.type] = [x.cpu().numpy() for x in
                                   back.query_device(queries.to(where),
                                                     MAP_K)]
                del back
            want = [x.cpu().numpy() for x in banks["IVF " + quant][0]
                    .query_device(queries, MAP_K)]
            card_d2, card_ids = out[dev.type]
            check(np.array_equal(card_ids, want[1]),
                  f"IVF {quant}: loaded on the card != saved")
            check(np.array_equal(card_ids, out["cpu"][1]),
                  f"IVF {quant}: card ids != CPU ids on one layout")
            err = float(np.abs(card_d2 - out["cpu"][0]).max())
            check(err <= 1e-5, f"IVF {quant}: card vs CPU dists² {err}")
            print(f"[map-scale] IVF {quant}: save / load on the card gives "
                  f"the saved map's ids; card = CPU on the loaded layout "
                  f"(8 queries, ids equal, dists² max |diff| {err:.2e}, "
                  f"bound 1e-5)")
        path = os.path.join(tmp, "flat_int8.npz")
        flat = banks["flat int8"][0]
        flat.save(path)
        back = DescriptorBank.load(path, device=dev)
        same = torch.equal(back.query_device(queries, MAP_K)[1],
                           flat.query_device(queries, MAP_K)[1])
        check(back._quantized and same, "flat int8 save / load differs")
        print("[map-scale] flat int8: save / load on the card gives the "
              "saved map's ids")


def phase_city(torch, cfg, centroids, card, flat_ms):
    """tools/bench_city.py's map: CITY_N keyframes on the IVF + int8 bank
    (1024 cells, nprobe 32, capacity max(256, 2n / 1024)) and the device
    store without a host mirror, host stats, fast_match(fm=True), bf16,
    bench.py's synthetic scan planted at row n / 2 as phase_fused_cell
    plants it (random rows elsewhere, as bench_city.py fills them).
    locate_fused must return the planted row and register it."""
    from gloc3d_tpu_torch.pipeline import GlobalLocalizer, Keyframe

    n, j = CITY_N, CITY_N // 2
    index = cfg.index.replace(
        capacity=n, backend="ivf", quantize="int8", ivf_num_cells=1024,
        ivf_nprobe=32, ivf_cell_capacity=max(256, 2 * n // 1024))
    ccfg = cfg.replace(index=index).fast_match(fm=True)
    pts, mask = bench_query_scan(cfg.voxel.max_points)
    dev = torch.device("cuda")
    loc = GlobalLocalizer(ccfg, build_serving_model(
        torch, cfg, "bfloat16", centroids), device=dev, host_stats=True,
        device_keyframes=True, host_mirror=False)
    desc, bev, _ = loc.extract(pts, mask)
    rng = np.random.RandomState(1)
    for i in range(0, n, 16384):
        m = min(16384, n - i)
        chunk = rng.randn(m, index.dim).astype(np.float32)
        if i <= j < i + m:
            chunk[j - i] = _host(desc[0].float())
        loc.bank.add(chunk)
    s = ccfg.bev.image_size
    loc._kf_store = torch.zeros((n, s, s // 8), dtype=torch.uint8,
                                device=dev)
    loc._kf_origins = torch.zeros((n, 2), device=dev)
    loc._kf_cap = n
    loc._store_keyframes(bev.image[:1], bev.origin_xy[:1], offset=j)
    loc.keyframes = [Keyframe(None, None, None)] * n
    t0 = time.perf_counter()
    loc.bank._flush()  # trains the quantizer and ingests the map
    loc.bank._ivf.device_arrays()
    torch.cuda.synchronize()
    build = time.perf_counter() - t0
    res = loc.locate_fused(pts[0], mask[0])
    check(res.success and res.db_index == j, f"city: success {res.success},"
          f" db {res.db_index} (want {j})")
    ivf = loc.bank._ivf
    held = {"store": nbytes(loc._kf_store, loc._kf_origins),
            "IVF": nbytes(ivf.centroids, *ivf.device_arrays())}
    t = [host_ms(torch, lambda: loc.locate_fused(pts[0], mask[0]), 10)
         for _ in range(2)]
    search = cuda_ms(torch, lambda: loc.bank.query_device(desc[:1]), 20)
    print(f"[city] {n} keyframes, IVF + int8 (1024 cells, nprobe 32, cell "
          f"capacity {ivf.cell_capacity}, max cell {int(ivf._sizes.max())}),"
          f" device store without a host mirror, host stats, fm preset, bf16,"
          f" on {card}: db {res.db_index} registered (score "
          f"{res.match_score:.3f}); build (train + ingest) {build:.2f} s; "
          f"locate_fused {t[0]:.3f} / {t[1]:.3f} ms per query (host clock, "
          f"median of 10, twice) against the 10000-row flat fused cell's "
          f"{flat_ms[0]:.3f} / {flat_ms[1]:.3f} ms; the IVF search alone "
          f"{search:.4f} ms (CUDA "
          f"events); device bytes held: store {held['store'] / 1e9:.3f} GB, "
          f"IVF {held['IVF'] / 1e9:.3f} GB "
          f"(torch.cuda.memory_allocated {torch.cuda.memory_allocated() / 1e9:.3f} GB)")
    return {"locate_fused_ms": t, "search_ms": search, "build_s": build,
            "device_bytes": held}


DEVICE_CLASSES = (  # kernel-name fragment → class, first match wins
    ("segment_sum_sorted_kernel", "K1"), ("pillar_bin_sums", "K2"),
    ("xmma", "conv/matmul"), ("conv", "conv/matmul"), ("gemm", "conv/matmul"),
    ("cutlass", "conv/matmul"), ("cudnn", "conv/matmul"),
    ("index", "gather/index"), ("gather", "gather/index"),
    ("scatter", "gather/index"), ("batch_norm", "BN/reduce"),
    ("welford", "BN/reduce"), ("reduce", "BN/reduce"))


def device_time_by_class(events) -> dict:
    """Summed device ms of a chrome trace's kernels by DEVICE_CLASSES (other
    kernels: "elementwise/other"), plus copies and fills."""
    out: dict = {}
    for e in events:
        cat = e.get("cat")
        if cat in ("gpu_memcpy", "gpu_memset"):
            key = "memcpy/memset"
        elif cat == "kernel":
            name = e.get("name", "").lower()
            key = next((k for frag, k in DEVICE_CLASSES if frag in name),
                       "elementwise/other")
        else:
            continue
        out[key] = out.get(key, 0.0) + e.get("dur", 0) / 1e3
    return out


def trace_events(prof) -> list:
    """The chrome-trace events of a finished torch.profiler run."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def trace(torch, fn):
    """Trace fn() once with torch.profiler, after one untraced call: (the
    chrome-trace events, wall ms)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return trace_events(prof), wall


def device_busy(events):
    """(device busy ms as the union of kernel / memcpy / memset intervals,
    number of kernels, device ms by class) of a trace's events."""
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    n_kernels = sum(e.get("cat") == "kernel" for e in events)
    return busy / 1e3, n_kernels, device_time_by_class(events)


def device_idle_share(torch, fn):
    """Trace fn() once: (device busy ms, wall ms, number of kernels, device
    ms by class)."""
    events, wall = trace(torch, fn)
    busy, n_kernels, by_class = device_busy(events)
    return busy, wall, n_kernels, by_class


def phase_aligned_timing(torch, cfg, loc, qs, card):
    from gloc3d_tpu_torch.kernels import bin_sums as bs
    from gloc3d_tpu_torch.ops.bev import batch_scan_to_bev
    from gloc3d_tpu_torch.ops.topk import l2_topk

    pts, mask = qs[0]
    detect = host_ms(torch, lambda: loc.detect(pts[None], mask[None]), 10)
    locate = host_ms(torch, lambda: [loc.locate(*q) for q in qs], 3) / len(qs)
    print(f"[timing-aligned] all-device aligned path on {card}: detect "
          f"{detect:.3f} ms (host clock, median of 10; {len(loc.bank)}-row "
          f"bank), locate {locate:.3f} ms per query (host clock, "
          f"{len(qs)} queries x 3, staged first)")

    p_d = torch.from_numpy(pts[None]).cuda()
    m_d = torch.from_numpy(mask[None]).cuda()
    with torch.no_grad():
        ground = cuda_ms(torch, lambda: loc._align(p_d, m_d), 10)
        aligned, _ = loc._align(p_d, m_d)
        bev_ms = cuda_ms(torch, lambda: batch_scan_to_bev(
            aligned[..., :3], m_d, cfg.bev), 10)
        calls = record_launches(lambda: loc.model(aligned, m_d))["K2"]
        k2 = [cuda_ms(torch, lambda: bs.pillar_bin_sums(*c), 20)
              for c in calls]
        fwd = cuda_ms(torch, lambda: loc.model(aligned, m_d), 10)
        desc = loc.model(aligned, m_d)
        topk = cuda_ms(torch, lambda: l2_topk(desc, loc.bank.data,
                                              cfg.index.top_k), 10)
        bev = batch_scan_to_bev(aligned[..., :3], m_d, cfg.bev)
    reg = cuda_ms(torch, lambda: loc._match(bev.image[0], bev.origin_xy[0],
                                            np.zeros(1, np.int64)), 5)
    print(f"[timing-aligned] stages of one scan on {card} (CUDA events "
          f"around each call, host gaps included): ground estimate + "
          f"alignment {ground:.3f} ms; device BEV {bev_ms:.3f} ms; K2 "
          f"statistics {k2[0]:.3f} ms, K2 features {k2[1]:.3f} ms (wrapper, "
          f"id check included); descriptor forward incl. both K2 "
          f"{fwd:.3f} ms; top-{cfg.index.top_k} {topk:.3f} ms; registration "
          f"K=1 {reg:.3f} ms")
    busy, wall, n_k, _ = device_idle_share(torch, lambda: loc.locate(*qs[1]))
    print(f"[timing-aligned] traced aligned locate on {card}: device busy "
          f"{busy:.3f} ms of {wall:.3f} ms wall, idle share "
          f"{1 - busy / wall:.3f}, {n_k} kernels (torch.profiler; against "
          f"the untraced {locate:.3f} ms per query the idle share is "
          f"{1 - busy / locate:.3f})")


def phase_timing(torch, cfg, loc, kf, qs, card):
    from gloc3d_tpu_torch.data import native
    from gloc3d_tpu_torch.ops.topk import l2_topk
    from gloc3d_tpu_torch.pipeline import GlobalLocalizer

    n = cfg.voxel.max_points
    pts, mask = bench_query_scan(n)
    bank_rows = np.random.RandomState(0).randn(10000, cfg.index.dim).astype(
        np.float32)
    det = GlobalLocalizer(cfg, loc.model, device=torch.device("cuda"),
                          host_stats=True)
    det.bank.add(bank_rows)
    detect = host_ms(torch, lambda: det.detect(pts, mask), 20)
    # the plain all-device path (the default), same weights and bank
    det_dev = GlobalLocalizer(cfg, loc.model, device=torch.device("cuda"))
    det_dev.bank.add(bank_rows)
    detect_dev = host_ms(torch, lambda: det_dev.detect(pts, mask), 20)

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
          f"{dev_detect:.3f} ms (CUDA events); all-device detect "
          f"(host_stats=False) {detect_dev:.3f} ms (host clock, median of 20)")

    loc_dev = build_map(torch, cfg, loc.model, kf)
    locate_dev = host_ms(torch, lambda: [loc_dev.locate(*q) for q in qs],
                         3) / len(qs)
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
          f"included); all-device located query (host_stats=False, "
          f"align_ground=False) {locate_dev:.3f} ms per query (host clock, "
          f"same queries x 3)")


# ------------------------------------------------------------------- i2i
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16, NVIDIA data sheet


def i2i_model(torch, cfg, dtype: str, centroids=None, alpha: float = 30.0,
              device="cuda"):
    """The port's seeded VGG16 + NetVLAD-FC in ``dtype`` on ``device``,
    NetVLAD given ``centroids`` (assignment weights alpha·centroids) where
    given."""
    from gloc3d_tpu_torch.models.descriptor import build_model, init_params

    model = init_params(build_model(
        cfg.model.replace(compute_dtype=dtype), cfg.voxel), seed=0)
    if centroids is not None:
        with torch.no_grad():
            model.pool.centroids.copy_(centroids)
            model.pool.conv.weight.copy_(alpha * centroids[:, :, None, None])
    return model.to(device).eval()


def i2i_centroids(torch, cfg, kf_set, seed=0):
    """NetVLAD's data init for the i2i phases: K normalised local features
    of the seeded fp32 VGG16, sampled from the feature maps of the aligned
    map's db BEVs (as vlad_centroids does for PointPillar)."""
    from gloc3d_tpu_torch.pipeline import GlobalLocalizer

    model = i2i_model(torch, cfg, "float32")
    loc = GlobalLocalizer(cfg, model, device=torch.device("cuda"),
                          align_ground=True)
    feats = []
    with torch.no_grad():
        for i in range(0, len(kf_set[2]), 4):
            kf = kf_set[2][i:i + 4]
            _, bev, _ = loc.extract(np.stack([k[0] for k in kf]),
                                    np.stack([k[1] for k in kf]))
            feats.append(model.encode(bev.image[..., None].repeat(1, 1, 1, 3)))
    f = torch.nn.functional.normalize(
        torch.cat(feats).reshape(-1, cfg.model.encoder_dim).float(),
        dim=-1).cpu()
    pick = torch.randperm(f.shape[0], generator=torch.Generator(
    ).manual_seed(seed))[: cfg.model.num_clusters]
    return f[pick]


def render_bevs(torch, cfg, scans):
    """Scans → their BEV images as the i2i inputs a user loads from disk:
    ((B, S, S, 3) float32 numpy, free = 1.0; (B, 2) origins), projected by
    the port on the card."""
    from gloc3d_tpu_torch.ops.bev import batch_scan_to_bev

    images, origins = [], []
    for i in range(0, len(scans), 4):
        pts = torch.from_numpy(np.stack([s[0] for s in scans[i:i + 4]]))
        mask = torch.from_numpy(np.stack([s[1] for s in scans[i:i + 4]]))
        bev = batch_scan_to_bev(pts[..., :3].cuda(), mask.cuda(), cfg.bev)
        images.append(bev.image[..., None].repeat(1, 1, 1, 3).cpu().numpy())
        origins.append(bev.origin_xy.cpu().numpy())
    return np.concatenate(images), np.concatenate(origins)


def top_kernels(events, n: int = 4) -> str:
    """The n kernels of a trace with the most device time, summed by
    name."""
    by_name: dict = {}
    for e in events:
        if e.get("cat") == "kernel":
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in top)


def phase_i2i_cell(torch, cfg, model, card):
    """bench.py's i2i shape: one (1, 768, 768, 3) image (rand > 0.01), a
    random (10 000, 512) bank, detect = forward + top-20; B=1 and B=8."""
    from gloc3d_tpu_torch.models.vgg import conv_flops
    from gloc3d_tpu_torch.pipeline import GlobalLocalizer

    s = cfg.bev.image_size
    rng = np.random.RandomState(0)
    img1 = (rng.rand(1, s, s, 3) > 0.01).astype(np.float32)
    img8 = np.repeat(img1, 8, axis=0)
    det = GlobalLocalizer(cfg, model, device=torch.device("cuda"))
    det.bank.add(rng.randn(10000, cfg.index.dim).astype(np.float32))
    d1, i1, _, _ = det.detect(img1)
    d8, i8, _, _ = det.detect(img8)
    check(i1.shape == (1, cfg.index.top_k) and np.isfinite(d1).all(),
          "i2i detect output")
    check(bool((i8 == i1).all()), "i2i detect at B=8 differs from B=1")

    b1 = cuda_ms(torch, lambda: det.detect(img1), 20)
    b8 = cuda_ms(torch, lambda: det.detect(img8), 10) / 8
    h1 = host_ms(torch, lambda: det.detect(img1), 20)
    x1, x8 = torch.from_numpy(img1).cuda(), torch.from_numpy(img8).cuda()
    with torch.no_grad():
        enc1 = cuda_ms(torch, lambda: det.model.encode(x1), 20)
        enc8 = cuda_ms(torch, lambda: det.model.encode(x8), 10) / 8
        fwd1 = cuda_ms(torch, lambda: det.model(x1), 20)
    flops = conv_flops(1, s)
    mfu1 = flops / (enc1 * 1e-3) / BF16_FLOPS_PER_S
    mfu8 = flops / (enc8 * 1e-3) / BF16_FLOPS_PER_S
    bound = flops / BF16_FLOPS_PER_S * 1e3
    print(f"[i2i-cell] detect at bench.py's i2i shape (VGG16 + NetVLAD-FC "
          f"bf16, {s}² image, 10000 x {cfg.index.dim} bank, top-"
          f"{cfg.index.top_k}) on {card}: {b1:.3f} ms per query at B=1, "
          f"{b8:.3f} ms per query at B=8 (CUDA events around 20 / 10 "
          f"detects, mean; image upload included); host clock {h1:.3f} ms at "
          f"B=1 (median of 20)")
    print(f"[i2i-cell] VGG16 forward on an image on the card: "
          f"{flops / 1e9:.1f} GFLOP per image (13 convs, from their shapes), "
          f"bound {bound:.4f} ms at 989 TFLOP/s dense bf16; conv stack "
          f"{enc1:.3f} ms at B=1 ({flops / enc1 / 1e9:.1f} TFLOP/s, "
          f"i2i_forward_mfu={mfu1:.4f}), {enc8:.3f} ms per image at B=8 "
          f"({flops / enc8 / 1e9:.1f} TFLOP/s, share {mfu8:.4f}); with "
          f"NetVLAD-FC {fwd1:.3f} ms at B=1 (CUDA events, mean of 20 "
          f"back-to-back calls at B=1, 10 at B=8)")
    events, wall = trace(torch, lambda: det.detect(img1))
    busy, n_k, by_class = device_busy(events)
    print(f"[i2i-cell] traced detect at B=1: device busy {busy:.3f} ms of "
          f"{wall:.3f} ms wall, {n_k} kernels; device ms by class: "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
              by_class.items(), key=lambda kv: -kv[1]))
          + f"; top kernels: {top_kernels(events)}")
    return {"i2i_forward_mfu": mfu1, "forward_ms": enc1,
            "detect_ms_b1": b1, "detect_ms_b8": b8}


def phase_i2i_aligned(torch, cfg, model, kf_set, q_set, card):
    """The paper's configuration: aligned scan → BEV → VGG16 → 6-DoF, on
    the tilted world of phase 6, held to its gates."""
    from gloc3d_tpu_torch.ops.bev import batch_scan_to_bev
    from gloc3d_tpu_torch.ops.topk import l2_topk

    qs = q_set[2]
    loc, results = run_aligned(torch, cfg, model, kf_set[2], qs,
                               host_stats=False)
    check_aligned(torch, "i2i-aligned", results, kf_set, q_set)
    locate = host_ms(torch, lambda: [loc.locate(*q) for q in qs], 3) / len(qs)
    pts, mask = qs[0]
    p_d = torch.from_numpy(pts[None]).cuda()
    m_d = torch.from_numpy(mask[None]).cuda()
    with torch.no_grad():
        ground = cuda_ms(torch, lambda: loc._align(p_d, m_d), 10)
        aligned, _ = loc._align(p_d, m_d)
        bev_ms = cuda_ms(torch, lambda: batch_scan_to_bev(
            aligned[..., :3], m_d, cfg.bev), 10)
        bev = batch_scan_to_bev(aligned[..., :3], m_d, cfg.bev)
        img = bev.image[..., None].repeat(1, 1, 1, 3)
        fwd = cuda_ms(torch, lambda: loc.model(img), 10)
        desc = loc.model(img)
        topk = cuda_ms(torch, lambda: l2_topk(desc, loc.bank.data,
                                              cfg.index.top_k), 10)
    reg = cuda_ms(torch, lambda: loc._match(bev.image[0], bev.origin_xy[0],
                                            np.zeros(1, np.int64)), 5)
    busy, wall, n_k, by_class = device_idle_share(
        torch, lambda: loc.locate(*qs[1]))
    print(f"[i2i-aligned] aligned i2i locate ({len(kf_set[2])} keyframes, "
          f"staged first, default matcher) on {card}: {locate:.3f} ms per "
          f"query (host clock, {len(qs)} queries x 3); stages of one scan "
          f"(CUDA events around each call): ground estimate + alignment "
          f"{ground:.3f} ms, device BEV {bev_ms:.3f} ms, VGG16 + NetVLAD-FC "
          f"forward {fwd:.3f} ms, top-{cfg.index.top_k} {topk:.3f} ms, "
          f"registration K=1 {reg:.3f} ms")
    print(f"[i2i-aligned] traced aligned i2i locate: device busy "
          f"{busy:.3f} ms of {wall:.3f} ms wall, idle share "
          f"{1 - busy / wall:.3f}, {n_k} kernels (against the untraced "
          f"{locate:.3f} ms the idle share is {1 - busy / locate:.3f}); "
          f"device ms by class: " + ", ".join(
              f"{k} {v:.2f}" for k, v in sorted(by_class.items(),
                                                key=lambda kv: -kv[1])))
    return locate


def phase_i2i_fused(torch, cfg, centroids, lq_set, card):
    """Image inputs on the serving configuration: the located world's db
    BEVs as (B, S, S, 3) images with their origins, fast_match(fm=True),
    the device store without a host mirror, image queries. The bf16 map is
    held to the located gates and locate = locate_fused; locate =
    locate_batch = locate_fused on the fp32 map (a batch of 8 may take
    other conv kernels than a batch of 1, and bf16 rounding then reorders
    nearly tied keyframes)."""
    from gloc3d_tpu_torch.pipeline import GlobalLocalizer

    (kf_poses, kf), (q_poses, qs) = lq_set
    kf_img, kf_org = render_bevs(torch, cfg, kf)
    q_img, q_org = render_bevs(torch, cfg, qs)

    def serving(model):
        loc = GlobalLocalizer(cfg.fast_match(fm=True), model,
                              device=torch.device("cuda"),
                              device_keyframes=True, host_mirror=False)
        for i in range(0, len(kf_img), 4):
            loc.add_keyframes(kf_img[i:i + 4], origins=kf_org[i:i + 4])
        return loc

    loc = serving(i2i_model(torch, cfg, "bfloat16", centroids))
    check(all(k.image is None for k in loc.keyframes),
          "host_mirror=False kept images on the host")
    fused = [loc.locate_fused(i, origin=o) for i, o in zip(q_img, q_org)]
    check_located("i2i-fused", fused, kf_poses, q_poses, cfg.index.top_k)
    d0, _ = same_results("i2i bf16 locate vs locate_fused",
                         [loc.locate(i, origin=o)
                          for i, o in zip(q_img, q_org)], fused)
    loc32 = serving(i2i_model(torch, cfg, "float32", centroids))
    r_loc = [loc32.locate(i, origin=o) for i, o in zip(q_img, q_org)]
    r_batch = loc32.locate_batch(q_img, origins=q_org)
    r_fused = [loc32.locate_fused(i, origin=o) for i, o in zip(q_img, q_org)]
    d1, _ = same_results("i2i fp32 locate vs locate_batch", r_loc, r_batch,
                         ranked=False)
    d2, _ = same_results("i2i fp32 locate vs locate_fused", r_loc, r_fused,
                         ranked=False)
    print(f"[i2i-fused] locate = locate_fused on the bf16 map (max |diff| "
          f"{d0:.2e}); fp32 map: locate = locate_batch = locate_fused for "
          f"{len(qs)}/{len(qs)} queries ({sum(r.success for r in r_loc)} "
          f"localized; same db_index and candidate set), xy_yaw max |diff| "
          f"{d1:.2e} / {d2:.2e} (bound 1e-4)")

    img, org = q_img[0], q_org[0]

    def fused_call():
        return loc.locate_fused(img, origin=org)

    def plain_call():
        return loc.locate(img, origin=org)

    t = [host_ms(torch, f, 10) for f in (fused_call, plain_call, plain_call,
                                         fused_call)]
    syncs = (count_syncs(torch, plain_call), count_syncs(torch, fused_call))
    busy, wall, n_k, _ = device_idle_share(torch, fused_call)
    print(f"[i2i-fused] image query, fm preset, bf16, {len(kf_img)}-keyframe "
          f"store on {card}: locate_fused {t[0]:.3f} / {t[3]:.3f} ms per "
          f"query, locate {t[1]:.3f} / {t[2]:.3f} ms (host clock, median of "
          f"10 each, in the order fused, locate, locate, fused); host syncs "
          f"per call (set_sync_debug_mode): locate {syncs[0]}, locate_fused "
          f"{syncs[1]}; traced locate_fused: device busy {busy:.3f} ms of "
          f"{wall:.3f} ms wall, {n_k} kernels")
    return t[0]


def phase_i2i_reference(torch, cfg, kf_set, q_set, centroids):
    """Card against CPU, fp32 with TF32 off in both cuDNN and matmul: one
    768² forward (a real BEV of the aligned map), and one aligned i2i
    located query with the same draws."""
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    img, _ = render_bevs(torch, cfg, q_set[2][:1])
    out = {}
    for dev in ("cuda", "cpu"):
        model = i2i_model(torch, cfg, "float32", centroids, device=dev)
        with torch.no_grad():
            feat = model.encode(torch.from_numpy(img).to(dev))
            out[dev] = (feat.cpu().double(), model.pool(feat).cpu().double())
    (f_g, d_g), (f_c, d_c) = out["cuda"], out["cpu"]
    rel_f = float((f_g - f_c).norm() / f_c.norm())
    rel_d = float((d_g - d_c).norm() / d_c.norm())
    print(f"[i2i-reference] fp32 {img.shape[1]}² forward card vs CPU (TF32 "
          f"off in cuDNN and matmul): relative L2 error of the VGG16 feature "
          f"map {rel_f:.3e}, of the descriptor {rel_d:.3e} (limit 1e-3)")
    check(rel_d < 1e-3 and rel_f < 1e-3,
          "card i2i forward disagrees with the CPU")

    res = {}
    for dev in ("cuda", "cpu"):
        model = i2i_model(torch, cfg, "float32", centroids, device=dev)
        loc, _ = run_aligned(torch, cfg, model, kf_set[2][:2], [],
                             host_stats=False, seed=5, device=dev)
        res[dev] = loc.locate(*q_set[2][0])
    a, b = res["cuda"], res["cpu"]
    check(a.success and a.success == b.success and a.db_index == b.db_index,
          f"card aligned i2i locate (success {a.success}, db {a.db_index}) "
          f"!= CPU (success {b.success}, db {b.db_index})")
    dt = float(np.abs(a.pose.translation - b.pose.translation).max())
    print(f"[i2i-reference] aligned i2i locate card vs CPU: db "
          f"{a.db_index}/{b.db_index}, pose translation max |diff| "
          f"{dt:.2e} m (bound 1e-3 m)")
    check(dt < 1e-3, f"card aligned i2i pose differs by {dt:.3e} m")


def run_i2i(torch, kf_set, q_set, lq_set, card):
    """The four i2i phases at PipelineConfig.i2i() (VGG16, 64 clusters x
    512, FC 32 768 → 512, bf16, 768² BEV)."""
    from gloc3d_tpu_torch import PipelineConfig

    cfg = PipelineConfig.i2i()
    centroids = i2i_centroids(torch, cfg, kf_set)
    model = i2i_model(torch, cfg, "bfloat16", centroids)
    out = phase_i2i_cell(torch, cfg, model, card)
    out["aligned_locate_ms"] = phase_i2i_aligned(torch, cfg, model, kf_set,
                                                 q_set, card)
    out["fused_ms"] = phase_i2i_fused(torch, cfg, centroids, lq_set, card)
    phase_i2i_reference(torch, cfg, kf_set, q_set, centroids)
    return out


# -------------------------------------------------------------- refinement
def refine_cfg(cfg):
    """``cfg`` with the ICP polish at the issue's full-width settings:
    4096-point clouds, 10 iterations, a 1 m gate."""
    return cfg.replace(match=cfg.match.replace(
        refine_icp=True, refine_icp_points=4096, refine_icp_iters=10,
        refine_icp_max_corr=1.0))


def located_errors(results, kf_poses, q_poses):
    """Planar position error of each result against the ground truth
    relative to the keyframe it returns."""
    return [float(np.linalg.norm(r.pose.translation[:2] - relative_pose(
        kf_poses[r.db_index], qp)[0])) for r, qp in zip(results, q_poses)]


def aligned_errors(torch, results, kf_set, q_set):
    """6-DoF position error of each aligned result."""
    from gloc3d_tpu_torch.eval.registration import registration_errors

    (kf_poses, kf_att, _), (q_poses, q_att, _) = kf_set, q_set
    return [float(registration_errors(r.pose, pose6(
        torch, kf_poses[r.db_index], kf_att[r.db_index]).inverse().compose(
        pose6(torch, qp, qa)))[0])
        for r, qp, qa in zip(results, q_poses, q_att)]


def check_tightens(tag, plain, refined):
    print(f"[{tag}] mean position error refined {np.mean(refined):.4f} m "
          f"against unrefined {np.mean(plain):.4f} m (worst "
          f"{max(refined):.4f} / {max(plain):.4f})")
    check(np.mean(refined) <= np.mean(plain),
          f"{tag}: the ICP polish raised the mean position error")


def xy_yaw_diff(a, b) -> float:
    """Largest of |Δdx|, |Δdy| (m) and |Δyaw| (rad, wrapped)."""
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float(max(np.abs(d[:2]).max(),
                     abs(math.remainder(float(d[2]), 2 * math.pi))))


def phase_refine_polish(torch, cfg, lq_set, centroids):
    """(a) on the host-stats located world, fp32 serving model: the ICP
    polish through locate on the host mirror (16 keyframes, 8 queries) at
    the located gates and against the unrefined map's errors; locate =
    locate_batch; match_keyframe on the mirror and on the device store (no
    mirror) = locate for the keyframe locate returns. Returns K1's
    launches on the refined map's build and queries."""
    from gloc3d_tpu_torch.kernels import segment_sum as ss

    (kf_poses, kf), (q_poses, qs) = lq_set
    rcfg = refine_cfg(cfg)
    model = build_serving_model(torch, cfg, "float32", centroids)
    plain = build_map(torch, cfg, model, kf, host_stats=True)
    plain_res = [plain.locate(*q) for q in qs]
    ss.segment_sum_sorted.launches = 0
    mirror = build_map(torch, rcfg, model, kf, host_stats=True)
    results = [mirror.locate(*q) for q in qs]
    k1 = ss.segment_sum_sorted.launches
    print(f"[refine] host stats, fp32: {len(kf)} keyframes with "
          f"{mirror.keyframes[0].cloud.shape[0]}-point clouds, "
          f"{len(qs)} queries; K1 launches {k1}")
    check(k1 >= N_KEYFRAMES // 4 + N_QUERIES, f"K1 launched {k1} times")
    check_located("refine", results, kf_poses, q_poses, cfg.index.top_k)
    check_tightens("refine", located_errors(plain_res, kf_poses, q_poses),
                   located_errors(results, kf_poses, q_poses))

    batch = mirror.locate_batch(np.stack([q[0] for q in qs]),
                                np.stack([q[1] for q in qs]))
    worst = 0.0
    for i, (a, b) in enumerate(zip(batch, results)):
        check(a.success and a.db_index == b.db_index,
              f"refine locate_batch query {i}: db {a.db_index} vs "
              f"{b.db_index}")
        worst = max(worst, xy_yaw_diff(a.match_xy_yaw, b.match_xy_yaw))
    print(f"[refine] locate_batch = locate: same keyframe for {len(qs)}/"
          f"{len(qs)}, (dx, dy, yaw) within {worst:.2e} (bound 1e-4)")
    check(worst <= 1e-4, "refined locate_batch != locate")

    store = build_map(torch, rcfg, model, kf, host_stats=True,
                      device_keyframes=True, host_mirror=False)
    worst = {"mirror": 0.0, "store": 0.0}
    for i, (q, r) in enumerate(zip(qs, results)):
        for name, loc in (("mirror", mirror), ("store", store)):
            m = loc.match_keyframe(*q, db_index=r.db_index)
            check(m.success and m.db_index == r.db_index
                  and list(m.candidates) == [r.db_index],
                  f"match_keyframe ({name}) query {i} failed")
            worst[name] = max(worst[name], xy_yaw_diff(m.match_xy_yaw,
                                                       r.match_xy_yaw))
    print(f"[refine] match_keyframe = locate on the keyframe locate "
          f"returns: host mirror within {worst['mirror']:.2e}, device store "
          f"within {worst['store']:.2e} (bound 1e-4)")
    check(max(worst.values()) <= 1e-4, "match_keyframe != locate")
    times = {name: host_ms(torch, lambda: loc.locate(*qs[0]), 5)
             for name, loc in (("plain", plain), ("refined", mirror))}
    syncs = {name: count_syncs(torch, lambda: loc.locate(*qs[0]))
             for name, loc in (("plain", plain), ("refined", mirror))}
    print(f"[refine] locate, host stats, fp32: {times['refined']:.3f} ms "
          f"with the polish against {times['plain']:.3f} ms without "
          f"(median of 5, host clock); {syncs['refined']} host syncs "
          f"against {syncs['plain']}")
    return k1, times


def phase_refine_aligned(torch, cfg, model, kf_set, q_set, plain_results):
    """(a) on the aligned all-device map (bf16 serving model, the map and
    queries of the aligned phase): 6-DoF gates and the mean 6-DoF position
    error against the aligned phase's unrefined results. Returns K2's
    launches."""
    from gloc3d_tpu_torch.kernels import bin_sums as bs

    bs.pillar_bin_sums.launches = 0
    loc, results = run_aligned(torch, refine_cfg(cfg), model, kf_set[2],
                               q_set[2], host_stats=False)
    k2 = bs.pillar_bin_sums.launches
    need = 2 * (len(kf_set[2]) // 4 + len(q_set[2]))
    print(f"[refine-aligned] clouds in the ground frame; K2 launches {k2} "
          f"(at least {need})")
    check(k2 >= need, f"K2 launched {k2} times, < {need}")
    check_aligned(torch, "refine-aligned", results, kf_set, q_set)
    check_tightens("refine-aligned",
                   aligned_errors(torch, plain_results, kf_set, q_set),
                   aligned_errors(torch, results, kf_set, q_set))
    return k2


def phase_refine_reference(torch, cfg, lq_set, centroids,
                           devices=("cuda", "cpu")):
    """One refined query card vs CPU (fp32, TF32 off, 2 keyframes): same
    success and keyframe, the polished (dx, dy, yaw) within one 0.2 m cell
    (the unrefined seed may differ by one, phase_reference); then the ICP
    alone on the same clouds from the same seed, 0.36 m and 1.1° off the
    polished match, within 1e-2 (a twentieth of a BEV cell): ten steps
    from that seed have not converged, and a nearest neighbour that the
    two devices' summation orders pick differently moves the rest of the
    walk (the first card run read 1.1e-3)."""
    (_, kf), (_, qs) = lq_set
    locs = [build_map(torch, refine_cfg(cfg), build_serving_model(
        torch, cfg, "float32", centroids), kf[:2], host_stats=True,
        device=dev) for dev in devices]
    a, b = (loc.locate(*qs[0]) for loc in locs)
    check(a.success and a.success == b.success
          and a.db_index == b.db_index, "card refined locate != CPU")
    err = xy_yaw_diff(a.match_xy_yaw, b.match_xy_yaw)
    q_cloud, q_valid = locs[1]._query_clouds(qs[0][0][None], qs[0][1][None],
                                             None)
    kc = locs[1].keyframes[b.db_index].cloud
    seed = np.asarray(b.match_xy_yaw) + np.array([0.3, -0.2, 0.02],
                                                 np.float32)
    icp = [loc._refine_icp(q_cloud[0], q_valid[0], kc[:, :3], kc[:, 3],
                           seed) for loc in locs]
    icp_err = xy_yaw_diff(*icp)
    print(f"[refine-reference] card vs CPU: db {a.db_index}/{b.db_index}, "
          f"polished (dx, dy, yaw) within {err:.2e} (bound 0.2 m); ICP "
          f"alone on the same clouds and seed within {icp_err:.2e} (bound "
          f"1e-2), {seed - icp[0]} from the seed")
    check(err <= 0.2 + 1e-3, "card refined pose disagrees with the CPU")
    check(icp_err <= 1e-2, "card ICP disagrees with the CPU ICP")


def phase_refine_slam(torch):
    """(b) the port's SLAM example at the JAX example's size on the card
    (run raises when lap 1 verifies a closure or lap 2 misses its gates)."""
    from gloc3d_tpu_torch.examples import slam_session
    from gloc3d_tpu_torch.kernels import bin_sums as bs

    bs.pillar_bin_sums.launches = 0
    t0 = time.perf_counter()
    out = slam_session.run(device="cuda",
                           log=lambda m: print(f"[refine-slam] {m}"))
    out["seconds"] = time.perf_counter() - t0
    out["k2_launches"] = bs.pillar_bin_sums.launches
    print(f"[refine-slam] {out['closures']}/{out['lap']} closures, worst "
          f"{out['max_pos_err_m']:.3f} m / {out['max_yaw_err_deg']:.2f} deg "
          f"(gates 1 m / 5 deg); {out['seconds']:.1f} s; K2 launches "
          f"{out['k2_launches']}")
    check(out["closures"] >= 0.8 * out["lap"], "SLAM closures")
    return out


def refine_row(torch, card, name, make, compare, iters: int):
    """One refiner at its bench shape: ``make(device)`` → a call returning
    its outputs. CUDA-event ms (mean of ``iters`` after three), a traced
    call's device busy ms, idle share and kernel count, host syncs per
    call, and card vs CPU on the same inputs: ``compare(card, cpu)`` →
    [(label, error, bound)]."""
    fn = make("cuda")
    ms = cuda_ms(torch, fn, iters)
    busy, wall, n_kernels, _ = device_idle_share(torch, fn)
    syncs = count_syncs(torch, fn)
    got = fn()
    torch.cuda.synchronize()
    want = make("cpu")()
    rows = compare(got, want)
    agree = "; ".join(f"{label} {err:.2e} (bound {bound:g})"
                      for label, err, bound in rows)
    print(f"[refine-ops] {name} on {card}: {ms:.3f} ms (CUDA events, mean "
          f"of {iters}); traced: busy {busy:.3f} ms of {wall:.3f} ms, idle "
          f"{1.0 - busy / wall:.3f}, {n_kernels} kernels; {syncs} host "
          f"syncs per call; card vs CPU: {agree}")
    for label, err, bound in rows:
        check(err <= bound, f"{name}: card vs CPU {label} {err:.2e} > "
              f"{bound:g}")
    return {"ms": ms, "busy_ms": busy, "traced_wall_ms": wall,
            "idle_share": 1.0 - busy / wall, "kernels": n_kernels,
            "host_syncs": syncs,
            "card_vs_cpu": {label: [err, bound] for label, err, bound
                            in rows}}


def phase_refine_ops(torch, card, wall_scan):
    """(c) tools/bench_refine.py's five rows at its shapes, on bench.py's
    synthetic scan (100 000 points in a 131 072 pad) and a copy moved by
    (1.2, -0.8, 0.3) m and 0.15 rad, and contour_virtual_cloud on the 768²
    BEV of ``wall_scan`` (a located-world keyframe) with its occupancy
    dilated by a 5×5 window: its walls are one pixel thick, which the
    3×3 erosion would remove whole, and bench.py's uniform scan leaves
    isolated pixels; each beside the same call on the CPU."""
    import torch.nn.functional as F

    from gloc3d_tpu_torch import BEVConfig, MatchConfig
    from gloc3d_tpu_torch.core.transforms import Rigid3, quat_identity
    from gloc3d_tpu_torch.ops import contour, refine
    from gloc3d_tpu_torch.ops.bev import scan_to_bev

    bcfg = BEVConfig(image_size=768)
    pts, mask = (a[0] for a in bench_query_scan(bcfg.max_points))
    pts3 = pts[:, :3].copy()
    yaw = 0.15
    c, s = math.cos(yaw), math.sin(yaw)
    dst3 = pts3.copy()
    dst3[:, 0] = c * pts3[:, 0] - s * pts3[:, 1] + 1.2
    dst3[:, 1] = s * pts3[:, 0] + c * pts3[:, 1] - 0.8
    dst3[:, 2] += 0.3
    sel = np.random.RandomState(0).choice(100000, 4096, replace=False)
    dims, origin = (100, 100, 12), (-50.0, -50.0, -4.0)
    mcfg = MatchConfig(image_size=768, fine_downsample=2,
                       coarse_rot_downsample=8, fine_top_f=4,
                       fine_argmax_downsample=2, coarse_mode="fm")

    def on(dev, *arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrays]

    def bevs(dev):
        p, d, m = on(dev, pts3, dst3, mask)
        return scan_to_bev(p, m, bcfg), scan_to_bev(d, m, bcfg)

    out = {}

    def icp(dev):
        src, dst = on(dev, pts3[sel], dst3[sel])
        ones = torch.ones(4096, device=dev)
        init = Rigid3(quat_identity(device=dev), torch.zeros(3, device=dev))
        return lambda: refine.icp_point_to_point(
            src, ones, dst, ones, init, iterations=20, max_corr_dist=2.0)

    def icp_cmp(a, b):
        dq = min(float((a.transform.rotation.cpu() - s_ * b.transform
                        .rotation).abs().max()) for s_ in (1.0, -1.0))
        return [("quaternion", dq, 1e-3),
                ("translation", float((a.transform.translation.cpu()
                                       - b.transform.translation).abs()
                                      .max()), 1e-3)]

    out["icp_point_to_point"] = refine_row(
        torch, card, "icp_point_to_point (4096 vs 4096, 20 iterations, gate "
        "2.0 m)", icp, icp_cmp, 20)

    def planar(dev):
        q, d = bevs(dev)
        init = torch.tensor([1.2, -0.8, yaw], device=dev)
        return lambda: refine.refine_match_icp(
            q.image, q.origin_xy, d.image, d.origin_xy, init,
            bcfg.resolution, budget=4096, iterations=10)

    out["refine_match_icp"] = refine_row(
        torch, card, "refine_match_icp (768² BEVs, budget 4096, 10 "
        "iterations)", planar, lambda a, b: [
            ("(dx, dy, yaw)", xy_yaw_diff(a.xy_yaw.cpu(), b.xy_yaw), 1e-3),
            ("inliers", float(abs(int(a.num_inliers)
                                  - int(b.num_inliers))), 0)], 20)

    def grid(dev):
        d, m = on(dev, dst3, mask)
        return lambda: refine.build_ndt_grid_3d(d, m, origin, dims, 1.0)

    def grid_cmp(a, b):
        va = a.valid.cpu()
        s_a = float(refine.ndt_score_3d(
            refine.NDTGrid3D(*(x.cpu() if torch.is_tensor(x) else x
                               for x in a)), *on("cpu", pts3, mask),
            torch.zeros(6)))
        s_b = float(refine.ndt_score_3d(b, *on("cpu", pts3, mask),
                                        torch.zeros(6)))
        return [("valid voxels differing", float((va != b.valid).sum()), 0),
                ("means", float((a.mean.cpu()[va] - b.mean[va]).abs()
                                .max()), 1e-4),
                ("score at the zero pose", abs(s_a - s_b), 1e-3)]

    out["build_ndt_grid_3d"] = refine_row(
        torch, card, "build_ndt_grid_3d (131 072-row pad, 100 000 points, "
        "100x100x12 at 1 m)", grid, grid_cmp, 20)
    cpu_grid = grid("cpu")()
    print(f"[refine-ops] NDT map: {int(cpu_grid.valid.sum())} valid voxels "
          f"of {cpu_grid.valid.numel()}")

    def ndt(dev):
        g = refine.NDTGrid3D(*(x.to(dev) if torch.is_tensor(x) else x
                               for x in cpu_grid))
        p, m = on(dev, pts3, mask)
        return lambda: refine.ndt_refine_3d(g, p, m, torch.zeros(
            6, device=dev), iterations=35)

    # the walk's last steps are 4-6 mm long (0.15 m × 0.9^i), each along a
    # normalised gradient that near the optimum follows the summation
    # order: the pose is held to 1e-2, the likelihood to 1e-3
    out["ndt_refine_3d"] = refine_row(
        torch, card, "ndt_refine_3d (35 iterations, the CPU's map on both)",
        ndt, lambda a, b: [
            ("pose", float((a[0].cpu() - b[0]).abs().max()), 1e-2),
            ("score", abs(float(a[1]) - float(b[1])), 1e-3)], 5)

    def sweep(dev):
        p, m = on(dev, pts3, mask)
        d = bevs(dev)[1]
        return lambda: refine.ergodic_rp_sweep_match(
            p, m, d.image, d.origin_xy, bcfg, mcfg)

    cell = bcfg.resolution * mcfg.fine_downsample
    out["ergodic_rp_sweep_match"] = refine_row(
        torch, card, "ergodic_rp_sweep_match (49 BEVs at 768², fm preset)",
        sweep, lambda a, b: [
            ("(roll, pitch)", float((a[1].cpu() - b[1]).abs().max()), 0),
            ("success", float(bool(a[0].success) != bool(b[0].success)), 0),
            ("(dx, dy)", float((a[0].xy_yaw[:2].cpu()
                                - b[0].xy_yaw[:2]).abs().max()),
             cell + 1e-3)], 2)

    def wall_bev(dev):
        p, m = on(dev, wall_scan[0][:, :3], wall_scan[1])
        b = scan_to_bev(p, m, bcfg)
        occ = F.max_pool2d((b.image < 0.5).float()[None, None], 5, 1, 2)
        return 1.0 - occ[0, 0], b.origin_xy

    def blobs(dev):
        image, origin_xy = wall_bev(dev)
        return lambda: contour.contour_virtual_cloud(
            image, origin_xy, bcfg.resolution, budget=4096)

    def blobs_cmp(a, b):
        return [("points", float((a[0].cpu() - b[0]).abs().max()), 0),
                ("validity", float((a[1].cpu() != b[1]).sum()), 0)]

    out["contour_virtual_cloud"] = refine_row(
        torch, card, "contour_virtual_cloud (768² BEV, budget 4096)", blobs,
        blobs_cmp, 20)
    occ = contour.erode3x3(wall_bev("cuda")[0] < 0.5)
    final = contour.connected_components(occ)
    sweeps = next(k for k in range(1, 4096) if torch.equal(
        contour.connected_components(occ, k), final))
    reads = -(-(sweeps + 1) // contour.SWEEPS_PER_READ)
    try:
        F.max_pool2d(torch.zeros((1, 1, 8, 8), dtype=torch.int32,
                                 device="cuda"), 3, 1, 1)
        int_pool = "accepts"
    except RuntimeError as e:
        int_pool = f"refuses ({str(e).splitlines()[0]})"
    print(f"[refine-ops] connected components at 768²: {sweeps} sweeps to "
          f"converge, {reads} reads of the changed flag per call; "
          f"{int((occ > 0.5).sum())} pixels after erosion; CUDA "
          f"max_pool2d on int32 {int_pool} (the port pools float32 labels)")
    out["contour_virtual_cloud"].update(sweeps=sweeps, flag_reads=reads)
    return out


def run_refine(torch, cfg, lq_set, kf_set, q_set, centroids, model,
               aligned_results, card):
    """The [refine] phases: (a) the ICP polish and match_keyframe at full
    width, (b) the SLAM example, (c) the refiners at their bench shapes.
    Returns the JSON record and the kernels' launches on its paths."""
    t0 = time.perf_counter()
    k1, locate_ms = phase_refine_polish(torch, cfg, lq_set, centroids)
    k2 = phase_refine_aligned(torch, cfg, model, kf_set, q_set,
                              aligned_results)
    phase_refine_reference(torch, cfg, lq_set, centroids)
    slam = phase_refine_slam(torch)
    ops = phase_refine_ops(torch, card, lq_set[0][1][0])
    seconds = time.perf_counter() - t0
    print(f"[refine] all phases {seconds:.1f} s")
    return {"locate_ms": locate_ms, "slam": slam, "ops": ops,
            "seconds": seconds}, k1, k2


# ---------------------------------------------------------------- [eval]
EVAL_FRAMES = 50          # one KITTI odometry sequence, ~2 m apart
EVAL_SEQ = "08"
EVAL_BATCH = 8
EVAL_N_VALUES = (1, 5, 10, 20)
EVAL_FAR = (0.0, 95.0, 0.4)   # > 140 m from every frame: no wall in common
# a KITTI-like T_cam0_velo (the calib.txt "Tr"): the axis swap (velodyne
# x forward, z up → camera z forward, y down), a small tilt, the offset
EVAL_TR = np.array([[-0.0018, -0.9999, -0.0125, -0.0047],
                    [-0.0065, 0.0125, -0.9999, -0.0716],
                    [0.9999, -0.0019, -0.0065, -0.3442],
                    [0.0, 0.0, 0.0, 1.0]])


def eval_trajectory(n: int = EVAL_FRAMES):
    """(x, y, yaw) of n frames 2 m apart along y ≈ -55 m, heading swaying
    within ±0.35 rad."""
    poses, x, y = [], -50.0, -55.0
    for i in range(n):
        yaw = 0.35 * math.sin(i / 5.0)
        poses.append((x, y, yaw))
        x, y = x + 2.0 * math.cos(yaw), y + 2.0 * math.sin(yaw)
    return poses


def velo_pose(x, y, yaw) -> np.ndarray:
    t = np.eye(4)
    t[:2, :2] = [[math.cos(yaw), -math.sin(yaw)],
                 [math.sin(yaw), math.cos(yaw)]]
    t[:2, 3] = x, y
    return t


def write_kitti_sequence(world, root: str, n_pad: int):
    """The KITTI odometry layout of one sequence under ``root``:
    sequences/08/velodyne/NNNNNN.bin (float32 x, y, z, intensity of the real
    rows of each walled-world scan), poses/08.txt (cam0 poses: T_w_velo ·
    Tr⁻¹) and sequences/08/calib.txt (P0 and Tr). Returns (velodyne poses
    (N, 4, 4), the padded scans as written, the bytes written)."""
    seq = os.path.join(root, "sequences", EVAL_SEQ)
    os.makedirs(os.path.join(seq, "velodyne"))
    os.makedirs(os.path.join(root, "poses"))
    velo, scans, cam, nbytes = [], [], [], 0
    for i, p in enumerate(eval_trajectory()):
        pts, mask = scan_at(world, p, n_pad, seed=500 + i)
        pts[mask > 0].tofile(os.path.join(seq, "velodyne", f"{i:06d}.bin"))
        nbytes += pts[mask > 0].nbytes
        velo.append(velo_pose(*p))
        cam.append((velo[-1] @ np.linalg.inv(EVAL_TR))[:3].reshape(-1))
        scans.append((pts, mask))
    np.savetxt(os.path.join(root, "poses", f"{EVAL_SEQ}.txt"), np.stack(cam))
    with open(os.path.join(seq, "calib.txt"), "w") as f:
        f.write("P0: " + " ".join(["0.0"] * 12) + "\n")
        f.write("Tr: " + " ".join(f"{v:.12e}" for v in
                                  EVAL_TR[:3].reshape(-1)) + "\n")
    return np.stack(velo), scans, nbytes


def eval_dataset(world, root: str, n_pad: int):
    """Write the sequence, split it (40 db, 10 queries), read it back
    through the port's native loader, and add a query scanned 140 m from
    every frame (no wall in common with any db scan: registration must
    fail)."""
    from gloc3d_tpu_torch.data import kitti

    t0 = time.perf_counter()
    velo, written, nbytes = write_kitti_sequence(world, root, n_pad)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    split = kitti.generate_split(root, sequences=(EVAL_SEQ,), skip_frames=1,
                                 query_fraction=0.2, seed=0)
    ds = kitti.load_split_scans(split, max_points=n_pad)
    t_read = time.perf_counter() - t0
    check((ds.num_db, ds.num_q) == (40, 10),
          f"[eval] split {ds.num_db} db / {ds.num_q} queries, not 40 / 10")
    frame = {f: int(os.path.basename(f)[:6]) for f in
             split.db_files + split.q_files}
    worst, same = 0.0, True
    for files, inputs, masks, poses in (
            (split.db_files, ds.db_inputs, ds.db_masks, ds.db_poses),
            (split.q_files, ds.q_inputs, ds.q_masks, ds.q_poses)):
        for f, x, m, pose in zip(files, inputs, masks, poses):
            pts, mask = written[frame[f]]
            same &= np.array_equal(x, pts) and np.array_equal(m, mask)
            worst = max(worst, float(np.abs(pose - velo[frame[f]]).max()))
    print(f"[eval] wrote {EVAL_FRAMES} scans ({n_pad}-point pad, "
          f"{nbytes / 1e6:.1f} MB) in {t_write:.2f} s; split and read back "
          f"(native loader) in {t_read:.2f} s: {ds.num_db} db, "
          f"{ds.num_q} queries; scans "
          f"bit-equal {same}; velodyne poses through Tr within {worst:.2e} "
          f"(bound 1e-5)")
    check(same, "[eval] the loaded scans differ from the written ones")
    check(worst < 1e-5, f"[eval] velodyne poses off by {worst:.2e}")

    far, far_mask = scan_at(world, EVAL_FAR, n_pad, seed=600)
    far_pose = velo_pose(*EVAL_FAR)
    ds.q_inputs = np.concatenate([ds.q_inputs, far[None]])
    ds.q_masks = np.concatenate([ds.q_masks, far_mask[None]])
    ds.q_poses = np.concatenate([ds.q_poses, far_pose[None]])
    ds.utm_q = np.concatenate([ds.utm_q, far_pose[None, :2, 3]])
    return ds


class BatchRecorder:
    """Keeps the results of every ``locate_batch`` call of a localizer, so
    the evaluator's per-query results can be compared with ``locate``."""

    def __init__(self, loc):
        self.calls, self._real = [], loc.locate_batch
        loc.locate_batch = self

    def __call__(self, *args):
        out = self._real(*args)
        self.calls.append(out)
        return out

    def results(self, nq: int, batch: int):
        """The first nq results, the padding of each batch dropped."""
        return [r for i, rs in enumerate(self.calls)
                for r in rs[: max(0, min(batch, nq - i * batch))]]


def eval_subset(ds, n_db: int, n_q: int):
    from gloc3d_tpu_torch.data.dataset import TripletDataset

    return TripletDataset(
        db_inputs=ds.db_inputs[:n_db], q_inputs=ds.q_inputs[:n_q],
        utm_db=ds.utm_db[:n_db], utm_q=ds.utm_q[:n_q],
        db_masks=ds.db_masks[:n_db], q_masks=ds.q_masks[:n_q],
        db_poses=ds.db_poses[:n_db], q_poses=ds.q_poses[:n_q])


def check_eval_report(tag, report, nq: int, far: int, out_dir: str,
                      overlays, card: str):
    """Gates (b) and (c); the report and its latencies printed.
    ``overlays`` holds the paths the evaluator handed to save_png."""
    reg = report.registration
    print(f"[eval] {tag} report: " + json.dumps(json.loads(
        report.to_json())))
    lat = report.latency_ms
    print(f"[eval] {tag}: db build {lat['db_build_per_scan']:.3f} ms per "
          f"scan, locate {lat['locate_per_query']:.3f} ms per query (p50 "
          f"{lat['locate_per_query_p50']:.3f}, p95 "
          f"{lat['locate_per_query_p95']:.3f} over the batches after the "
          f"first), host clock, batch {EVAL_BATCH}; {card}")
    check(reg["num_total"] == nq, f"[eval] {tag}: num_total "
          f"{reg['num_total']} != {nq}")
    check(reg["success_rate"] >= 2 / 3 and reg["mean_pos_err_m"] < 1.0
          and report.recognition_recall[5] >= 2 / 3,
          f"[eval] {tag}: success {reg['success_rate']:.3f}, mean error "
          f"{reg['mean_pos_err_m']:.3f} m, recall@5 "
          f"{report.recognition_recall[5]:.3f} (gates 2/3, 1 m, 2/3)")
    check(far in report.failed_registration_indices,
          f"[eval] {tag}: the far query {far} registered")
    # npz dumps go to failed detections only (a GT positive, none in the
    # top-k); the far query has no positive, so its dump is the overlay
    fc = os.path.join(out_dir, "failure_cases")
    npz = sorted(f for f in os.listdir(fc) if f.endswith(".npz"))
    want = sorted(f"query_{i}.npz" for i in report.failed_detect_indices[:50])
    check(npz == want, f"[eval] {tag}: npz dumps {npz}, expected {want}")
    for name in npz:
        with np.load(os.path.join(fc, name)) as d:
            check(d["query"].dtype == np.uint8 and d["query"].shape
                  == d["gt_positive"].shape == d["top_prediction"].shape,
                  f"[eval] {tag}: {name}'s arrays")
    rendered = [os.path.basename(p) for p in overlays]
    check(any(r.startswith(f"reg_fail_overlay_{far}_vs_") for r in rendered),
          f"[eval] {tag}: no overlay rendered for the far query: {rendered}")
    for name, listed in (("failed_detect_indices.txt",
                          report.failed_detect_indices),
                         ("failed_registration_indices.txt",
                          report.failed_registration_indices)):
        with open(os.path.join(out_dir, name)) as f:
            got = [int(v) for v in f.read().split()]
        check(got == listed, f"[eval] {tag}: {name} lists {got}")
    try:
        import matplotlib  # noqa: F401
        backend = True
    except ImportError:
        backend = False
    pngs = sorted(f for f in os.listdir(fc) if f.endswith(".png"))
    check(pngs == (sorted(rendered) if backend else []),
          f"[eval] {tag}: overlay PNGs {pngs}, rendered {rendered}, "
          f"matplotlib {'present' if backend else 'absent'}")
    print(f"[eval] {tag}: far query {far} in failed_registration_indices; "
          f"overlays rendered {rendered}, PNGs written {len(pngs)} "
          f"(matplotlib {'present' if backend else 'absent'}); npz dumps "
          f"{npz} (= the failed detections); failed-index files written")


def check_eval_launches(torch, tag, loc, ds):
    """Every K1 / K2 launch of one evaluator batch (locate_batch of the
    first EVAL_BATCH queries) against its plain version."""
    calls = record_launches(lambda: loc.locate_batch(
        ds.q_inputs[:EVAL_BATCH], ds.q_masks[:EVAL_BATCH]))
    parts = []
    for key, launches in calls.items():
        for args in launches:
            label = f"[eval] {tag} {key} {tuple(args[0].shape)}"
            rel = (check_k1(torch, label, *args)[0] if key == "K1"
                   else check_k2(torch, label, *args)[0])
            check(rel < 1e-5, f"{label} disagrees with its plain version: "
                  f"{rel:.3e}")
            parts.append(f"{key} {tuple(args[0].shape)} {rel:.2e}")
    check(parts, f"[eval] {tag}: no kernel launch recorded")
    print(f"[eval] {tag}: every kernel launch of one evaluator batch "
          f"against its plain version, error relative to L1 mass (bound "
          f"1e-5): " + ", ".join(parts))


def run_eval(loc, ds, out_dir=None, batch: int = EVAL_BATCH):
    """evaluate_split on ``loc`` → (report, per-query results, seconds)."""
    from gloc3d_tpu_torch.eval.evaluator import evaluate_split

    rec = BatchRecorder(loc)
    t0 = time.perf_counter()
    report = evaluate_split(loc, ds, out_dir=out_dir, batch=batch,
                            n_values=EVAL_N_VALUES)
    return report, rec.results(ds.num_q, batch), time.perf_counter() - t0


def phase_eval(torch, cfg, world, card, dev: str = "cuda"):
    """[eval]: evaluate_split over a KITTI-layout sequence read from disk,
    on the host-stats (K1) and the aligned all-device (K2) path, with gates
    (a)-(d). Returns the JSON record and both kernels' launches."""
    from gloc3d_tpu_torch.eval import evaluator
    from gloc3d_tpu_torch.kernels import bin_sums as bs
    from gloc3d_tpu_torch.kernels import segment_sum as ss
    from gloc3d_tpu_torch.pipeline import GlobalLocalizer

    t_phase = time.perf_counter()
    n_pad = cfg.voxel.max_points
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        ds = eval_dataset(world, os.path.join(tmp, "kitti"), n_pad)
        nq = ds.num_q
        far = nq - 1
        centroids = vlad_centroids(torch, cfg, list(zip(
            ds.db_inputs[:4], ds.db_masks[:4])), device=dev)
        model = build_serving_model(torch, cfg, "bfloat16", centroids)
        rendered = []
        real_save = evaluator.save_png

        def save_png(path, rgb):
            rendered.append(path)
            return real_save(path, rgb)

        evaluator.save_png = save_png
        paths = {"host-stats": dict(host_stats=True),
                 "aligned all-device": dict(host_stats=False,
                                            align_ground=True)}
        launches = {}
        try:
            for tag, kw in paths.items():
                counter = ss.segment_sum_sorted if kw["host_stats"] else \
                    bs.pillar_bin_sums
                loc = GlobalLocalizer(cfg, model, device=torch.device(dev),
                                      **kw)
                rendered.clear()
                counter.launches = 0
                run_dir = os.path.join(tmp, tag.replace(" ", "_"))
                report, _, _ = run_eval(loc, ds, run_dir)
                launches[tag] = counter.launches
                need = (ds.num_db // EVAL_BATCH + -(-nq // EVAL_BATCH)) * (
                    1 if kw["host_stats"] else 2)
                print(f"[eval] {tag}: "
                      f"{'K1' if kw['host_stats'] else 'K2'} launches "
                      f"{launches[tag]} (at least {need})")
                check(launches[tag] >= need,
                      f"[eval] {tag}: {launches[tag]} launches")
                check_eval_report(tag, report, nq, far, run_dir, rendered,
                                  card)
                check_eval_launches(torch, tag, loc, ds)
                out[tag] = json.loads(report.to_json())
        finally:
            evaluator.save_png = real_save

        # (a) the evaluator adds bookkeeping, not results: on the fp32
        # host-stats map its per-query results equal locate's, query by
        # query (in bf16 the batch of 8 and the batch of 1 may round the
        # descriptors apart and reorder near-tied candidates)
        model32 = build_serving_model(torch, cfg, "float32", centroids)
        loc = GlobalLocalizer(cfg, model32, device=torch.device(dev),
                              host_stats=True)
        _, batched, _ = run_eval(loc, ds)
        single = [loc.locate(ds.q_inputs[i], ds.q_masks[i])
                  for i in range(nq)]
        worst, _ = same_results("[eval] evaluator vs locate", batched,
                                single)
        print(f"[eval] (a) fp32 host stats: the evaluator's {nq} results = "
              f"locate's query by query (success, keyframe, ranked "
              f"candidates; (dx, dy, yaw) within {worst:.2e}, bound 1e-4)")

        # (d) the CPU's run on the first 16 db and 4 query scans
        sub = eval_subset(ds, 16, 4)
        runs = {}
        for d in (dev, "cpu"):
            m = build_serving_model(torch, cfg, "float32", centroids)
            runs[d] = run_eval(GlobalLocalizer(
                cfg, m, device=torch.device(d), host_stats=True), sub,
                batch=4)
        (r_dev, q_dev, _), (r_cpu, q_cpu, t_cpu) = runs[dev], runs["cpu"]
        worst, _ = same_results("[eval] card vs CPU", q_dev, q_cpu,
                                xy_tol=1e-3)
        check(r_dev.failed_detect_indices == r_cpu.failed_detect_indices
              and r_dev.failed_registration_indices
              == r_cpu.failed_registration_indices
              and r_dev.recognition_recall == r_cpu.recognition_recall
              and r_dev.registration["num_success"]
              == r_cpu.registration["num_success"],
              "[eval] card report != CPU report")
        derr = max(abs(r_dev.registration[k] - r_cpu.registration[k])
                   for k in ("mean_pos_err_m", "std_pos_err_m"))
        rerr = max(abs(r_dev.registration[k] - r_cpu.registration[k])
                   for k in ("mean_rot_err_deg", "std_rot_err_deg"))
        print(f"[eval] (d) card vs CPU, fp32, 16 db + 4 queries: same "
              f"candidates, successes and failed indices; (dx, dy, yaw) "
              f"within {worst:.2e}, mean/std errors within {derr:.2e} m / "
              f"{math.radians(rerr):.2e} rad (bounds 1e-3); CPU run "
              f"{t_cpu:.1f} s")
        check(derr <= 1e-3 and math.radians(rerr) <= 1e-3,
              "[eval] card errors differ from the CPU's")
    seconds = time.perf_counter() - t_phase
    print(f"[eval] phase wall time {seconds:.1f} s")
    out["seconds"] = seconds
    return out, launches["host-stats"], launches["aligned all-device"]


# ---------------------------------------------------------------- [submap]
SUBMAP_EXTENT_M = 100.0   # tools/bench_submap.py: ±100 m, z in [-4, 4]
SUBMAP_SWEEPS = 10
SUBMAP_CROP = (128, 640)  # the matcher's 512² centre crop of the 768² BEV
SUBMAP_POINTS = 4096      # the virtual scan
SUBMAP_GT = (4.0, -2.0, 0.35)  # bench_submap.py's offset query, σ 0.10 m


def submap_sweeps(world, n_pts: int):
    """tools/bench_submap.py's ten sweeps, from the poses (1.5 i, 0.4 i) m
    at yaw 0.06 i, i < 10: the walled world's scan at each pose (scan_at,
    the full pad), moved into the frame of sweep 0 as bench_submap.py moves
    its scan; and the sweeps' origins."""
    sweeps, masks = [], []
    for i in range(SUBMAP_SWEEPS):
        pts, mask = scan_at(world, (1.5 * i, 0.4 * i, 0.06 * i), n_pts,
                            seed=300 + i)
        c, s = np.cos(0.06 * i), np.sin(0.06 * i)
        p = pts[:, :3].copy()
        p[:, 0] = c * pts[:, 0] - s * pts[:, 1] + 1.5 * i
        p[:, 1] = s * pts[:, 0] + c * pts[:, 1] + 0.4 * i
        sweeps.append(p)
        masks.append(mask)
    origins = np.array([[1.5 * i, 0.4 * i, 0.0]
                        for i in range(SUBMAP_SWEEPS)], np.float32)
    return sweeps, masks, origins


def offset_query(v, t, alpha, sigma, seed):
    """bench_submap.py's q = R_α⁻¹(v − t) plus N(0, σ) per coordinate:
    matching q against the map recovers (t, α)."""
    c, s = np.cos(alpha), np.sin(alpha)
    q = np.stack([c * (v[:, 0] - t[0]) + s * (v[:, 1] - t[1]),
                  -s * (v[:, 0] - t[0]) + c * (v[:, 1] - t[1])], 1)
    if sigma > 0:
        q = q + np.random.RandomState(seed).normal(0, sigma, q.shape)
    return q.astype(np.float32)


def same_optimum(torch, score_at, grid, pts, mask, got, want,
                 tol: float = 1e-5) -> bool:
    """The same score within tol, and the same pose or a score-tied one."""
    if abs(float(got.score) - float(want.score)) >= tol:
        return False
    if torch.allclose(got.pose.cpu(), want.pose.cpu(), atol=1e-5):
        return True
    refit = float(score_at(grid, pts, mask, got.pose.to(pts.device)))
    return abs(refit - float(want.score)) < tol


def fft_error_probe(torch, grid, vpts, vmask, thetas, coarse_factor=None):
    """cuFFT's correlation against a float64 direct sum on the card: the
    fine FFT at pad 1.5·size (or, with ``coarse_factor``, the coarse bound
    FFT at pad 1.5·size_c) over the batch ``thetas``, at 16 random shifts
    per rotation and at its maximum where that is alias-free
    (|t| < size/2). Returns the largest |FFT − direct| in counts."""
    import torch.nn.functional as F

    from gloc3d_tpu_torch.ops import scan_match as sm

    size = grid.log_odds.shape[0]
    probs = grid.probabilities()
    col, row = sm._cells(thetas, vpts, grid.origin_xy, grid.resolution)
    valid = ((vmask > 0)[None] & (row >= 0) & (row < size) & (col >= 0)
             & (col < size))
    if coarse_factor:  # the matcher's own bound grid and coarse cells
        target = sm._coarse_bounds(probs, coarse_factor)
        q = sm._coarse_cells(col, row, coarse_factor)
        col, row = q[..., 0], q[..., 1]
        size = (size - 1) // coarse_factor + 1
    else:
        target = probs
    n = target.shape[0]
    pad = size + size // 2
    ft = torch.fft.rfft2(F.pad(target, (0, pad - n, 0, pad - n)))
    counts = sm._scatter_counts(torch.stack([col, row], -1), valid, size,
                                out_size=pad)
    corr = sm._fft_corr(counts, ft, pad).reshape(len(thetas), -1)
    gen = torch.Generator(device=corr.device).manual_seed(0)
    half = size // 2
    shifts = torch.randint(-half + 1, half, (len(thetas), 16, 2),
                           generator=gen, device=corr.device)
    best = torch.stack(sm._decode_shift(corr.argmax(-1), pad), -1)
    shifts = torch.cat([shifts, best[:, None]], 1)            # (R, 17, 2)
    ok = (shifts.abs() < half).all(-1)
    ty, tx = shifts[..., 0:1], shifts[..., 1:2]
    rows_t, cols_t = row[:, None] + ty, col[:, None] + tx     # (R, 17, N)
    inb = (valid[:, None] & (rows_t >= 0) & (rows_t < n) & (cols_t >= 0)
           & (cols_t < n))
    flat = (rows_t * n + cols_t).clamp(0, n * n - 1)
    direct = torch.where(inb, target.reshape(-1).double()[flat],
                         0.0).sum(-1)
    got = corr.gather(1, (ty[..., 0] % pad) * pad + tx[..., 0] % pad)
    return float(torch.where(ok, (got.double() - direct).abs(), 0.0).max())


def phase_submap(torch, card, world, dev: str = "cuda",
                 extent=SUBMAP_EXTENT_M):
    """[submap], tools/bench_submap.py's workload: ``Submap3D.insert`` of
    bench.py's 122 480-pad scan (bench_query_scan) and of 10 sweeps of the
    walled world (submap_sweeps) into the dual grid (high 1000×1000×40 at
    0.2 m, low 400×400×16 at 0.5 m), ``project_to_bev`` of
    the 10-sweep high grid to 768², ``match_scan`` and ``match_scan_fast``
    on its 512² centre crop with a 4096-point virtual scan of sweep 0 at
    R = 64, 256 and the local R = 32 ±0.15 rad, fast against exhaustive at
    the Olson-bound R, ``match_full_submap(fallback="full")`` on the
    offset query, ``cmd_match_submap``'s composition (``scan_to_bev`` →
    ``bev_to_virtual_points`` → ``match_full_submap``), the cuFFT error
    probes, and card against CPU (one sweep's insert and projection,
    ``apply_odds`` and ``grid_to_points`` on the crop, bit for bit;
    ``match_scan`` at R = 64, the same optimum). bench.py's scan is uniform noise in a
    box: ten of them overlapped fill nearly every pixel of their footprint,
    and no query can be placed in such a map, so the map is built from
    the world's sweeps, which have walls."""
    from gloc3d_tpu_torch.config import BEVConfig
    from gloc3d_tpu_torch.ops import scan_match as sm
    from gloc3d_tpu_torch.ops.bev import scan_to_bev
    from gloc3d_tpu_torch.ops.occupancy import (
        ProbabilityGrid2D, Submap3D, grid_to_points)
    from gloc3d_tpu_torch.ops.refine import bev_to_virtual_points

    t_phase = time.perf_counter()
    cfg = BEVConfig(z_min=-4.0, z_max=4.0)
    res = cfg.resolution
    sweeps, masks, origins = submap_sweeps(world, 122480)
    out = {"card": card}

    def to_dev(a, d=dev):
        return torch.from_numpy(np.ascontiguousarray(a)).to(d)

    submap0 = Submap3D.create(cfg, extent_xy=extent, device=dev)
    hi, lo = submap0.high.log_odds.shape, submap0.low.log_odds.shape
    bench_pts, bench_mask = bench_query_scan(122480)
    p0, m0, o0 = to_dev(sweeps[0]), to_dev(masks[0]), to_dev(origins[0])
    pb, mb = to_dev(bench_pts[0, :, :3]), to_dev(bench_mask[0])

    def insert():
        return submap0.insert(p0, m0, origin=o0, cfg=cfg)

    out["insert_ms"] = cuda_ms(torch, insert, 10)
    out["insert_bench_scan_ms"] = cuda_ms(
        torch, lambda: submap0.insert(pb, mb, cfg=cfg), 10)
    out["insert_syncs"] = count_syncs(torch, insert)
    busy, wall, n_kernels, _ = device_idle_share(torch, insert)
    out.update(insert_busy_ms=busy, insert_traced_wall_ms=wall,
               insert_kernels=n_kernels)
    one = insert()
    img0, org0 = one.project(cfg)
    sub = submap0
    for p, m, o in zip(sweeps, masks, origins):
        sub = sub.insert(to_dev(p), to_dev(m), origin=to_dev(o), cfg=cfg)
    torch.cuda.synchronize()
    known = int(sub.high.known.sum())
    print(f"[submap] on {card}: grids high {tuple(hi)} at {res} m, low "
          f"{tuple(lo)} at {cfg.low_resolution} m; Submap3D.insert (both "
          f"grids, one 122480-pad sweep; CUDA events, mean of 10): world "
          f"sweep ({int(masks[0].sum())} points) {out['insert_ms']:.3f} ms, "
          f"bench.py's scan (100 000 points) "
          f"{out['insert_bench_scan_ms']:.3f} ms; {out['insert_syncs']} "
          f"host syncs; traced: busy {busy:.3f} ms of {wall:.3f} ms, "
          f"{n_kernels} kernels; {SUBMAP_SWEEPS} sweeps: {known} known "
          f"high-res cells")
    check(known > 0 and sub.num_range_data == SUBMAP_SWEEPS,
          "submap: the sweeps left no known cell")
    check(not bool(submap0.high.known.any()),
          "submap: insert changed the grid passed in")

    def project():
        return sub.project(cfg)

    out["project_ms"] = cuda_ms(torch, project, 10)
    img768, org768 = project()
    print(f"[submap] project_to_bev of the {SUBMAP_SWEEPS}-sweep high grid "
          f"({math.prod(hi)} cells) → {cfg.image_size}²: "
          f"{out['project_ms']:.3f} ms; {int((img768 < 0.5).sum())} "
          f"occupied pixels")

    # one sweep card vs CPU, bit for bit
    cpu0 = Submap3D.create(cfg, extent_xy=extent, device="cpu").insert(
        torch.from_numpy(sweeps[0]), torch.from_numpy(masks[0]),
        origin=torch.from_numpy(origins[0]), cfg=cfg)
    cimg, corg = cpu0.project(cfg)
    same = (torch.equal(one.high.log_odds.cpu(), cpu0.high.log_odds)
            and torch.equal(one.high.known.cpu(), cpu0.high.known)
            and torch.equal(one.low.log_odds.cpu(), cpu0.low.log_odds)
            and torch.equal(one.low.known.cpu(), cpu0.low.known))
    same_img = (torch.equal(img0.cpu(), cimg)
                and torch.equal(org0.cpu(), corg))
    print(f"[submap] one sweep card vs CPU: both grids' log-odds and "
          f"known bit-equal {same}; projection bit-equal {same_img}")
    check(same, "submap: the card's insert differs from the CPU's")
    check(same_img, "submap: the card's projection differs from the CPU's")

    a, b = SUBMAP_CROP
    grid = ProbabilityGrid2D.from_bev_image(
        img768[a:b, a:b], org768 + a * res, res)
    occ = np.argwhere(img0.cpu().numpy() < 0.5)
    sel = np.random.RandomState(0).choice(len(occ), SUBMAP_POINTS,
                                          replace=len(occ) < SUBMAP_POINTS)
    vscan = (occ[sel][:, ::-1] * res + org0.cpu().numpy()[None, :]
             ).astype(np.float32)
    vpts, vmask = to_dev(vscan), torch.ones(SUBMAP_POINTS, device=dev)

    # the 2-D updates card vs CPU, bit for bit: a hit update at the virtual
    # scan's cells (repeats and off-grid cells among them) on the crop, and
    # its occupied cells as a virtual cloud
    cgrid = ProbabilityGrid2D(grid.log_odds.cpu(), grid.known.cpu(),
                              grid.origin_xy.cpu(), res)
    cells = np.round((vscan - (org768.cpu().numpy() + a * res)) / res
                     ).astype(np.int64)
    rows_c, cols_c = torch.from_numpy(cells[:, 1]), torch.from_numpy(
        cells[:, 0])
    ok_c = torch.from_numpy(np.arange(SUBMAP_POINTS) % 7 != 0)
    hit = grid.apply_odds(rows_c.to(dev), cols_c.to(dev), ok_c.to(dev), 0.55)
    chit = cgrid.apply_odds(rows_c, cols_c, ok_c, 0.55)
    gp = grid_to_points(hit.probabilities(), hit.origin_xy, res,
                        max_points=8192)
    cgp = grid_to_points(chit.probabilities(), chit.origin_xy, res,
                         max_points=8192)
    same_odds = (torch.equal(hit.log_odds.cpu(), chit.log_odds)
                 and torch.equal(hit.known.cpu(), chit.known))
    same_pts = all(torch.equal(x.cpu(), y) for x, y in zip(gp, cgp))
    off = int(((cells < 0) | (cells >= b - a)).any(1).sum())
    print(f"[submap] card vs CPU on the {b - a}² grid: apply_odds "
          f"({int(ok_c.sum())} of {SUBMAP_POINTS} lanes valid, {off} "
          f"off the grid) bit-equal {same_odds}; grid_to_points "
          f"({int(gp[1].sum())} points) bit-equal {same_pts}")
    check(same_odds, "submap: the card's apply_odds differs from the CPU's")
    check(same_pts, "submap: the card's grid_to_points differs from the "
          "CPU's")
    out["card_vs_cpu_bit_equal"] = (same and same_img and same_odds
                                    and same_pts)

    rows = {}
    for tag, nrot, hw in (("R=64", 64, math.pi), ("R=256", 256, math.pi),
                          ("local R=32 ±0.15 rad", 32, 0.15)):
        def exact(nrot=nrot, hw=hw):
            return sm.match_scan(grid, vpts, vmask, num_rotations=nrot,
                                 angular_halfwidth=hw)

        def fast(nrot=nrot, hw=hw):
            return sm.match_scan_fast(grid, vpts, vmask, num_rotations=nrot,
                                      angular_halfwidth=hw)

        e_ms, f_ms = cuda_ms(torch, exact, 5), cuda_ms(torch, fast, 5)
        e, (fr, cert) = exact(), fast()
        cert = bool(cert)
        agree = same_optimum(torch, sm.score_at, grid, vpts, vmask, fr, e)
        rows[tag] = {"match_scan_ms": e_ms, "match_scan_fast_ms": f_ms,
                     "certified": cert, "same_optimum": agree,
                     "score": float(e.score),
                     "pose": [float(x) for x in e.pose.cpu()]}
        pose = e.pose.cpu().numpy()
        print(f"[submap] {tag} on the {b - a}² grid, {SUBMAP_POINTS} points:"
              f" match_scan {e_ms:.3f} ms, match_scan_fast {f_ms:.3f} ms; "
              f"pose ({pose[0]:+.2f}, {pose[1]:+.2f}, "
              f"{math.degrees(pose[2]):+.2f}°) score {float(e.score):.4f}; "
              f"fast certified {cert}, same optimum {agree}")
        check(not cert or agree, f"submap {tag}: a certified fast result "
              "is not the exhaustive optimum")
    out["match"] = rows

    # match_scan at R = 64 card vs CPU
    want = sm.match_scan(cgrid, vpts.cpu(), vmask.cpu(), num_rotations=64)
    got = sm.match_scan(grid, vpts, vmask, num_rotations=64)
    agree = same_optimum(torch, sm.score_at, cgrid, vpts.cpu(), vmask.cpu(),
                         got, want)
    print(f"[submap] match_scan R=64 card vs CPU: scores "
          f"{float(got.score):.6f} / {float(want.score):.6f}, same "
          f"optimum {agree}")
    check(agree, "submap: the card's match_scan optimum differs from the "
          "CPU's")

    # the Olson-bound rotation count at the virtual scan's range
    r_max = float(np.linalg.norm(vscan, axis=1).max())
    step = sm.olson_angular_step(res, r_max)
    n_rot = int(math.ceil(2 * math.pi / step))
    k = max(128, min(n_rot, 2048))
    q0 = to_dev(offset_query(vscan, SUBMAP_GT[:2], SUBMAP_GT[2], 0.10, 100))

    def olson_fast():
        return sm.match_scan_fast(grid, q0, vmask, num_rotations=n_rot,
                                  num_candidates=k)

    def olson_exact():
        return sm.match_scan(grid, q0, vmask, num_rotations=n_rot)

    of_ms, oe_ms = cuda_ms(torch, olson_fast, 3), cuda_ms(torch, olson_exact,
                                                          3)
    (ofr, ocert), oe = olson_fast(), olson_exact()
    o_agree = same_optimum(torch, sm.score_at, grid, q0, vmask, ofr, oe)
    out["olson"] = {"r_max_m": r_max, "step_rad": step, "rotations": n_rot,
                    "num_candidates": k, "fast_ms": of_ms,
                    "exhaustive_ms": oe_ms, "certified": bool(ocert),
                    "same_optimum": o_agree,
                    "fast_score": float(ofr.score),
                    "exhaustive_score": float(oe.score)}
    print(f"[submap] Olson bound at r_max {r_max:.1f} m: dθ "
          f"{math.degrees(step):.4f}°, R = {n_rot}; offset query: "
          f"match_scan_fast (K={k}) {of_ms:.3f} ms, certified "
          f"{bool(ocert)}, score {float(ofr.score):.4f}; exhaustive "
          f"{oe_ms:.3f} ms ({-(-n_rot // sm.rotation_chunk_for(
              (b - a) * 3 // 2))} FFT batches), score {float(oe.score):.4f}; same optimum {o_agree}")
    check(not bool(ocert) or o_agree, "submap Olson R: a certified fast "
          "result is not the exhaustive optimum")

    def gt_err(pose, n):
        p = pose.cpu().numpy()
        dyaw = math.remainder(float(p[2]) - SUBMAP_GT[2], 2 * math.pi)
        return (abs(p[0] - SUBMAP_GT[0]), abs(p[1] - SUBMAP_GT[1]),
                abs(dyaw), 2 * math.pi / n)

    def check_gt(tag, pose, n):
        ex, ey, eyaw, dth = gt_err(pose, n)
        ok = ex <= res + 1e-4 and ey <= res + 1e-4 and eyaw <= dth + 1e-6
        print(f"[submap] {tag}: error ({ex:.3f}, {ey:.3f}) m, "
              f"{math.degrees(eyaw):.4f}° (gates one cell {res} m, one "
              f"step {math.degrees(dth):.4f}°)")
        check(ok, f"submap {tag}: the offset query was not recovered")
        return [float(ex), float(ey), float(eyaw)]

    def full_submap():
        return sm.match_full_submap(grid, q0, vmask, fallback="full")

    fs_ms = host_ms(torch, full_submap, 3)
    fs = full_submap()
    n_fs = int(math.ceil(2 * math.pi / sm.olson_angular_step(res, 50.0)))
    busy, wall, n_kernels, _ = device_idle_share(torch, full_submap)
    out["full_submap"] = {
        "ms": fs_ms, "rotations": n_fs, "certified": fs.certified,
        "used_fallback": fs.used_fallback, "score": float(fs.score),
        "busy_ms": busy, "traced_wall_ms": wall, "kernels": n_kernels,
        "gt_error": check_gt(
            f"match_full_submap(fallback='full'), R = {n_fs}, host "
            f"{fs_ms:.3f} ms, certified {fs.certified}, fallback "
            f"{fs.used_fallback}, traced busy {busy:.3f} of {wall:.3f} ms "
            f"({n_kernels} kernels)", fs.pose, n_fs)}

    # cmd_match_submap: a raw query scan → its BEV → a virtual scan → match
    c, s = math.cos(SUBMAP_GT[2]), math.sin(SUBMAP_GT[2])
    q3 = sweeps[0].copy()
    dx, dy = sweeps[0][:, 0] - SUBMAP_GT[0], sweeps[0][:, 1] - SUBMAP_GT[1]
    q3[:, 0], q3[:, 1] = c * dx + s * dy, -s * dx + c * dy

    def composed():
        bev = scan_to_bev(to_dev(q3), m0, cfg)
        pts, valid = bev_to_virtual_points(bev.image, bev.origin_xy, res,
                                           SUBMAP_POINTS)
        return sm.match_full_submap(grid, pts, valid, fallback="full")

    cm_ms = host_ms(torch, composed, 3)
    cm = composed()
    out["composed"] = {"ms": cm_ms, "score": float(cm.score),
                       "gt_error": check_gt(
                           f"cmd_match_submap composition, host "
                           f"{cm_ms:.3f} ms, score {float(cm.score):.4f}",
                           cm.pose, n_fs)}

    # cuFFT against float64 direct sums at the phase's shapes: the fine FFT
    # over one default batch of Olson rotations, the coarse bound FFT over
    # all of them in one batch
    thetas = sm.rotation_grid(n_rot, 0.0, math.pi, dev)
    size = b - a
    size_c = (size - 1) // 4 + 1
    pad, pad_c = size + size // 2, size_c + size_c // 2
    chunk, chunk_c = sm.rotation_chunk_for(pad), sm.rotation_chunk_for(pad_c)
    fine = fft_error_probe(torch, grid, q0, vmask, thetas[:chunk])
    coarse = fft_error_probe(torch, grid, q0, vmask, thetas[:chunk_c],
                             coarse_factor=4)
    out["fft_error_counts"] = {"fine": fine, "coarse": coarse}
    print(f"[submap] cuFFT vs float64 direct sums: fine (pad {pad}, batch "
          f"{min(chunk, n_rot)}) max {fine:.2e} counts, coarse (pad {pad_c}, "
          f"batch {min(chunk_c, n_rot)}) max {coarse:.2e} counts; the "
          f"certificate's slack is 0.05")
    check(max(fine, coarse) < 0.05, "submap: cuFFT error reaches the "
          "certificate slack")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[submap] phase {out['seconds']:.1f} s")
    return out


# ------------------------------------------------------ kernel-only times
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12     # H100 SXM fp32 outside the tensor cores


def least_ms(n_bytes: float, n_ops: float):
    """The least time the card could take for work that moves ``n_bytes``
    and does ``n_ops`` fp32 operations: (ms, "bytes" or "operations")."""
    t_mem, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return max(t_mem, t_ops) * 1e3, "bytes" if t_mem >= t_ops else \
        "operations"


def k1_work(x, starts):
    """K1's bytes (values and starts read once, sums written once) and
    adds."""
    b, n, c = x.shape
    v = starts.shape[-1] - 1
    return 4 * (b * n * c + b * (v + 1) + b * v * c), b * n * c


def k2_work(x, ids, v):
    """K2's bytes (features and ids read once, sums and counts written
    once) and adds."""
    b, n, c = x.shape
    return 4 * (b * n * c + b * n + b * v * c + b * v), b * n * (c + 1)


def kernel_device_ms(torch, fn, frag: str, iters: int, flush=None,
                     per_call: int = 2, attempts: int = 6):
    """Device time per call of fn() spent in kernels whose name holds
    ``frag``, from a complete torch.profiler trace of ``iters`` calls
    (after three untraced ones): the wrapper's host work, its fills and its
    checks are out of it. With ``flush`` the L2 cache is overwritten before
    each call. A trace is complete when it holds ``per_call`` kernel names
    (each of K1 and K2 launches two kernels a call), each ``iters`` times.
    A trace's first events now and then go missing (late in a full smoke
    more often), so each trace records a second run of the calls after a
    profiler warm-up run (``schedule(warmup=1, active=1)``), and up to
    ``attempts`` traces are taken, with the CPU side traced and not in
    turns. Returns (ms per call, {kernel name: ms per call}), or (None,
    kernels kept per call in the fullest trace) when no trace was
    complete."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    kept = 0.0
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA] + (
                [ProfilerActivity.CPU] if attempt % 2 == 0 else []),
                schedule=schedule(wait=0, warmup=1, active=1,
                                  repeat=1)) as prof:
            for _ in range(2):
                for _ in range(iters):
                    if flush is not None:
                        flush.zero_()
                    fn()
                torch.cuda.synchronize()
                prof.step()
        seen = {}
        for e in trace_events(prof):
            if e.get("cat") == "kernel" and frag in e.get("name", ""):
                total, count = seen.get(e["name"], (0.0, 0))
                seen[e["name"]] = (total + e.get("dur", 0), count + 1)
        kept = max(kept, sum(c for _, c in seen.values()) / iters)
        if len(seen) == per_call and all(c == iters
                                         for _, c in seen.values()):
            by_name = {name: total / iters / 1e3
                       for name, (total, _) in seen.items()}
            return sum(by_name.values()), by_name
        print(f"[kernel-times] an incomplete trace of *{frag}*: "
              f"{len(seen)} kernel names, {kept:g} of {per_call} kernels "
              f"a call kept")
    return None, kept


def segment_reduce_call(torch, x, starts):
    """K1's function as one PyTorch call, for its time only (the port never
    calls it): ``torch.segment_reduce`` over the batch flattened into one
    row axis, every item's offsets shifted by its first row."""
    b, n, c = x.shape
    check(bool((starts[:, -1] == n).all()), "segment_reduce_call needs "
          "every row in a segment")
    offs = torch.cat([
        (starts[:, :-1].long()
         + n * torch.arange(b, device=x.device)[:, None]).reshape(-1),
        torch.tensor([b * n], device=x.device)])
    flat = x.reshape(b * n, c)
    v = starts.shape[-1] - 1
    return lambda: torch.segment_reduce(
        flat, "sum", offsets=offs, axis=0, unsafe=True).reshape(b, v, c)


def index_add_call(torch, x, ids, v):
    """K2's function as PyTorch calls, for their time only (the port never
    calls them): an fp32 ``index_add_`` into zeroed sums and a
    ``bincount`` over batch-offset ids."""
    b, n, c = x.shape
    flat = (ids.long() + v * torch.arange(b, device=x.device)[:, None]
            ).reshape(-1)
    rows = x.reshape(b * n, c)

    def call():
        sums = torch.zeros((b * v, c), device=x.device).index_add_(
            0, flat, rows)
        return (sums.reshape(b, v, c),
                torch.bincount(flat, minlength=b * v).reshape(b, v))
    return call


def phase_kernel_times(torch, card, k1_cases, k2_cases):
    """Each kernel alone at the main path's and the train step's shapes:
    its device time from a complete torch.profiler trace (L2-warm and
    L2-flushed, mean of 20 calls each), beside its bound, the wrapper's and
    the plain version's time (CUDA events, L2-warm; K2's wrapper with and
    without its id-range check, and the check alone), and the time of the
    PyTorch call that computes the same function (K1:
    ``torch.segment_reduce``; K2: fp32 ``index_add_`` + ``bincount``), held
    once to the plain version first."""
    from gloc3d_tpu_torch.kernels import bin_sums as bs
    from gloc3d_tpu_torch.kernels import segment_sum as ss

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    kinds = {
        "K1": (ss._launch, ss.segment_sum_sorted, segment_reduce_call,
               k1_work, "segment_sum_sorted", k1_cases),
        "K2": (bs._launch, bs.pillar_bin_sums, index_add_call, k2_work,
               "pillar_bin_sums", k2_cases),
    }
    out = {}
    for key, (launch, wrapper, library, work, frag, cases) in kinds.items():
        out[key] = {}
        for label, args in cases.items():
            lib_fn = library(torch, *args)
            got = lib_fn()
            plain = (ss.segment_sum_sorted_plain if key == "K1"
                     else lambda *a: bs.pillar_bin_sums_plain(*a)[0])
            want, l1 = plain(*args), plain(args[0].abs(), *args[1:])
            if key == "K2":
                check(torch.equal(got[1].float(),
                                  bs.pillar_bin_sums_plain(*args)[1]),
                      f"{key} library call {label}: counts differ")
                got = got[0]
            lib_err = float(((got - want).double().abs()
                             / l1.double().clamp_min(1e-30)).max())
            # an fp32 scatter drifts on pillar 0's ~82 000 rows (the plain
            # version accumulates in fp64): a sanity bound, not a tolerance
            check(lib_err < 1e-3, f"{key} library call {label} disagrees "
                  f"with the plain version: {lib_err:.3e} of L1 mass")
            warm = kernel_device_ms(torch, lambda: launch(*args), frag, 20)
            cold = kernel_device_ms(torch, lambda: launch(*args), frag, 20,
                                    flush)
            r = {"shape": list(args[0].shape),
                 "kernel_only_ms": cold[0], "kernel_only_warm_ms": warm[0],
                 "wrapper_ms": cuda_ms(torch, lambda: wrapper(*args), 50),
                 "library_ms": cuda_ms(torch, lib_fn, 20, flush),
                 "library_warm_ms": cuda_ms(torch, lib_fn, 50),
                 "plain_warm_ms": cuda_ms(torch, lambda: plain(*args), 5)}
            r["bound_ms"], r["bound_by"] = least_ms(*work(*args))
            extra = ""
            if key == "K2":
                r["wrapper_no_check_ms"] = cuda_ms(
                    torch, lambda: launch(*args), 50)
                r["check_ms"] = cuda_ms(torch, lambda: bs._check(*args), 50)
                extra = (f"; wrapper without the id-range check "
                         f"{r['wrapper_no_check_ms']:.4f} ms, the check "
                         f"alone {r['check_ms']:.4f} ms")
            # each kernel's second launch adds per-block partials: K2's of
            # pillar 0, K1's of blocks wholly inside one segment
            second = "pillar0" if key == "K2" else "partials"

            def timed(t, cache):
                return (f"{t[0]:.4f} ms {cache}" if t[0] is not None else
                        f"not measured {cache} (no complete trace in six: "
                        f"the fullest kept {t[1]:g} of 2 kernels a call)")

            kernel = (f"kernel only {timed(cold, 'L2-flushed')} / "
                      f"{timed(warm, 'L2-warm')} (torch.profiler, both "
                      f"kernels of every traced call)")
            if cold[0] is not None:
                r[f"{second}_ms"] = sum(ms for name, ms in cold[1].items()
                                        if second in name)
                kernel += (f", of it the {second} launch "
                           f"{r[f'{second}_ms']:.4f} ms flushed, "
                           f"{r['bound_ms'] / cold[0]:.1%} of the bound")
            print(f"[kernel-times] {key} {label} {tuple(args[0].shape)} on "
                  f"{card}: {kernel}; bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}); wrapper "
                  f"{r['wrapper_ms']:.4f} ms L2-warm{extra}; library call "
                  f"{r['library_ms']:.4f} ms L2-flushed / "
                  f"{r['library_warm_ms']:.4f} ms L2-warm (CUDA events; "
                  f"{lib_err:.1e} of L1 mass from the plain version); plain "
                  f"version {r['plain_warm_ms']:.4f} ms L2-warm")
            out[key][label] = r
    return out


# -------------------------------------------------------------- training
def training_dataset(world, n: int):
    """A synthetic TripletDataset in the walled world: 24 db scans on a 6×4
    grid at 12 m spacing, 8 queries within 3 m of a db scan, random
    headings, every scan padded to n rows. Each query has a db scan within
    10 m (a nontrivial positive) and at least 15 beyond 20 m (negatives)."""
    from gloc3d_tpu_torch.data import dataset

    rng = np.random.RandomState(21)
    db_poses = [(x, y, rng.uniform(-np.pi, np.pi))
                for x in np.arange(6) * 12.0 - 30.0
                for y in np.arange(4) * 12.0 - 18.0]
    near = rng.choice(len(db_poses), N_TRAIN_Q, replace=False)
    q_poses = [(db_poses[j][0] + rng.uniform(-3, 3),
                db_poses[j][1] + rng.uniform(-3, 3),
                rng.uniform(-np.pi, np.pi)) for j in near]
    db = [scan_at(world, p, n, seed=500 + i) for i, p in enumerate(db_poses)]
    qs = [scan_at(world, p, n, seed=600 + i) for i, p in enumerate(q_poses)]
    ds = dataset.TripletDataset(
        db_inputs=np.stack([s[0] for s in db]),
        q_inputs=np.stack([s[0] for s in qs]),
        utm_db=np.array([p[:2] for p in db_poses]),
        utm_q=np.array([p[:2] for p in q_poses]),
        db_masks=np.stack([s[1] for s in db]),
        q_masks=np.stack([s[1] for s in qs]))
    check(bool(ds.nontrivial_positives(10.0).any(1).all())
          and int(ds.potential_negatives(20.0).sum(1).min()) >= 15,
          "training world: a query lacks a positive or negatives")
    return ds


def training_model(torch, cfg, ds, device, compute_dtype=None):
    """The trainable model (fold_bn=False): the port's seeded init, then
    NetVLAD initialised from the db scans' encoder features (the ported
    cluster mode)."""
    from gloc3d_tpu_torch.models.descriptor import build_model, init_params
    from gloc3d_tpu_torch.train import init_vlad_from_data

    mc = cfg.model.replace(fold_bn=False)
    if compute_dtype is not None:
        mc = mc.replace(compute_dtype=compute_dtype)
    model = init_params(build_model(mc, cfg.voxel), seed=0).to(device)
    init_vlad_from_data(cfg.replace(model=mc), model, ds.db_inputs,
                        ds.db_masks, torch.Generator().manual_seed(0),
                        num_images=len(ds.db_inputs), per_image=100)
    return model


def timed(torch, fn, log):
    """fn with each call's CUDA-event ms appended to ``log`` (calls that
    return None, a skipped batch, are not logged)."""
    def wrapper(*args, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn(*args, **kw)
        e1.record()
        torch.cuda.synchronize()
        if out is not None:
            log.append((e0.elapsed_time(e1), len(args[0])))
        return out
    return wrapper


def check_train_launches(torch, path, launches, host_stats):
    """Hold every K1 / K2 launch recorded from one cache batch of 8 and one
    train step of 24 scans to the plain versions (record_launches)."""
    want = {"K1": 2, "K2": 0} if host_stats else {"K1": 0, "K2": 4}
    got = {key: len(calls) for key, calls in launches.items()}
    check(got == want, f"{path}: recorded launches {got}, expected {want}")
    parts = []
    for key, calls in launches.items():
        for args in calls:
            label = f"{path} {key} {tuple(args[0].shape)}"
            rel = (check_k1(torch, label, *args)[0] if key == "K1"
                   else check_k2(torch, label, *args)[0])
            check(rel < 1e-5, f"{label} disagrees with its plain version: "
                  f"{rel:.3e}")
            parts.append(f"{key} {tuple(args[0].shape)} {rel:.2e}")
    print(f"[train] {path}: every kernel launch of one cache batch and one "
          f"train step against its plain version, error relative to L1 "
          f"mass (bound 1e-5"
          + ("" if host_stats else "; K2 counts exactly equal") + "): "
          + ", ".join(parts))


def phase_training(torch, cfg, ds, card):
    """On each train path at full width: one epoch (cache refresh and its
    steps: the main path, counted); the kernel launches of one cache batch
    and one step held to the plain versions; two epochs timed around the
    whole step only; the step's split in a separate pass; one traced
    step."""
    from gloc3d_tpu_torch.kernels import bin_sums as bs
    from gloc3d_tpu_torch.kernels import segment_sum as ss
    from gloc3d_tpu_torch.train import Trainer

    dev = torch.device("cuda")
    tcfg = cfg.replace(model=cfg.model.replace(fold_bn=False),
                       train=cfg.train.replace(cache_refresh_rate=N_TRAIN_Q))
    b, n_neg = tcfg.train.batch_size, tcfg.train.n_neg
    cache_batches = sum(math.ceil(len(a) / 8)
                        for a in (ds.db_inputs, ds.q_inputs))
    counts = {}
    for host_stats in (False, True):
        path = "host-stats" if host_stats else "all-device"
        c = tcfg.replace(train=tcfg.train.replace(host_stats=host_stats))
        model = training_model(torch, c, ds, dev)
        with tempfile.TemporaryDirectory() as workdir:
            tr = Trainer(c, model, ds, workdir, device=dev)
            before = {k: p.detach().clone()
                      for k, p in model.named_parameters()}
            torch.cuda.reset_peak_memory_stats()
            ss.segment_sum_sorted.launches = 0
            bs.pillar_bin_sums.launches = 0
            ss.segment_sum_sorted_grad.backward_calls = 0
            bs.pillar_bin_sums_grad.backward_calls = 0
            loss = tr.train_epoch(1)
            k1 = ss.segment_sum_sorted.launches
            k2 = bs.pillar_bin_sums.launches
            k1_bwd = ss.segment_sum_sorted_grad.backward_calls
            k2_bwd = bs.pillar_bin_sums_grad.backward_calls
            n_steps = tr.step
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"[train] {path}: epoch 1 over {N_TRAIN_Q} queries "
                  f"(batch {b}, {b * (2 + n_neg)} clouds x "
                  f"{ds.db_inputs.shape[1]} points per step): {n_steps} "
                  f"steps, mean loss {loss:.5f}; launches K1 {k1}, K2 {k2}; "
                  f"backward calls K1 {k1_bwd}, K2 {k2_bwd}")
            check(n_steps >= 3, f"{path}: only {n_steps} train steps ran")
            check(math.isfinite(loss) and loss > 0, f"{path}: loss {loss}")
            want = ((0, 2 * (cache_batches + n_steps), 0, n_steps)
                    if not host_stats else
                    (cache_batches + n_steps, 0, n_steps, 0))
            check((k1, k2, k1_bwd, k2_bwd) == want,
                  f"{path}: (K1, K2, K1 backward, K2 backward) = "
                  f"{(k1, k2, k1_bwd, k2_bwd)}, expected {want}")
            zero = [k for k, p in model.named_parameters()
                    if k.startswith("encoder.") and (
                        p.grad is None or float(p.grad.abs().max()) == 0.0)]
            check(not zero, f"{path}: zero gradient for {zero}")
            same = [k for k, p in model.named_parameters()
                    if torch.equal(p.detach(), before[k])]
            check(not same, f"{path}: parameters unchanged: {same}")
            pn = model.encoder.pn.pointnet[0].weight.grad
            print(f"[train] {path}: all {len(before)} parameters changed; "
                  f"every encoder parameter has a nonzero gradient (PointNet "
                  f"weight max |grad| {float(pn.abs().max()):.3e}); peak "
                  f"device memory {peak:.2f} GiB on {card}")
            counts[path] = (k1, k2)

            cache_db = tr.compute_cache(ds.db_inputs, ds.db_masks)
            cache_q = tr.compute_cache(ds.q_inputs, ds.q_masks)

            def one_step():
                check(tr._train_batch(np.arange(b), cache_db, cache_q)
                      is not None, f"{path}: the probe batch took no step")

            check_train_launches(torch, path, record_launches(lambda: (
                tr.compute_cache(ds.db_inputs[:8], ds.db_masks[:8]),
                one_step())), host_stats)

            # the whole step and the cache refresh, timed from the outside
            # only: the step ends in the trainer's own sync (float(loss))
            steps, caches = [], []
            tr._train_batch = timed(torch, tr._train_batch, steps)
            tr.compute_cache = timed(torch, tr.compute_cache, caches)
            for epoch in (2, 3):
                tr.train_epoch(epoch)
            del tr._train_batch, tr.compute_cache
            step_ms = float(np.median([s[0] for s in steps]))
            cache_ms = sum(s[0] for s in caches) / sum(s[1] for s in caches)
            # the split, in a separate pass (its wrappers add syncs)
            inner, host = [], []
            tr._host_sorted = timed(torch, tr._host_sorted, host)
            tr.train_step = timed(torch, tr.train_step, inner)
            tr.train_step_hs = timed(torch, tr.train_step_hs, inner)
            for _ in range(3):
                one_step()
            del tr._host_sorted, tr.train_step, tr.train_step_hs
            dev_ms = float(np.median([s[0] for s in inner]))
            host_ms = float(np.median([s[0] for s in host])) if host else 0.0
            print(f"[train] {path} on {card}: {step_ms:.2f} ms per train "
                  f"step (mining, gather, "
                  f"{'host pass, ' if host_stats else ''}upload, forward, "
                  f"backward, SGD; CUDA events around the whole step only, "
                  f"median of {len(steps)} warm steps of epochs 2-3); split "
                  f"in a separate pass of 3 steps with syncs between the "
                  f"parts: {dev_ms:.2f} ms in "
                  f"{'train_step_hs' if host_stats else 'train_step'}, "
                  f"{host_ms:.2f} ms in the host pass of the step's "
                  f"{b * (2 + n_neg)} scans; cache refresh {cache_ms:.3f} ms "
                  f"per scan ({sum(s[1] for s in caches)} scans in batches "
                  f"of 8)")
            busy, wall, n_k, by_class = device_idle_share(torch, one_step)
            print(f"[train] {path}: traced train step on {card}: device busy "
                  f"{busy:.2f} ms of {wall:.2f} ms wall, idle share "
                  f"{1 - busy / wall:.3f}, {n_k} kernels (torch.profiler; "
                  f"against the untraced {step_ms:.2f} ms the idle share is "
                  f"{1 - busy / step_ms:.3f}); device ms by class: "
                  + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
                      by_class.items(), key=lambda kv: -kv[1])))
    return counts


def train_kernel_inputs(torch, cfg, ds):
    """Both kernels' inputs at the train step's shape, from the first 24 db
    scans: K1's pillar-sorted ``ids`` and ``starts`` from the host pass; the
    device binning's ``vox`` (``points_to_voxels``: ids, raw counts, V) and
    its statistics ``payload`` (24, N, 4); random features ``x`` (24, N,
    64)."""
    from gloc3d_tpu_torch.data import native
    from gloc3d_tpu_torch.ops.voxelize import points_to_voxels

    dev = torch.device("cuda")
    vc = cfg.voxel
    b = cfg.train.batch_size * (2 + cfg.train.n_neg)
    pts, mask = ds.db_inputs[:b], ds.db_masks[:b]
    host = native.compute_voxel_stats_host_sorted(
        pts, mask.sum(1).astype(np.int64), vc.xbound, vc.ybound, vc.zbound,
        crop=False)
    ids, starts = (torch.from_numpy(host[i]).to(dev) for i in (2, 5))
    p_d = torch.from_numpy(pts).to(dev)
    m_d = torch.from_numpy(mask).to(dev)
    vox = points_to_voxels(p_d[..., :3], m_d, vc.xbound, vc.ybound,
                           vc.zbound)
    payload = torch.cat([vox["points_mask"][..., None], p_d[..., :3]],
                        dim=-1).contiguous()
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((b, pts.shape[1], 64), generator=gen, device=dev)
    return {"ids": ids, "starts": starts, "vox": vox, "payload": payload,
            "x": x}


def phase_train_kernels(torch, cfg, ds, card):
    """Each kernel's autograd Function against autograd through its plain
    version, on the card at the train step's shape (24, 122480, 64) with
    real pillar layouts: K1 on the host pass's sorted ids, K2 on the device
    binning's ids. The forward per pillar relative to its L1 mass (bound
    1e-5), the gradient exactly (bound 1e-6), and both backward times."""
    from gloc3d_tpu_torch.kernels import bin_sums as bs
    from gloc3d_tpu_torch.kernels import segment_sum as ss
    from gloc3d_tpu_torch.ops.voxelize import scatter_mean_to_grid

    dev = torch.device("cuda")
    t = train_kernel_inputs(torch, cfg, ds)
    ids, starts, vox, x = t["ids"], t["starts"], t["vox"], t["x"]
    b, v = x.shape[0], vox["num_voxels"]
    pts = ds.db_inputs[:b]
    gen = torch.Generator(device=dev).manual_seed(4)
    w = torch.randn((b, v, 64), generator=gen, device=dev)
    cases = {
        "K1": (lambda t: ss.segment_sum_sorted_grad(t, starts, ids),
               lambda t: ss.segment_sum_sorted_plain(t, starts)),
        "K2": (lambda t: scatter_mean_to_grid(t, vox["voxel_indices"], v,
                                              counts=vox["raw_counts"]),
               lambda t: bs.pillar_bin_sums_plain(
                   t, vox["voxel_indices"], v)[0]
               / vox["raw_counts"].clamp_min(1.0)[..., None]),
    }
    out = {}
    for name, (kernel_fn, plain_fn) in cases.items():
        ys, grads, ms = [], [], []
        for fn in (kernel_fn, plain_fn):
            xr = x.clone().requires_grad_()
            y = fn(xr)
            check(y.grad_fn is not None, f"{name}: output has no grad_fn")
            (g,) = torch.autograd.grad(y, xr, w, retain_graph=True)
            ys.append(y.detach())
            grads.append(g)
            ms.append(cuda_ms(torch, lambda: torch.autograd.grad(
                y, xr, w, retain_graph=True), 20))
        with torch.no_grad():
            l1 = plain_fn(x.abs()).double()
        fwd = float(((ys[0] - ys[1]).double().abs()
                     / l1.clamp_min(1e-30)).max())
        err = float((grads[0] - grads[1]).abs().max())
        print(f"[train-kernels] {name} at ({b}, {pts.shape[1]}, 64) on "
              f"{card}: forward, autograd Function vs plain, max error "
              f"relative to per-pillar L1 mass {fwd:.3e} (bound 1e-5); "
              f"backward (row gather) vs autograd through the plain "
              f"version: max |diff| {err:.3e} (bound 1e-6); "
              f"{ms[0]:.4f} ms vs {ms[1]:.4f} ms (CUDA events, L2-warm, "
              f"mean of 20)")
        check(fwd < 1e-5, f"{name} forward at the train step's shape "
              f"disagrees with its plain version: {fwd:.3e}")
        check(err <= 1e-6, f"{name} backward disagrees with its plain "
              f"version: {err:.3e}")
        out[name] = (err, ms[0], ms[1])
    return out


def phase_train_reference(torch, cfg, ds, n_pts: int = 16384):
    """One fp32 train step on each path, card against CPU, from the same
    weights, batch, triplets and yaw, at a reduced pad (TF32 off).

    The loss must agree within rtol 1e-4. The gradient of one triplet step
    is chaotic at the ~1e-2 level in fp32 (rounding decides ReLUs near 0,
    and BatchNorm's mean subtraction cancels most of a weight gradient), so
    the smoke measures that floor where it brackets a change of device: the
    same step on the CPU with its mkldnn convolutions off against on (the
    same code, only the convolutions' summation order differs). Each
    tensor's card gradient must lie within twice that floor's worst tensor,
    over both paths, of its norm from the CPU's; a lost or mis-scaled
    gradient path is an O(1) error."""
    from gloc3d_tpu_torch.data import dataset
    from gloc3d_tpu_torch.models.descriptor import build_model
    from gloc3d_tpu_torch.train import Trainer
    from gloc3d_tpu_torch.train.trainer import rotate_clouds_z

    small = dataset.TripletDataset(
        db_inputs=np.ascontiguousarray(ds.db_inputs[:, :n_pts]),
        q_inputs=np.ascontiguousarray(ds.q_inputs[:, :n_pts]),
        utm_db=ds.utm_db, utm_q=ds.utm_q,
        db_masks=np.ascontiguousarray(ds.db_masks[:, :n_pts]),
        q_masks=np.ascontiguousarray(ds.q_masks[:, :n_pts]))
    b, n_neg = cfg.train.batch_size, cfg.train.n_neg
    dist = np.linalg.norm(small.utm_q[:b, None] - small.utm_db[None], axis=-1)
    pos = dist.argmin(1)
    neg = np.concatenate([np.flatnonzero(d > 20.0)[:n_neg] for d in dist])
    yaw = torch.tensor(np.random.RandomState(4).uniform(-np.pi, np.pi, b),
                       dtype=torch.float32)
    q_in = rotate_clouds_z(torch.from_numpy(small.q_inputs[:b]), yaw).numpy()
    clouds = (q_in, small.db_inputs[pos], small.db_inputs[neg])
    masks = (small.q_masks[:b], small.db_masks[pos], small.db_masks[neg])
    nv, qv = np.ones((b, n_neg), np.float32), np.ones(b, np.float32)
    init = training_model(torch, cfg, small, "cuda", "float32").state_dict()
    c = cfg.replace(model=cfg.model.replace(fold_bn=False,
                                            compute_dtype="float32"))

    def step(device, host_stats, mkldnn=True):
        model = build_model(c.model, c.voxel)
        model.load_state_dict(init)
        cc = c.replace(train=c.train.replace(host_stats=host_stats))
        torch.backends.mkldnn.enabled = mkldnn
        try:
            with tempfile.TemporaryDirectory() as workdir:
                tr = Trainer(cc, model, small, workdir, device=device)
                if host_stats:
                    loss = tr.train_step_hs(*tr._host_sorted(
                        np.concatenate(clouds), np.concatenate(masks)),
                        nv, qv)
                else:
                    loss = tr.train_step(clouds[0], masks[0], clouds[1],
                                         masks[1], clouds[2], masks[2], nv,
                                         qv)
        finally:
            torch.backends.mkldnn.enabled = True
        return float(loss), {k: p.grad.detach().cpu()
                             for k, p in model.named_parameters()}

    runs = {}
    for host_stats in (False, True):
        path = "host-stats" if host_stats else "all-device"
        (l_g, g_g), (l_c, g_c) = step("cuda", host_stats), step("cpu",
                                                                 host_stats)
        _, g_o = step("cpu", host_stats, mkldnn=False)
        runs[path] = (l_g, l_c, g_g, g_c, grad_floor(g_c, g_o))
    floor = max(r[-1] for r in runs.values())
    for path, (l_g, l_c, g_g, g_c, _) in runs.items():
        print(f"[train-reference] {path}, fp32 step at {n_pts} points, card "
              f"vs CPU: loss {l_g:.7f} vs {l_c:.7f} (rel "
              f"{abs(l_g - l_c) / abs(l_c):.2e}, bound 1e-4)")
        check(abs(l_g - l_c) <= 1e-4 * abs(l_c), f"{path}: card loss "
              f"{l_g} vs CPU {l_c}")
        grad_floor_check(f"train-reference, {path}", g_g, g_c, floor,
                         "mkldnn convolutions off vs on, over both paths")


# ------------------------------------------------- i2i and pose training
def grad_rel(a, b):
    """Per tensor, |a - b| / |b| of two gradient dicts."""
    return {k: float((a[k] - b[k]).norm() / b[k].norm().clamp_min(1e-30))
            for k in b}


def grad_floor(cpu_grads, *reruns):
    """The CPU's own floor: the worst tensor of the CPU reruns that change
    only an order of summation, against the CPU's step."""
    return max(max(grad_rel(g, cpu_grads).values()) for g in reruns)


def grad_floor_check(tag, card_grads, cpu_grads, floor, floor_what):
    """Hold a card step's gradients to the CPU's: each tensor's |diff| /
    |grad| within twice ``floor``. Returns the worst card-vs-CPU tensor."""
    cross = grad_rel(card_grads, cpu_grads)
    worst = sorted(cross, key=cross.get)[-3:]
    print(f"[{tag}] gradient |diff| / |grad| per tensor, card vs CPU, "
          f"worst: " + ", ".join(f"{k} {cross[k]:.2e}" for k in worst)
          + f" (median {np.median(list(cross.values())):.2e}); the CPU "
          f"with {floor_what}: worst {floor:.2e} (bound {2 * floor:.2e}, "
          f"twice that floor)")
    check(max(cross.values()) <= 2 * floor, f"{tag}: card gradients differ "
          f"from the CPU's by {max(cross.values()):.3e}, more than twice the "
          f"CPU's own floor {floor:.3e}")
    return max(cross.values())


def i2i_training_dataset(torch, cfg, world):
    """The training world's 24 db and 8 query scans (training_dataset)
    rendered by the port to 768² BEV images: the i2i inputs a user loads
    from disk."""
    from gloc3d_tpu_torch.data import dataset

    scans = training_dataset(world, cfg.voxel.max_points)
    db, _ = render_bevs(torch, cfg, list(zip(scans.db_inputs,
                                             scans.db_masks)))
    qs, _ = render_bevs(torch, cfg, list(zip(scans.q_inputs,
                                             scans.q_masks)))
    return dataset.TripletDataset(db_inputs=db, q_inputs=qs,
                                  utm_db=scans.utm_db, utm_q=scans.utm_q)


def i2i_trainer(torch, cfg, ds, workdir, device, seed=0, vlad_from=None):
    """A seeded image model (NetVLAD initialised from ``vlad_from``, the db
    images by default) in a Trainer with the reference's freeze mask."""
    from gloc3d_tpu_torch.models.descriptor import build_model, init_params
    from gloc3d_tpu_torch.models.encoders import train_mask
    from gloc3d_tpu_torch.train import Trainer, init_vlad_from_data

    model = init_params(build_model(cfg.model, cfg.voxel), seed=seed)
    model = model.to(device)
    images = ds.db_inputs if vlad_from is None else vlad_from
    init_vlad_from_data(cfg, model, images, None,
                        torch.Generator().manual_seed(seed),
                        num_images=len(images), per_image=100)
    mask = train_mask(model, cfg.model.encoder)
    return Trainer(cfg, model, ds, workdir, device=device,
                   trainable_mask=mask), mask


def check_freeze(torch, tag, model, mask, before):
    """Frozen parameters bit-unchanged; every trainable one has a nonzero
    gradient and moved."""
    params = dict(model.named_parameters())
    moved = [k for k, t in mask.items() if not t
             and not torch.equal(params[k].detach(), before[k])]
    check(not moved, f"{tag}: frozen parameters changed: {moved[:4]}")
    zero = [k for k, t in mask.items() if t and (
        params[k].grad is None or float(params[k].grad.abs().max()) == 0.0)]
    check(not zero, f"{tag}: zero gradient for trainable {zero[:4]}")
    same = [k for k, t in mask.items() if t
            and torch.equal(params[k].detach(), before[k])]
    check(not same, f"{tag}: trainable parameters unchanged: {same[:4]}")
    return sum(mask.values()), len(mask)


def i2i_step_flop(cfg, n_images: int) -> float:
    """Conv FLOPs of one i2i train step of VGG16 under its freeze mask: the
    forward of all 13 convs, and the backward of the trainable conv10-12
    (their weight gradients, and the input gradients of conv11 and conv12;
    conv10's input carries no gradient below the freeze)."""
    from gloc3d_tpu_torch.models.vgg import conv_flops

    s = cfg.bev.image_size
    top = 2 * (s // 16) ** 2 * 512 * 512 * 9  # one of conv10-12, per image
    return n_images * (conv_flops(1, s) + 5 * top)


def phase_i2i_train(torch, world, card):
    """[i2i-train]: PipelineConfig.i2i() (VGG16 + NetVLAD-FC, 64 x 512
    clusters, FC 32 768 → 512, bf16) at 768² on the training world's BEVs,
    the reference's freeze mask: one epoch (counted, checked), two timing
    epochs, one fp32 step card vs CPU at a 128² crop, and one step each of
    AlexNet, MobileNetV2 and ResNet18 with their masks."""
    from gloc3d_tpu_torch import PipelineConfig
    from gloc3d_tpu_torch.models.vgg import conv_flops

    dev = torch.device("cuda")
    # margin 10, as the JAX package's zoo test: every negative violates, so
    # every batch takes a step (seeded weights mine few violations at 0.1)
    base = PipelineConfig.i2i()
    cfg = base.replace(train=base.train.replace(
        cache_refresh_rate=N_TRAIN_Q, margin=10.0))
    ds = i2i_training_dataset(torch, cfg, world)
    b, n_neg = cfg.train.batch_size, cfg.train.n_neg
    n_img = b * (2 + n_neg)
    with tempfile.TemporaryDirectory() as workdir:
        tr, mask = i2i_trainer(torch, cfg, ds, workdir, dev)
        before = {k: p.detach().clone()
                  for k, p in tr.model.named_parameters()}
        torch.cuda.reset_peak_memory_stats()
        loss = tr.train_epoch(1)
        n_steps = tr.step
        check(n_steps >= 3, f"[i2i-train] only {n_steps} steps ran")
        check(math.isfinite(loss) and loss > 0, f"[i2i-train] loss {loss}")
        n_train, n_all = check_freeze(torch, "[i2i-train]", tr.model, mask,
                                      before)
        print(f"[i2i-train] VGG16 + NetVLAD-FC at "
              f"{cfg.bev.image_size}² bf16, epoch 1 over {N_TRAIN_Q} "
              f"queries ({n_img} images per step): {n_steps} steps, mean "
              f"loss {loss:.5f}; {n_train} of {n_all} parameters train "
              f"(conv10-12 and the pooling), every one with a nonzero "
              f"gradient and moved; the {n_all - n_train} frozen ones "
              f"bit-unchanged")
        steps, caches = [], []
        tr._train_batch = timed(torch, tr._train_batch, steps)
        tr.compute_cache = timed(torch, tr.compute_cache, caches)
        for epoch in (2, 3):
            tr.train_epoch(epoch)
        del tr._train_batch, tr.compute_cache
        peak = torch.cuda.max_memory_allocated() / 2**30
        step_ms = float(np.median([s[0] for s in steps]))
        cache_ms = sum(s[0] for s in caches) / sum(s[1] for s in caches)
        flop = i2i_step_flop(cfg, n_img)
        mfu = flop / (step_ms * 1e-3) / 989e12
        print(f"[i2i-train] on {card}: {step_ms:.2f} ms per train step "
              f"(mining, gather, upload, forward, backward, SGD; CUDA "
              f"events around the whole step, median of {len(steps)} warm "
              f"steps of epochs 2-3); cache refresh {cache_ms:.3f} ms per "
              f"image ({sum(s[1] for s in caches)} images in batches of "
              f"8); peak device memory {peak:.2f} GiB; the step's conv "
              f"FLOPs {flop / 1e12:.3f} TFLOP (forward "
              f"{conv_flops(1, cfg.bev.image_size) / 1e9:.1f} GFLOP per "
              f"image and the backward of conv10-12) over its "
              f"time: {flop / (step_ms * 1e-3) / 1e12:.1f} TFLOP/s, "
              f"{mfu:.3f} of 989 TFLOP/s dense bf16")
    out = {"step_ms": step_ms, "cache_ms_per_image": cache_ms,
           "peak_gib": peak, "step_tflop": flop / 1e12, "mfu": mfu,
           "steps": n_steps}
    out["reference"] = phase_i2i_train_reference(torch, cfg, ds)
    out["zoo"] = phase_i2i_train_zoo(torch, cfg, ds, card)
    return out


def phase_i2i_train_reference(torch, cfg, ds, crop: int = 128):
    """One fp32 VGG16 step, card against CPU, from the same weights and
    batch at a ``crop``² centre crop of the BEVs (TF32 off); the gradients
    within twice the CPU's mkldnn-on-vs-off floor, the loss within rtol
    1e-4."""
    from gloc3d_tpu_torch.data import dataset

    lo = (cfg.bev.image_size - crop) // 2
    small = dataset.TripletDataset(
        db_inputs=np.ascontiguousarray(ds.db_inputs[:, lo:lo + crop,
                                                     lo:lo + crop]),
        q_inputs=np.ascontiguousarray(ds.q_inputs[:, lo:lo + crop,
                                                  lo:lo + crop]),
        utm_db=ds.utm_db, utm_q=ds.utm_q)
    c = cfg.replace(model=cfg.model.replace(compute_dtype="float32"))
    b, n_neg = c.train.batch_size, c.train.n_neg
    dist = np.linalg.norm(small.utm_q[:b, None] - small.utm_db[None], axis=-1)
    pos = dist.argmin(1)
    neg = np.concatenate([np.flatnonzero(d > 20.0)[:n_neg] for d in dist])
    batch = (small.q_inputs[:b], None, small.db_inputs[pos], None,
             small.db_inputs[neg], None, np.ones((b, n_neg), np.float32),
             np.ones(b, np.float32))
    with tempfile.TemporaryDirectory() as workdir:
        # NetVLAD from the queries' crops: no centroid is a batch feature
        tr, _ = i2i_trainer(torch, c, small, workdir, "cuda",
                            vlad_from=small.q_inputs[b:])
        init = {k: v.cpu() for k, v in tr.model.state_dict().items()}

    def step(device, mkldnn=True):
        from gloc3d_tpu_torch.models.descriptor import build_model
        from gloc3d_tpu_torch.models.encoders import train_mask
        from gloc3d_tpu_torch.train import Trainer

        model = build_model(c.model, c.voxel)
        model.load_state_dict(init)
        torch.backends.mkldnn.enabled = mkldnn
        try:
            with tempfile.TemporaryDirectory() as workdir:
                tr = Trainer(c, model, small, workdir, device=device,
                             trainable_mask=train_mask(model, "vgg16"))
                loss = float(tr.train_step(*batch))
        finally:
            torch.backends.mkldnn.enabled = True
        return loss, {k: p.grad.detach().cpu()
                      for k, p in model.named_parameters()
                      if p.grad is not None}

    (l_g, g_g), (l_c, g_c) = step("cuda"), step("cpu")
    _, g_o = step("cpu", mkldnn=False)
    print(f"[i2i-train-reference] fp32 VGG16 step at {crop}² crops, card vs "
          f"CPU: loss {l_g:.7f} vs {l_c:.7f} (rel "
          f"{abs(l_g - l_c) / abs(l_c):.2e}, bound 1e-4); {len(g_c)} "
          f"trainable tensors")
    check(abs(l_g - l_c) <= 1e-4 * abs(l_c), f"[i2i-train-reference] card "
          f"loss {l_g} vs CPU {l_c}")
    floor = grad_floor(g_c, g_o)
    worst = grad_floor_check("i2i-train-reference", g_g, g_c, floor,
                             "mkldnn convolutions off vs on")
    return {"loss_rel": abs(l_g - l_c) / abs(l_c), "grad_worst": worst,
            "cpu_floor": floor}


def phase_i2i_train_zoo(torch, cfg, ds, card):
    """One bf16 step each of AlexNet, MobileNetV2 and ResNet18 at 768² under
    their freeze masks, on the step batch of the VGG16 phase."""
    from gloc3d_tpu_torch import PipelineConfig

    b, n_neg = cfg.train.batch_size, cfg.train.n_neg
    dist = np.linalg.norm(ds.utm_q[:b, None] - ds.utm_db[None], axis=-1)
    pos = dist.argmin(1)
    neg = np.concatenate([np.flatnonzero(d > 20.0)[:n_neg] for d in dist])
    batch = (ds.q_inputs[:b], None, ds.db_inputs[pos], None,
             ds.db_inputs[neg], None, np.ones((b, n_neg), np.float32),
             np.ones(b, np.float32))
    out = {}
    for enc in ("alexnet", "mobilenet", "resnet18"):
        zc = PipelineConfig.i2i(enc)
        zc = zc.replace(train=cfg.train)
        with tempfile.TemporaryDirectory() as workdir:
            tr, mask = i2i_trainer(torch, zc, ds, workdir, "cuda")
            before = {k: p.detach().clone()
                      for k, p in tr.model.named_parameters()}
            loss = float(tr.train_step(*batch))
            check(math.isfinite(loss) and loss > 0,
                  f"[i2i-train] {enc}: loss {loss}")
            n_train, n_all = check_freeze(torch, f"[i2i-train] {enc}",
                                          tr.model, mask, before)
            ms = cuda_ms(torch, lambda: tr.train_step(*batch), 3)
        out[enc] = {"loss": loss, "step_ms": ms}
        print(f"[i2i-train] {enc} at {zc.bev.image_size}² bf16, one step "
              f"of {len(batch[0]) * (2 + n_neg)} images under its freeze "
              f"mask: loss {loss:.5f}; {n_train} of {n_all} parameters "
              f"train, every one with a nonzero gradient and moved, the "
              f"frozen ones bit-unchanged; {out[enc]['step_ms']:.2f} ms per "
              f"step on {card} (CUDA events, mean of 3 after 3 warm-up "
              f"steps)")
    return out


def pose_pairs(world, n: int, b: int = 4):
    """b scan pairs of the walled world: a query scan and a reference scan
    1-3 m and up to 0.3 rad away, with gt the angle-axis | translation of
    T_p←q (q's frame into p's)."""
    rng = np.random.RandomState(31)
    qs, ps, gt = [], [], np.zeros((b, 6), np.float32)
    for i in range(b):
        q = (rng.uniform(-30, 30), rng.uniform(-20, 20),
             rng.uniform(-np.pi, np.pi))
        p = (q[0] + rng.uniform(-3, 3), q[1] + rng.uniform(-3, 3),
             q[2] + rng.uniform(-0.3, 0.3))
        qs.append(scan_at(world, q, n, seed=700 + i))
        ps.append(scan_at(world, p, n, seed=800 + i))
        c, s = np.cos(-p[2]), np.sin(-p[2])
        dx, dy = q[0] - p[0], q[1] - p[1]
        gt[i] = (0.0, 0.0, q[2] - p[2], c * dx - s * dy, s * dx + c * dy,
                 0.0)
    stack = [np.stack([s[j] for s in scans]) for scans in (qs, ps)
             for j in (0, 1)]
    return tuple(stack), gt


def phase_pose_train(torch, world, card, steps: int = 25):
    """[pose-train]: make_pose_model(PipelineConfig.s2s()) at the full
    140 x 80 grid (bf16 convs), 4 walled-world pairs at the 122 480 pad,
    Adam 1e-3, 25 steps on the fixed batch: JAX's criterion, K2 launch and
    backward counts, every K2 launch of one step against its plain
    version, one fp32 step card vs CPU, predict_pose."""
    from gloc3d_tpu_torch import PipelineConfig
    from gloc3d_tpu_torch.kernels import bin_sums as bs
    from gloc3d_tpu_torch.train import pose

    cfg = PipelineConfig.s2s()
    batch, gt = pose_pairs(world, cfg.voxel.max_points)
    dev_batch = [torch.from_numpy(a).cuda() for a in batch]
    state = pose.init_pose_state(pose.make_pose_model(cfg), lr=1e-3,
                                 generator=torch.Generator().manual_seed(0),
                                 device="cuda")
    torch.cuda.reset_peak_memory_stats()
    bs.pillar_bin_sums.launches = 0
    bs.pillar_bin_sums_grad.backward_calls = 0
    losses, ms = [], []
    for _ in range(steps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        loss = pose.pose_train_step(state, dev_batch, gt)
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
        losses.append(float(loss))
    k2 = bs.pillar_bin_sums.launches
    k2_bwd = bs.pillar_bin_sums_grad.backward_calls
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = float(np.median(ms[3:]))
    print(f"[pose-train] PosePairModel at the 140 x 80 grid, "
          f"{cfg.model.compute_dtype} convs, 4 pairs x "
          f"{cfg.voxel.max_points} points, Adam 1e-3, {steps} "
          f"steps on {card}: losses {losses[0]:.4f} {losses[1]:.4f} "
          f"{losses[2]:.4f} ... min {min(losses):.4f} (criterion: below 0.7 "
          f"x {max(losses[:3]):.4f}); {step_ms:.2f} ms per step (CUDA "
          f"events, median of steps 4-{steps}); peak device memory "
          f"{peak:.2f} GiB; K2 launches {k2}, backward calls {k2_bwd}")
    check(all(math.isfinite(v) for v in losses), f"[pose-train] {losses}")
    check(min(losses) < 0.7 * max(losses[:3]),
          f"[pose-train] the loss did not fall: {losses}")
    check((k2, k2_bwd) == (4 * steps, 2 * steps), f"[pose-train] (K2, K2 "
          f"backward) = {(k2, k2_bwd)}, expected {(4 * steps, 2 * steps)}")
    pred = pose.predict_pose(state, dev_batch)
    check(tuple(pred.shape) == (4, 6) and bool(torch.isfinite(pred).all()),
          f"[pose-train] predict_pose {tuple(pred.shape)}")

    launches = record_launches(
        lambda: pose.pose_train_step(state, dev_batch, gt))
    check(len(launches["K2"]) == 4 and not launches["K1"],
          f"[pose-train] recorded {len(launches['K2'])} K2 launches")
    parts = []
    for args in launches["K2"]:
        rel = check_k2(torch, "[pose-train]", *args)[0]
        check(rel < 1e-5, f"[pose-train] K2 {tuple(args[0].shape)} "
              f"disagrees with its plain version: {rel:.3e}")
        parts.append(f"{tuple(args[0].shape)} {rel:.2e}")
    print("[pose-train] every K2 launch of one step against its plain "
          "version, error relative to per-pillar L1 mass (bound 1e-5; "
          "counts exactly equal): " + ", ".join(parts))
    ref = phase_pose_train_reference(torch, cfg, batch, gt)
    return {"step_ms": step_ms, "peak_gib": peak, "losses": losses,
            "k2_launches": k2, "k2_backward": k2_bwd, "reference": ref}


def phase_pose_train_reference(torch, cfg, batch, gt, n_pts: int = 16384):
    """One fp32 pose step, card against CPU, from the same weights at a
    16 384-point pad: loss within rtol 1e-4, gradients within twice the
    CPU's own floor. The card changes the order of K2's float atomics and
    of every reduction at once, so the floor is the largest of four CPU
    reruns that change only orders of summation: mkldnn convolutions off;
    every cloud's rows (and mask) permuted, which reorders the pillar sums
    and the PointNet BatchNorm's statistics; and the rows permuted on one
    thread without mkldnn, and on three threads, which reorders every
    reduction. (On an H100 the card read 9.2e-3-1.0e-2 from the CPU, where
    mkldnn off or permuted rows alone moved the CPU by 2.1e-3-6.2e-3 and
    the thread count by 1.1e-2-1.8e-2.)

    A control shows the bound still fails a wrong step: the same step on
    the card with the convolutions and matmuls in bf16 must lie beyond
    it."""
    from gloc3d_tpu_torch.train import pose

    small = [np.ascontiguousarray(a[:, :n_pts]) for a in batch]

    def permuted(seed):
        perm = np.random.RandomState(seed).permutation(n_pts)
        return [np.ascontiguousarray(a[:, perm]) for a in small]

    def model_for(dtype):
        return pose.make_pose_model(cfg.replace(
            model=cfg.model.replace(compute_dtype=dtype)))

    init = pose.init_pose_params(model_for("float32"),
                                 torch.Generator().manual_seed(1)
                                 ).state_dict()

    def step(device, mkldnn=True, clouds=small, dtype="float32"):
        model = model_for(dtype)
        model.load_state_dict(init)
        torch.backends.mkldnn.enabled = mkldnn
        try:
            st = pose.init_pose_state(model, init=False, device=device)
            loss = float(pose.pose_train_step(
                st, [torch.from_numpy(a) for a in clouds], gt))
        finally:
            torch.backends.mkldnn.enabled = True
        return loss, {k: p.grad.detach().cpu()
                      for k, p in st.model.named_parameters()}

    (l_g, g_g), (l_c, g_c) = step("cuda"), step("cpu")
    reruns = [step("cpu", mkldnn=False)[1],
              step("cpu", clouds=permuted(5))[1]]
    threads = torch.get_num_threads()
    try:
        for n_threads, mkldnn, seed in ((1, False, 6), (3, True, 7)):
            torch.set_num_threads(n_threads)
            reruns.append(step("cpu", mkldnn, permuted(seed))[1])
    finally:
        torch.set_num_threads(threads)
    print(f"[pose-train-reference] fp32 pose step at {n_pts} points, card "
          f"vs CPU: loss {l_g:.7f} vs {l_c:.7f} (rel "
          f"{abs(l_g - l_c) / abs(l_c):.2e}, bound 1e-4)")
    check(abs(l_g - l_c) <= 1e-4 * abs(l_c), f"[pose-train-reference] card "
          f"loss {l_g} vs CPU {l_c}")
    floor = grad_floor(g_c, *reruns)
    worst = grad_floor_check(
        "pose-train-reference", g_g, g_c, floor, "mkldnn convolutions off, "
        "the rows permuted, or permuted on 1 or 3 threads")
    l_b, g_b = step("cuda", dtype="bfloat16")
    control = grad_rel(g_b, g_c)
    n_over = sum(v > 2 * floor for v in control.values())
    print(f"[pose-train-reference] control, the card step in bf16: loss "
          f"{l_b:.7f} (rel {abs(l_b - l_c) / abs(l_c):.2e}); gradient "
          f"|diff| / |grad| worst {max(control.values()):.2e}, median "
          f"{np.median(list(control.values())):.2e}, {n_over} of "
          f"{len(control)} tensors beyond the bound {2 * floor:.2e}")
    check(max(control.values()) > 2 * floor, "[pose-train-reference] the "
          f"bound {2 * floor:.3e} does not fail the bf16 step")
    return {"loss_rel": abs(l_g - l_c) / abs(l_c), "grad_worst": worst,
            "cpu_floor": floor, "bf16_worst": max(control.values()),
            "bf16_median": float(np.median(list(control.values()))),
            "bf16_over": n_over}


def capture_pillars(model):
    """Wrap ``model.bev_heads`` so each call keeps its pillar-mean input."""
    seen = []
    real = model.bev_heads

    def bev_heads(pillar, mode=None):
        seen.append(pillar.detach())
        return real(pillar, mode)

    model.bev_heads = bev_heads
    return seen


def phase_packed(torch, world, card):
    """[packed]: one full-pad scan through the port's PointPillar (K2),
    PointPillarPacked (pack_points + K2) and PointPillarSorted (the host
    pass + K1), one fp32 state dict: the pillar means within 1e-5 of the
    largest of PointPillar's (K2's float atomics leave pillars other than
    pillar 0 non-bit-equal, and the sorted path's centre-relative
    statistics change per-point features in their last bits), the outputs
    within 1e-4 of their largest element; forward times; K1 / K2
    launches."""
    from gloc3d_tpu_torch import PipelineConfig
    from gloc3d_tpu_torch.data import native
    from gloc3d_tpu_torch.kernels import bin_sums as bs
    from gloc3d_tpu_torch.kernels import segment_sum as ss
    from gloc3d_tpu_torch.models.descriptor import init_params
    from gloc3d_tpu_torch.models.packed import (
        PointPillarPacked, PointPillarSorted, pack_points)
    from gloc3d_tpu_torch.models.pointpillar import PointPillar

    v = PipelineConfig.s2s().voxel
    pts, mask = scan_at(world, (5.0, -3.0, 0.4), v.max_points, seed=41)
    bounds = (v.xbound, v.ybound, v.zbound)
    sd = init_params(PointPillar(*bounds, torch.float32), seed=2
                     ).state_dict()
    models = {}
    for cls in (PointPillar, PointPillarPacked, PointPillarSorted):
        m = cls(*bounds, torch.float32)
        m.load_state_dict(sd)  # one state dict for all three
        models[cls.__name__] = m.cuda().eval()
    p_d = torch.from_numpy(pts[None]).cuda()
    m_d = torch.from_numpy(mask[None]).cuda()
    host = native.compute_voxel_stats_host_sorted(
        pts[None], mask[None].sum(1).astype(np.int64), *bounds, crop=False)
    sorted_in = [torch.from_numpy(host[i]).cuda() for i in (0, 1, 2, 5)]
    calls = {
        "PointPillar": lambda: models["PointPillar"](p_d, m_d),
        "PointPillarPacked": lambda: models["PointPillarPacked"](
            pack_points(p_d, m_d, *bounds)),
        "PointPillarSorted": lambda: models["PointPillarSorted"](
            *sorted_in),
    }
    outs, pillars, launches = {}, {}, {}
    with torch.no_grad():
        for name, fn in calls.items():
            seen = capture_pillars(models[name])
            ss.segment_sum_sorted.launches = 0
            bs.pillar_bin_sums.launches = 0
            outs[name] = fn()
            torch.cuda.synchronize()
            launches[name] = (ss.segment_sum_sorted.launches,
                              bs.pillar_bin_sums.launches)
            pillars[name] = seen[0]
            del models[name].bev_heads
        ref_p, ref_o = pillars["PointPillar"], outs["PointPillar"]
        res = {}
        for name in ("PointPillarPacked", "PointPillarSorted"):
            prel = float((pillars[name] - ref_p).abs().max()
                         / ref_p.abs().max())
            orel = float((outs[name] - ref_o).abs().max()
                         / ref_o.abs().max())
            ms = cuda_ms(torch, calls[name], 10)
            res[name] = {"pillar_rel": prel, "out_rel": orel, "ms": ms,
                         "K1": launches[name][0], "K2": launches[name][1]}
            print(f"[packed] {name} vs PointPillar on one {v.max_points}-"
                  f"point scan at fp32 on {card}: pillar means within "
                  f"{prel:.2e} of the largest (bound 1e-5), "
                  f"outputs within {orel:.2e} of their largest element "
                  f"(bound 1e-4); forward {ms:.3f} ms (CUDA events, mean "
                  f"of 10); launches K1 {launches[name][0]}, K2 "
                  f"{launches[name][1]}")
            check(prel < 1e-5 and orel < 1e-4, f"[packed] {name} differs "
                  f"from PointPillar: pillars {prel:.3e}, outputs "
                  f"{orel:.3e}")
        res["PointPillar"] = {"ms": cuda_ms(torch, calls["PointPillar"], 10),
                              "K2": launches["PointPillar"][1]}
    print(f"[packed] PointPillar forward {res['PointPillar']['ms']:.3f} ms "
          f"on {card} (K2 launches {launches['PointPillar'][1]})")
    check(launches["PointPillarPacked"] == (0, 2)
          and launches["PointPillarSorted"] == (2, 0),
          f"[packed] launches (K1, K2): {launches}")
    return res


def kernel_time_cases(torch, cfg, ds, k1_main, k2_main):
    """The inputs phase_kernel_times takes: each kernel at the main path's
    shapes (K1 on a real scan's sorted rows; K2's two binnings of the
    aligned scan) and at the train step's (24, 122480, ·)."""
    t = train_kernel_inputs(torch, cfg, ds)
    n, b = cfg.voxel.max_points, t["x"].shape[0]
    v, ids = t["vox"]["num_voxels"], t["vox"]["voxel_indices"]
    k1 = {"main path": k1_main, "train step": (t["x"], t["starts"])}
    k2 = {"main path, statistics": k2_main["statistics"],
          "main path, features": k2_main["features"],
          "train step, statistics": (t["payload"], ids, v),
          "train step, features": (t["x"], ids, v)}
    check(tuple(k2_main["features"][0].shape) == (1, n, 64)
          and tuple(t["x"].shape) == (b, n, 64), "kernel-time shapes")
    return k1, k2


def kernel_entry(key, times, label):
    """The kernel-only fields of a kernel's JSON entry: its main-path case
    at the top level, every case under ``cases``."""
    main = times[key][label]
    return {"kernel_only_ms": main["kernel_only_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "wrapper_ms": main["wrapper_ms"],
            "cases": times[key]}


def main(argv) -> int:
    import torch

    kernels_only = "--kernels" in argv
    seed = int(argv[argv.index("--seed") + 1]) if "--seed" in argv else 0
    name, card = phase_device(torch)
    sys.path.insert(0, REPO)
    from gloc3d_tpu_torch import PipelineConfig

    if "--submap" in argv:
        print(json.dumps({"submap": phase_submap(torch, card, make_world())}))
        return 0
    alone = {"--i2i-train": ("i2i_train", phase_i2i_train),
             "--pose-train": ("pose_train", phase_pose_train),
             "--packed": ("packed", phase_packed)}
    if any(flag in argv for flag in alone):
        phase_build()
        world = make_world()
        for flag, (key, phase) in alone.items():
            if flag in argv:
                print(json.dumps({"card": card,
                                  key: phase(torch, world, card)}))
        return 0

    cfg = PipelineConfig.s2s()
    cfg = cfg.replace(model=cfg.model.replace(fold_bn=True))
    world = make_world()
    if "--eval" in argv:
        phase_build()
        print(json.dumps({"card": card,
                          "eval": phase_eval(torch, cfg, world, card)[0]}))
        return 0
    kf_set, q_set = aligned_world_scans(world, cfg.voxel.max_points)
    phase_build()
    centroids = vlad_centroids(torch, cfg, kf_set[2][:4])
    k1_err, k1_ms, k1_plain_ms, k1_main = phase_k1(torch, cfg, world, card)
    k1_pillar0_same = check_k1_pillar0_determinism(torch, *k1_main)
    k2_err, k2_ms, k2_plain_ms, k2_main = phase_k2(torch, cfg, world, card,
                                                   centroids)
    if kernels_only:
        ds = training_dataset(world, cfg.voxel.max_points)
        times = phase_kernel_times(torch, card, *kernel_time_cases(
            torch, cfg, ds, k1_main, k2_main))
        print(json.dumps({"card": card, "kernel_times": times}))
        return 0
    check_k2_pillar0_determinism(torch, k2_main)
    lq_set = located_world_scans(world, cfg.voxel.max_points)
    loc, kf, qs, k1_launches = phase_located_query(torch, cfg, lq_set,
                                                   centroids)
    phase_reference(torch, cfg, kf, qs, centroids)

    model = build_serving_model(torch, cfg, "bfloat16", centroids)
    a_loc, a_results, k2_launches = phase_aligned_query(
        torch, cfg, model, kf_set, q_set)
    phase_aligned_hoststats(torch, cfg, kf_set, q_set, centroids)
    phase_aligned_reference(torch, cfg, kf_set, q_set, centroids)

    k1_fused, k2_fused = phase_fused_query(torch, cfg, lq_set, kf_set, q_set,
                                           centroids)
    flat_ms = phase_fused_cell(torch, cfg, centroids, card)
    phase_fused_reference(torch, cfg, lq_set, centroids)
    map_scale = phase_map_scale(torch, card, seed)
    city = phase_city(torch, cfg, centroids, card, flat_ms)
    print(json.dumps({"card": card, "map_scale": map_scale, "city": city}))

    phase_timing(torch, cfg, loc, kf, qs, card)
    phase_aligned_timing(torch, cfg, a_loc, q_set[2], card)
    i2i = run_i2i(torch, kf_set, q_set, lq_set, card)
    print(json.dumps({"card": card, "i2i": i2i}))
    refine, k1_refine, k2_refine = run_refine(
        torch, cfg, lq_set, kf_set, q_set, centroids, model, a_results, card)
    print(json.dumps({"card": card, "refine": refine}))
    print(json.dumps({"submap": phase_submap(torch, card, world)}))
    eval_rec, k1_eval, k2_eval = phase_eval(torch, cfg, world, card)
    print(json.dumps({"card": card, "eval": eval_rec}))

    ds = training_dataset(world, cfg.voxel.max_points)
    train_counts = phase_training(torch, cfg, ds, card)
    bwd = phase_train_kernels(torch, cfg, ds, card)
    phase_train_reference(torch, cfg, ds)
    i2i_train = phase_i2i_train(torch, world, card)
    pose_train = phase_pose_train(torch, world, card)
    packed = phase_packed(torch, world, card)
    print(json.dumps({"card": card, "i2i_train": i2i_train,
                      "pose_train": pose_train, "packed": packed}))
    times = phase_kernel_times(torch, card, *kernel_time_cases(
        torch, cfg, ds, k1_main, k2_main))
    k1_paths = {"located query": k1_launches,
                "fused query, host-stats": k1_fused,
                "training, host-stats": train_counts["host-stats"][0],
                "refine, host-stats": k1_refine,
                "eval, host-stats": k1_eval,
                "sorted": packed["PointPillarSorted"]["K1"]}
    k2_paths = {"aligned query": k2_launches,
                "fused query, aligned all-device": k2_fused,
                "training, all-device": train_counts["all-device"][1],
                "refine, aligned all-device": k2_refine,
                "eval, aligned all-device": k2_eval,
                "pose training, all-device": pose_train["k2_launches"],
                "packed": packed["PointPillarPacked"]["K2"]}
    print(json.dumps({"kernels": [
        {"name": "segment_sum_sorted", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": sum(k1_paths.values()),
         "launches_by_path": k1_paths,
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
         "pillar0_bit_equal": k1_pillar0_same,
         **kernel_entry("K1", times, "main path"),
         "backward_max_abs_err": bwd["K1"][0], "backward_ms": bwd["K1"][1],
         "plain_backward_ms": bwd["K1"][2]},
        {"name": "pillar_bin_sums", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": sum(k2_paths.values()),
         "launches_by_path": k2_paths,
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms,
         **kernel_entry("K2", times, "main path, features"),
         "backward_max_abs_err": bwd["K2"][0], "backward_ms": bwd["K2"][1],
         "plain_backward_ms": bwd["K2"][2]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
