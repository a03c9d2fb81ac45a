"""The walled world, its map and its query pool, from a seed.

Vertical walls 5-15 m long and 0-3 m high standing on the ground plane;
a sensor at (x, y, yaw) with its own roll, pitch and height sees the walls
within its view radius and a sensor-centred ground ring (dense near the
sensor, as a LiDAR sees it), in the sensor frame, shuffled and padded to a
fixed number of (x, y, z, intensity) rows.

The map's real keyframes lie on a square grid, all headed within a
jitter of one direction (the aligned composition takes roll, pitch and dz
from the two ground frames alone, exact only for small offsets and
heading differences). Each on-map query lies within ``query_offset_m`` of
its own keyframe; off-map queries are scans of a second world made from
another seed, which no keyframe sees. The schedule cycles through the
pool in a seeded order and puts an off-map query at every
``off_map_every``-th place, so every seed gets the same mix in another
order.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, NamedTuple, Tuple

import numpy as np


def make_world(seed: int, n_walls: int, extent: float,
               pts_per_m: float = 100.0) -> np.ndarray:
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


def rpy_matrix(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """Rz(yaw)·Ry(pitch)·Rx(roll)."""
    cr, sr, cp, sp = math.cos(roll), math.sin(roll), math.cos(pitch), \
        math.sin(pitch)
    cy, sy = math.cos(yaw), math.sin(yaw)
    return np.array([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr]])


def tilted_scan(world: np.ndarray, pose, attitude, n_pad: int, seed: int,
                view_radius: float, n_ground: int
                ) -> Tuple[np.ndarray, np.ndarray]:
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


class Scene(NamedTuple):
    kf_scans: np.ndarray   # (R, N, 4) the map's real keyframes
    kf_masks: np.ndarray   # (R, N)
    kf_poses: list         # (x, y, yaw), (roll, pitch, height) per keyframe
    q_scans: np.ndarray    # (P, N, 4) the pool: on-map, then off-map
    q_masks: np.ndarray
    q_poses: list
    n_on: int              # on-map queries at the head of the pool


def make_scene(seed: int, t: dict, n_pad: int) -> Scene:
    """The map's real keyframes and the query pool of traffic ``t``."""
    rng = np.random.RandomState(seed % 2 ** 32)
    w = t["world"]
    world = make_world(int(rng.randint(2 ** 31)), w["n_walls"],
                       w["extent_m"])
    other = make_world(int(rng.randint(2 ** 31)), w["n_walls"],
                       w["extent_m"])
    m = t["map"]
    n = m["grid"]
    half = (n - 1) / 2.0 * m["spacing_m"]
    grid = np.linspace(-half, half, n)
    tilt = math.radians(m["max_tilt_deg"])

    def attitude():
        return (rng.uniform(-tilt, tilt), rng.uniform(-tilt, tilt),
                rng.uniform(*m["heights_m"]))

    def heading():
        return m["heading"] + rng.uniform(-m["heading_jitter"],
                                          m["heading_jitter"])

    kf = [((x, y, heading()), attitude()) for x in grid for y in grid]
    off = m["query_offset_m"]
    on = [((p[0] + rng.uniform(-off, off), p[1] + rng.uniform(-off, off),
            heading()), attitude()) for p, _ in kf]
    far = [((rng.uniform(-half, half), rng.uniform(-half, half), heading()),
            attitude()) for _ in range(t["pool"]["off_map"])]
    scan_seeds = rng.randint(2 ** 31, size=len(kf) + len(on) + len(far))

    def scans(world_pts, poses, seeds):
        # each scan from its own seed: the same scans on any thread count
        with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
            out = list(ex.map(lambda ps: tilted_scan(
                world_pts, ps[0][0], ps[0][1], n_pad, int(ps[1]),
                w["view_m"], w["n_ground"]), zip(poses, seeds)))
        return (np.stack([o[0] for o in out]),
                np.stack([o[1] for o in out]))

    k_s, k_m = scans(world, kf, scan_seeds[:len(kf)])
    q1_s, q1_m = scans(world, on, scan_seeds[len(kf):len(kf) + len(on)])
    q2_s, q2_m = scans(other, far, scan_seeds[len(kf) + len(on):])
    return Scene(k_s, k_m, kf, np.concatenate([q1_s, q2_s]),
                 np.concatenate([q1_m, q2_m]), on + far, len(on))


def schedule(seed: int, n_on: int, n_off: int, every: int,
             length: int) -> List[int]:
    """Pool indices of the first ``length`` queries: on-map queries in a
    seeded order (a new order each cycle), an off-map one at every
    ``every``-th place, also cycled in a seeded order."""
    rng = np.random.RandomState((seed + 1) % 2 ** 32)
    on, off, out = [], [], []
    for i in range(length):
        if every and i % every == every - 1 and n_off:
            if not off:
                off = list(n_on + rng.permutation(n_off))
            out.append(int(off.pop()))
        else:
            if not on:
                on = list(rng.permutation(n_on))
            out.append(int(on.pop()))
    return out


def draw_seed(seed: int, stream: int, i: int) -> int:
    """The ground draws' seed of unit ``i`` of ``stream`` (map batches,
    warm-up, window, trace): a fixed function of the run's seed."""
    return (seed * 1_000_003 + stream * 7_919 + i * 104_729) % (2 ** 63 - 1)
