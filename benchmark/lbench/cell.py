"""One run of one cell: set-up, the measured window, the traced slice, and
the check against the reference, returning the result line.

Set-up (``setup_s``, from the process's start to the first timed call):
the imports, the scene (world, map scans, query pool) from the seed, the
weights on the device, NetVLAD's clusters from the map's first scans, the
program's localizer and map, and the warm-up. The window then drives the
traffic's entry point back to back for ``seconds``. With ``trace`` a fixed
slice of further calls is traced and another is run under the sync
counter, and the per-layer readers take their numbers from them. The check
runs last, once the program's state is freed.
"""

from __future__ import annotations

import math
import os
import sys
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from lbench import check, flops, spec, trace, weights, world
from lbench.reference import bev as rbev
from lbench.reference import pose as rpose
from lbench.reference.pipeline import Reference

BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "gloc3d_tpu")


def process_start() -> float:
    """``time.perf_counter()``'s reading at this process's start (Linux:
    its age from /proc; elsewhere now)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - start_ticks
                         / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


class Context:
    """What the per-layer readers read."""

    def __init__(self, cell, cfg, units, window_s, sl, syncs, sync_queries):
        self.cell, self.cfg = cell, cfg
        self.batch = cell.traffic["batch"]
        self.units, self.window_s = units, window_s
        done = [u for u in units if u.answers is not None]
        self.queries = sum(len(u.answers) for u in done)
        self.answers = [a for u in done for a in u.answers]
        self.slice = sl
        self.traced_queries = sl.units * self.batch if sl else 0
        self.syncs, self.sync_queries = syncs, sync_queries
        self.flops_per_query = flops.descriptor_flops(cfg)
        self.k2_bytes_per_query = flops.k2_bytes_per_scan(cfg["voxel"])

    def device_ms(self, pick: Callable[[str], bool]) -> float:
        return sum(o.dur_us for o in self.slice.ops if pick(o.name)) / 1e3


def _cluster_inputs(cfg: dict, scene, n: int, device):
    scans = scene.kf_scans[:n]
    masks = scene.kf_masks[:n]
    if cfg["model"]["encoder"] == "pointpillar":
        return scans, masks
    images, _ = rbev.scan_to_bev(torch.as_tensor(scans[..., :3],
                                                 device=device),
                                 torch.as_tensor(masks, device=device),
                                 cfg["bev"])
    return images, None


def _filler(cfg: dict, traffic: dict, n_real: int, seed: int, device):
    """The map's rows beyond its real keyframes: seeded unit rows."""
    n = traffic["map"]["keyframes"] - n_real
    gen = torch.Generator(device=device).manual_seed(int(seed) + 2)
    rows = torch.randn((n, cfg["index"]["dim"]), generator=gen,
                       device=device)
    return rows / rows.norm(dim=-1, keepdim=True)


def sample_units(units, traffic: dict, n_on: int, seed: int):
    """The units the check recomputes, drawn from the seed among those
    that returned: on-map and off-map ones (relocalize) or whole batches,
    and the slowest unit."""
    rng = np.random.RandomState((seed + 5) % 2 ** 32)
    done = [u for u in units if u.answers is not None]
    if not done:
        return []
    c = traffic["check"]
    if traffic["batch"] == 1:
        on = [u for u in done if u.pool[0] < n_on]
        off = [u for u in done if u.pool[0] >= n_on]
        pick = [on[i] for i in rng.permutation(len(on))[:c["on_map"]]]
        pick += [off[i] for i in rng.permutation(len(off))[:c["off_map"]]]
    else:
        pick = [done[i] for i in rng.permutation(len(done))[:c["batches"]]]
    slowest = max(done, key=lambda u: u.seconds)
    if all(u.index != slowest.index for u in pick):
        pick.append(slowest)
    return pick


def reference_readings(cfg, params, scene, traffic, seed, device, filler,
                       map_state, sample, precision="exact"):
    """The check's numbers: the map and every sampled unit held to the
    reference."""
    ref = Reference(cfg, params, device, precision)
    step = traffic["map"]["build_batch"]
    m = ref.build_map(scene.kf_scans, scene.kf_masks,
                      [world.draw_seed(seed, 0, j) for j in
                       range(-(-len(scene.kf_scans) // step))], step, filler)
    parts = [check.compare_map(map_state, m, filler)]
    for u in sample:
        out = ref.locate(scene.q_scans[u.pool], scene.q_masks[u.pool],
                         u.draw_seed, m,
                         np.stack([a.candidates for a in u.answers]))
        parts.append(check.compare_queries(u.answers, out))
    return check.worst(parts)


def end_to_end(cell, units, window_s, setup_s) -> dict:
    done = [u for u in units if u.answers is not None]
    lat = np.array([u.seconds for u in done]) * 1e3
    queries = sum(len(u.answers) for u in done)
    values = {"setup_s": setup_s}
    if len(lat):
        values["query_p50_ms"] = float(np.percentile(lat, 50))
        values["query_p95_ms"] = float(np.percentile(lat, 95))
    if window_s > 0:
        values["queries_per_s"] = queries / window_s
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if m["name"] in values}


def _finite(x):
    if isinstance(x, float) and not math.isfinite(x):
        return 1e300 if x > 0 else -1e300
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def run(cell_name: str, seed: int, seconds: float, traced: bool,
        device: str = "cuda", overrides: Optional[dict] = None,
        root: str = spec.ROOT, t_start: Optional[float] = None,
        log=print, keep: Optional[dict] = None) -> dict:
    """One run of ``cell_name``; returns the result line's object. With
    ``keep`` (a dict) the run's inputs and sample are left in it, for the
    control's readings."""
    from lbench.program import Program, SYNCS, TRACE

    t_start = process_start() if t_start is None else t_start
    cell = spec.load_cell(cell_name, root, overrides)
    readers = spec.readers(cell, root)
    cfg, traffic = cell.config["pipeline"], cell.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    steps = [("imports", time.perf_counter())]

    def step(name):
        if cuda:
            torch.cuda.synchronize()
        steps.append((name, time.perf_counter()))

    scene = world.make_scene(seed, traffic, cfg["voxel"]["max_points"])
    step("scene")
    params = weights.seeded_params(cfg["model"], seed, dev)
    weights.init_clusters(params, cfg, *_cluster_inputs(
        cfg, scene, traffic["map"]["cluster_scans"], dev), seed, dev)
    filler = _filler(cfg, traffic, len(scene.kf_scans), seed, dev)
    step("weights")
    prog = Program(cfg, params, scene, traffic, seed, dev, filler)
    step("map")
    prog.warm_up()
    step("warm-up")
    setup_s = time.perf_counter() - t_start
    log("set-up: " + ", ".join(
        f"{name} {t - (steps[i - 1][1] if i else t_start):.3f} s"
        for i, (name, t) in enumerate(steps)))

    units, window_s = prog.window(seconds)
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    attempted = sum(len(u.pool) for u in units)
    failed = sum(len(u.pool) for u in units if u.answers is None)
    log(f"window: {len(units)} calls, {attempted} queries, {failed} failed, "
        f"{window_s:.3f} s; set-up {setup_s:.3f} s")
    if units:
        lat = np.array([u.seconds for u in units]) * 1e3
        half = len(units) // 2
        log("call ms: " + ", ".join(
            f"p{q} {np.percentile(lat, q):.3f}" for q in (10, 50, 90, 99))
            + f", max {lat.max():.3f}; calls per s over the window's "
            f"halves {half / max(lat[:half].sum() / 1e3, 1e-9):.2f} / "
            f"{(len(units) - half) / max(lat[half:].sum() / 1e3, 1e-9):.2f}")

    metrics = end_to_end(cell, units, window_s, setup_s)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {}
    if traced:
        n_trace, n_sync = traffic["trace_units"], traffic["sync_units"]
        sl = trace.traced(torch, lambda: len(prog.run_count(TRACE, n_trace)),
                          cuda)
        syncs, sync_units = trace.count_syncs(
            torch, lambda: len(prog.run_count(SYNCS, n_sync)), cuda)
        ctx = Context(cell, cfg, units, window_s, sl, syncs,
                      sync_units * prog.batch)
        metrics = {}
        for m in cell.per_layer:
            value = readers[m["name"]](ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=sl.busy_s, window_s=sl.wall_s)
        result["breakdown"] = trace.breakdown(sl)
        for name, ms, n in trace.by_name(sl)[:80]:
            log(f"traced {ms:10.3f} ms {n:6d}x {name[:150]}")

    map_state = prog.map_state()
    sample = sample_units(units, traffic, scene.n_on, seed)
    prog.close()
    log(f"on-map queries within 1 m and 5 deg of the ground truth (not "
        f"judged): {_ground_truth_share(units, scene)}")
    t_check = time.perf_counter()
    readings = reference_readings(cfg, params, scene, traffic, seed, dev,
                                  filler, map_state, sample)
    log(f"check: {len(sample)} sampled calls and the map against the "
        f"reference in {time.perf_counter() - t_check:.3f} s")
    if keep is not None:
        keep.update(cfg=cfg, params=params, scene=scene, traffic=traffic,
                    filler=filler, sample=sample)
    correct, table = check.verdict(readings, cell.limits)
    correct = correct and bool(sample) and failed == 0
    found = banned_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: "
                         f"{found}")
    for name, row in table.items():
        ok = row["limit"] is not None and row["value"] <= row["limit"]
        log(f"check {name} {row['value']!r} limit {row['limit']!r} "
            f"{'ok' if ok else 'FAIL'}")
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device_info}
    line.update(result)
    line["check"] = table
    return _finite(line)


def _ground_truth_share(units, scene) -> str:
    """On-map answers within 1 m and 5° of the synthetic ground truth,
    the query's world pose in its returned keyframe's frame (printed, not
    judged)."""
    def world_pose(p):
        (x, y, yaw), (roll, pitch, height) = p
        return rpose.rpy_matrix(roll, pitch, yaw), np.array([x, y, height])

    hits = total = 0
    for u in units:
        for p, a in zip(u.pool, u.answers or ()):
            if p >= scene.n_on:
                continue
            total += 1
            if not a.success or a.db_index >= len(scene.kf_poses):
                continue
            r_db, t_db = world_pose(scene.kf_poses[a.db_index])
            r_q, t_q = world_pose(scene.q_poses[p])
            pos = np.linalg.norm(r_db.T @ (t_q - t_db) - a.translation)
            rot = rpose.rotation_gap_deg(r_db.T @ r_q, a.rotation)
            hits += pos < 1.0 and rot < 5.0
    return f"{hits}/{total}"
