"""One rank of the CPU process group that tests/test_torch_shard_store.py
spawns: a gloo group over ``tcp://127.0.0.1:<port>`` runs the sharded
keyframe store (``GlobalLocalizer.shard_keyframes``), the rotation-sharded
matcher (``match_scan_fast_sharded``) and ``make_mesh`` on the inputs the
test writes while the ranks start (``<dir>/inputs.npz``, awaited), and each
rank writes what it got to ``<dir>/rank<r>.npz``.

    python tests/_torch_store_worker.py RANK WORLD PORT DIR

Imports torch, numpy and the port only: neither JAX nor the tests' conftest
is loaded in a rank.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from gloc3d_tpu_torch.config import MeshConfig, PipelineConfig  # noqa: E402
from gloc3d_tpu_torch.models.descriptor import build_model  # noqa: E402
from gloc3d_tpu_torch.ops.occupancy import ProbabilityGrid2D  # noqa: E402
from gloc3d_tpu_torch.ops.scan_match import (  # noqa: E402
    match_scan_fast, match_scan_fast_sharded,
)
from gloc3d_tpu_torch.parallel import make_mesh  # noqa: E402
from gloc3d_tpu_torch.pipeline import GlobalLocalizer  # noqa: E402


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _record(out, key, results):
    """Each LocalizationResult's fields under ``key_<i>_<field>``."""
    for i, res in enumerate(results):
        out[f"{key}_{i}_ok"] = res.success
        out[f"{key}_{i}_db"] = res.db_index
        out[f"{key}_{i}_cand"] = np.asarray(res.candidates)
        out[f"{key}_{i}_dist"] = np.asarray(res.candidate_dists)
        out[f"{key}_{i}_score"] = res.match_score
        out[f"{key}_{i}_xy"] = (np.asarray(res.match_xy_yaw) if res.success
                                else np.full(3, np.nan))


def _shared_model(cfg, params):
    """One model for every localizer of the rank, its forward computed once
    per distinct input: the store is under test here, not the extraction
    (tests/test_torch_pipeline.py holds that to JAX), and the ten
    localizers' PointPillar forwards on the CPU would take most of the
    file's time."""
    model = build_model(cfg.model, cfg.voxel)
    model.load_state_dict(params)
    forward, cache = model.forward, {}

    def once(inputs, mask=None, voxel_stats=None):
        key = (inputs.numpy().tobytes(), mask.numpy().tobytes())
        if key not in cache:
            cache[key] = forward(inputs, mask, voxel_stats)
        return cache[key]

    model.forward = once
    return model


def _queries(loc, inp):
    """locate on each query, locate_batch on all, locate_fused on each."""
    qs = list(zip(inp["q_pts"], inp["q_mask"]))
    return ([loc.locate(p, m) for p, m in qs],
            loc.locate_batch(inp["q_pts"], inp["q_mask"]),
            [loc.locate_fused(p, m) for p, m in qs])


def case_store(inp, out, out_dir, rank):
    """The sharded store against the unsharded one: locate, locate_batch
    and locate_fused; the rows each rank holds; an add after sharding;
    growth past the first allocation; save and load with
    host_mirror=False; shard_bank on top."""
    cfg = PipelineConfig.from_json(str(inp["cfg_json"]))
    model = _shared_model(cfg, torch.load(os.path.join(out_dir,
                                                       "params.pt")))

    def build(**kw):
        loc = GlobalLocalizer(cfg, model, device="cpu",
                              device_keyframes=True, **kw)
        loc.add_keyframes(inp["kf_pts"], inp["kf_mask"])
        return loc

    try:
        GlobalLocalizer(cfg, model, device="cpu",
                        device_keyframes=True).shard_keyframes()
        out["no_store"] = ""
    except RuntimeError as e:
        out["no_store"] = str(e)

    base, loc = build(), build()
    loc.shard_keyframes(None)
    out["local_rows"] = loc._kf_store.shape[0]
    out["cap"] = loc._kf_cap
    for name, x in (("base", base), ("loc", loc)):
        for mode, results in zip(("", "_batch", "_fused"), _queries(x, inp)):
            _record(out, name + mode, results)

    for x in (base, loc):  # an add after sharding
        x.add_keyframes(inp["extra_pts"][None], inp["extra_mask"][None])
    _record(out, "extra", [loc.locate(inp["extra_pts"], inp["extra_mask"])])
    _record(out, "base_extra", [base.locate(inp["extra_pts"],
                                            inp["extra_mask"])])
    out["rows_base"] = base._store_rows(np.arange(4))[0].numpy()
    out["rows_loc"] = loc._store_rows(np.arange(4))[0].numpy()
    out["local_row1"] = loc._kf_store[1].numpy()  # global row 2 + rank

    # growth: rows written past the first 1024 land after the doubling,
    # the earlier rows stay where they were
    grow = inp["grow_images"]
    for x in (base, loc):
        x._store_keyframes(grow, inp["grow_origins"], offset=1020)
    out["grown_local_rows"] = loc._kf_store.shape[0]
    out["grown_cap"] = loc._kf_cap
    for name, x in (("base", base), ("loc", loc)):
        rows, org = x._store_rows(np.r_[0:4, 1016:1020 + len(grow)])
        out[f"grown_{name}"], out[f"grown_{name}_org"] = (rows.numpy(),
                                                          org.numpy())
    _record(out, "grown", _queries(loc, inp)[0])
    _record(out, "grown_base", _queries(base, inp)[0])

    # save with host_mirror=False: the images rebuilt from the shards
    if rank == 0:
        build(host_mirror=False).save(os.path.join(out_dir, "map_flat"))
    x = build(host_mirror=False)
    x.shard_keyframes(None)
    x.save(os.path.join(out_dir, "map"))
    back = build(host_mirror=False)
    back.shard_keyframes(None)
    back.load(os.path.join(out_dir, "map"))
    _record(out, "loaded", _queries(back, inp)[0])

    loc.shard_bank(None)  # a sharded bank over the sharded store
    _record(out, "both", [loc.locate(p, m) for p, m in
                          zip(inp["q_pts"], inp["q_mask"])])


def case_matcher(inp, out):
    """match_scan_fast_sharded at R = 64 against match_scan_fast; R = 63
    raises."""
    grid = ProbabilityGrid2D(_t(inp["grid_log_odds"]), _t(inp["grid_known"]),
                             _t(inp["grid_origin"]),
                             float(inp["grid_resolution"]))
    pts, mask = _t(inp["scan"]), torch.ones(len(inp["scan"]))
    res, cert = match_scan_fast_sharded(None, grid, pts, mask,
                                        num_rotations=64)
    one, cert1 = match_scan_fast(grid, pts, mask, num_rotations=64)
    out["m_pose"], out["m_score"], out["m_cert"] = (
        res.pose.numpy(), res.score.numpy(), cert.numpy())
    out["m1_pose"], out["m1_score"], out["m1_cert"] = (
        one.pose.numpy(), one.score.numpy(), cert1.numpy())
    try:
        match_scan_fast_sharded(None, grid, pts, mask, num_rotations=63)
        out["m_r63"] = ""
    except ValueError as e:
        out["m_r63"] = str(e)
    return grid, pts, mask


def case_mesh(out, rank, grid, pts, mask):
    """make_mesh at num_devices 0, 1 and 2; the one-rank group runs the
    sharded matcher on rank 0 alone."""
    out["mesh_0_default"] = make_mesh() is None
    out["mesh_2_default"] = make_mesh(MeshConfig(num_devices=2)) is None
    one = make_mesh(MeshConfig(num_devices=1))
    out["mesh_1_member"] = one != dist.GroupMember.NON_GROUP_MEMBER
    if rank == 0:
        out["mesh_1_size"] = dist.get_world_size(one)
        res, cert = match_scan_fast_sharded(one, grid, pts, mask,
                                            num_rotations=64)
        out["mesh_1_pose"], out["mesh_1_cert"] = (res.pose.numpy(),
                                                  cert.numpy())


def main(rank: int, world: int, port: int, out_dir: str) -> None:
    torch.set_num_threads(2)  # as the port's test files run
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        # the test writes the inputs while the ranks start
        path = os.path.join(out_dir, "inputs.npz")
        for _ in range(6000):
            if os.path.exists(path):
                break
            time.sleep(0.1)
        inp = dict(np.load(path))
        out = {}
        case_store(inp, out, out_dir, rank)
        grid, pts, mask = case_matcher(inp, out)
        case_mesh(out, rank, grid, pts, mask)
        out["jax_modules"] = np.array(sorted(
            m for m in sys.modules if m.split(".")[0] in (
                "jax", "jaxlib", "flax", "gloc3d_tpu")), dtype=str)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
