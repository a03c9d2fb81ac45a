"""A multi-rank dry run: the port's counterpart of the JAX package's
``dryrun_multichip``, which jits the full train step over an n-device mesh.

``dryrun_multichip(n)`` spawns n ranks of one process group
(``parallel/launch.py``; no virtual mesh is needed: a process group of n
ranks runs anywhere) and runs, at a tiny size (128-point clouds, a 32 × 16
pillar grid, 64² BEV images):

- one full all-device train step of ``Trainer(mesh=...)`` (a batch of n
  queries, two negatives each), its loss finite and the parameters equal
  on every rank;
- a ``sharded_topk`` query over an (16 n, 128) bank;
- data-parallel extraction into a sharded bank (``shard_extraction``,
  ``add_keyframes`` with the device keyframe store, ``shard_bank``), then
  ``locate_batch``, equal to the one-process pipeline: on the all-device,
  host-stats and aligned paths.

Returns rank 0's summary (the loss, located query counts, whether each
rank loaded JAX) and prints it.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from gloc3d_tpu_torch.core.device import resolve_device
from gloc3d_tpu_torch.parallel.launch import spawn

N_PTS = 128


def _cloud(rng, m):
    out = np.zeros((m, N_PTS, 4), np.float32)
    out[:, :, 0] = rng.uniform(-7, 7, (m, N_PTS))
    out[:, :, 1] = rng.uniform(-3.5, 3.5, (m, N_PTS))
    out[:, :, 2] = rng.uniform(0, 3, (m, N_PTS))
    return out


def _walls_scan(seed):
    r = np.random.RandomState(seed)
    out = np.zeros((N_PTS, 4), np.float32)
    k = 0
    while k < N_PTS:
        x0, y0 = r.uniform(-6, 6, 2)
        ang = r.uniform(0, np.pi)
        m = min(32, N_PTS - k)
        ts = r.uniform(0, 4, m)
        out[k:k + m, 0] = x0 + np.cos(ang) * ts
        out[k:k + m, 1] = y0 + np.sin(ang) * ts
        out[k:k + m, 2] = r.uniform(0, 3, m)
        k += m
    return out


def _ground_scan(seed):
    """A wall scan with a quarter of its rows on a tilted ground disk."""
    sc = _walls_scan(seed)
    r = np.random.RandomState(7000 + seed)
    ng = N_PTS // 4
    rad = 6.0 * np.sqrt(r.uniform(0, 1, ng))
    th = r.uniform(0, 2 * np.pi, ng)
    sc[:ng, 0] = rad * np.cos(th)
    sc[:ng, 1] = rad * np.sin(th)
    sc[:ng, 2] = -1.7 + r.normal(0, 0.02, ng)
    roll, pitch = r.uniform(-0.03, 0.03, 2)
    cr, sr, cp, sp = np.cos(roll), np.sin(roll), np.cos(pitch), np.sin(pitch)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]], np.float32)
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]], np.float32)
    sc[:, :3] = sc[:, :3] @ (ry @ rx).T
    return sc


def _config(n: int):
    from gloc3d_tpu_torch.config import (
        BEVConfig, GroundConfig, IndexConfig, MatchConfig, ModelConfig,
        PipelineConfig, TrainConfig, VoxelConfig,
    )

    return PipelineConfig(
        bev=BEVConfig(image_size=64, max_points=N_PTS),
        voxel=VoxelConfig(max_points=N_PTS, xbound=(-8.0, 8.0, 0.5),
                          ybound=(-4.0, 4.0, 0.5)),
        model=ModelConfig(encoder="pointpillar", encoder_dim=128,
                          compute_dtype="float32"),
        index=IndexConfig(dim=128, top_k=3, capacity=4 * n),
        match=MatchConfig(image_size=64, min_score=0.05,
                          min_overlap_pixels=4),
        ground=GroundConfig(num_candidates=N_PTS, ransac_iters=64),
        train=TrainConfig(batch_size=n, n_neg=2, n_neg_sample=8))


def _same_results(tag, a, b, atol):
    located = 0
    for ra, rb in zip(a, b):
        if (ra.success != rb.success or ra.db_index != rb.db_index
                or not np.array_equal(ra.candidates, rb.candidates)):
            raise AssertionError(f"{tag}: sharded locate_batch diverged")
        if ra.success:
            located += 1
            np.testing.assert_allclose(np.asarray(rb.pose.translation),
                                       np.asarray(ra.pose.translation),
                                       atol=atol, err_msg=tag)
    return located


def _dryrun_rank(rank: int, n: int, device: torch.device, out_dir: str):
    from gloc3d_tpu_torch.data.dataset import TripletDataset
    from gloc3d_tpu_torch.models.descriptor import build_model, init_params
    from gloc3d_tpu_torch.parallel.collectives import (
        all_gather, same_on_every_rank,
    )
    from gloc3d_tpu_torch.parallel.sharding import sharded_topk
    from gloc3d_tpu_torch.pipeline import GlobalLocalizer
    from gloc3d_tpu_torch.train import Trainer

    cfg = _config(n)
    rng = np.random.RandomState(0)
    ds = TripletDataset(
        db_inputs=_cloud(rng, 4 * n), q_inputs=_cloud(rng, n),
        utm_db=rng.randn(4 * n, 2) * 100, utm_q=rng.randn(n, 2) * 100,
        db_masks=np.ones((4 * n, N_PTS), np.float32),
        q_masks=np.ones((n, N_PTS), np.float32))
    params = init_params(build_model(cfg.model, cfg.voxel), seed=0
                         ).state_dict()

    # one full train step over the group
    model = build_model(cfg.model, cfg.voxel)
    model.load_state_dict(params)
    tr = Trainer(cfg, model, ds, os.path.join(out_dir, "train"),
                 device=device, mesh=dist.group.WORLD)
    n_neg = cfg.train.n_neg
    loss = float(tr.train_step(
        ds.q_inputs, ds.q_masks, ds.db_inputs[:n], ds.db_masks[:n],
        ds.db_inputs[:n * n_neg], ds.db_masks[:n * n_neg],
        np.ones((n, n_neg), np.float32), np.ones(n, np.float32)))
    if not np.isfinite(loss):
        raise AssertionError(f"dry-run train loss not finite: {loss}")
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    if not same_on_every_rank(None, flat):
        raise AssertionError("dry-run parameters differ across ranks")

    # a sharded-bank query: local top-k, one all-gather, the merge
    bank = torch.from_numpy(rng.randn(16 * n, 128).astype(np.float32))
    queries = torch.from_numpy(rng.randn(3, 128).astype(np.float32))
    _, idx = sharded_topk(None, queries.to(device), bank.to(device), 5)
    if tuple(idx.shape) != (3, 5):
        raise AssertionError(f"sharded_topk ids {tuple(idx.shape)}")

    # serving over the group: DP extraction, sharded bank, locate_batch
    def localizer(**kw):
        m = build_model(cfg.model, cfg.voxel)
        m.load_state_dict(params)
        return GlobalLocalizer(cfg, m, device=device, **kw)

    def serve(db, db_m, q, q_m, **kw):
        single = localizer(**kw)
        single.add_keyframes(db, db_m)
        multi = localizer(device_keyframes=True, **kw)
        multi.shard_extraction(None)
        multi.add_keyframes(db, db_m)
        multi.shard_bank(None)
        return single.locate_batch(q, q_m), multi.locate_batch(q, q_m)

    db = np.stack([_walls_scan(s) for s in range(2 * n)])
    db_m = np.ones((2 * n, N_PTS), np.float32)
    located = _same_results("all-device", *serve(db, db_m, db[:n] + 0.0,
                                                 db_m[:n]), 1e-4)
    _same_results("host stats", *serve(db, db_m, db[:n] + 0.0, db_m[:n],
                                       host_stats=True), 1e-4)
    adb = np.stack([_ground_scan(s) for s in range(2 * n)])
    aligned = _same_results("aligned", *serve(adb, db_m, adb[:n] + 0.0,
                                              db_m[:n], align_ground=True),
                            1e-3)

    loaded = any(m == "jax" or m.startswith(("jax.", "flax", "gloc3d_tpu."))
                 for m in sys.modules)
    flags = all_gather(None, torch.tensor([int(loaded)], device=device))
    if rank == 0:
        with open(os.path.join(out_dir, "summary.json"), "w") as f:
            json.dump({"ranks": n, "loss": loss, "located": located,
                       "aligned_located": aligned, "queries": n,
                       "ranks_loaded_jax": [bool(v) for v in
                                            flags.reshape(-1).tolist()]}, f)
    dist.barrier()


def dryrun_multichip(n: int, device=None) -> dict:
    """Run the dry run over n spawned ranks on ``device`` (default: the
    card; ``"cpu"`` for gloo CPU ranks) → rank 0's summary."""
    device = resolve_device(device, "dryrun_multichip")
    with tempfile.TemporaryDirectory() as tmp:
        spawn(_dryrun_rank, n, device, args=(tmp,))
        with open(os.path.join(tmp, "summary.json")) as f:
            summary = json.load(f)
    if summary["located"] < 1 or summary["aligned_located"] < 1:
        raise AssertionError(f"dry run located no query: {summary}")
    print(f"dryrun_multichip({n}): train step loss {summary['loss']:.4f}, "
          f"sharded topk ok, DP extraction + sharded bank + device "
          f"keyframe store + locate_batch equal to one process on "
          f"{summary['located']}/{n} located queries (all-device), host "
          f"stats equal, aligned equal on {summary['aligned_located']}/{n}")
    return summary
