"""One rank of the CPU process group that tests/test_torch_dp.py spawns: a
gloo group over ``tcp://127.0.0.1:<port>`` runs the port's data-parallel
training and extraction on the inputs the test wrote, and each rank writes
what it got to ``<dir>/rank<r>.npz`` for the test to hold against JAX and
against the port's one-process calls, which the ranks also make, half on
each rank. The ranks start while the test still computes the inputs, and
wait for ``<dir>/inputs.npz``.

    python tests/_torch_dp_worker.py RANK WORLD PORT DIR

Imports torch, numpy and the port only: neither JAX nor the tests' conftest
is loaded in a rank (each rank records whether it was).
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

from gloc3d_tpu_torch.config import PipelineConfig  # noqa: E402
from gloc3d_tpu_torch.data.dataset import TripletDataset  # noqa: E402
from gloc3d_tpu_torch.models.descriptor import build_model  # noqa: E402
from gloc3d_tpu_torch.models.encoders import train_mask  # noqa: E402
from gloc3d_tpu_torch.pipeline import GlobalLocalizer  # noqa: E402
from gloc3d_tpu_torch.train import Trainer  # noqa: E402
from gloc3d_tpu_torch.train import trainer as trainer_module  # noqa: E402

STEPS = ("device", "hoststats", "trap", "i2i")
EPOCHS = ("epoch", "epoch_hs")  # all-device, host stats


def _cfg(inp, key):
    return PipelineConfig.from_json(str(inp[f"{key}_cfg"]))


def _model(cfg, out_dir, name):
    model = build_model(cfg.model, cfg.voxel)
    model.load_state_dict(torch.load(os.path.join(out_dir, f"{name}.pt")))
    return model


def _dataset(inp, key):
    masks = {k: inp[f"{key}_{k}"] if f"{key}_{k}" in inp else None
             for k in ("db_masks", "q_masks")}
    return TripletDataset(db_inputs=inp[f"{key}_db_inputs"],
                          q_inputs=inp[f"{key}_q_inputs"],
                          utm_db=inp[f"{key}_utm_db"],
                          utm_q=inp[f"{key}_utm_q"], **masks)


def trainer(inp, out_dir, key, weights, workdir, mesh, **kw):
    cfg = _cfg(inp, key)
    model = _model(cfg, out_dir, weights)
    if cfg.model.encoder != "pointpillar":
        kw["trainable_mask"] = train_mask(model, cfg.model.encoder)
    return Trainer(cfg, model, _dataset(inp, "i2i" if key == "i2i" else
                                        "s2s"), workdir, device="cpu",
                   mesh=mesh, **kw)


def _state(out, key, model):
    for k, v in model.state_dict().items():
        out[f"{key}/{k}"] = v.numpy().copy()  # not a view of the model


def case_steps(inp, out, out_dir, mesh, keys=STEPS, prefix=""):
    """One data-parallel step per path of ``keys`` from the whole batch,
    and the weights each rank held before it (rank 0's, broadcast); with
    mesh None the one-process step, its keys under ``prefix``."""
    for key in keys:
        tr = trainer(inp, out_dir, key, "i2i" if key == "i2i" else "s2s",
                     os.path.join(out_dir, f"wd_{prefix}{key}"), mesh,
                     seed=int(inp["seed"]))
        if mesh is not None:
            _state(out, f"{key}_old", tr.model)
        if key == "i2i" and mesh is not None:
            for name, trained in (("frozen", False), ("trained", True)):
                out[f"i2i_{name}"] = np.array([
                    k for k, p in tr.model.named_parameters()
                    if p.requires_grad == trained])
        b = {k: inp[f"{key}_{k}"] for k in (
            "q", "qm", "p", "pm", "n", "nm", "nv", "qv", "yaw")
             if f"{key}_{k}" in inp}
        loss = tr.train_step(b["q"], b.get("qm"), b["p"], b.get("pm"),
                             b["n"], b.get("nm"), b["nv"], b["qv"],
                             yaw=b.get("yaw"))
        out[f"{prefix}{key}_loss"] = float(loss)
        _state(out, f"{prefix}{key}", tr.model)


def case_epoch(inp, out, out_dir, mesh, key, prefix=""):
    """One train_epoch of the config ``key`` (all-device or host stats)
    over the ranks (its mined triplets recorded), then a checkpoint,
    counting this rank's writes; with mesh None the one-process epoch, its
    keys under ``prefix``."""
    mined, saved = [], []
    mine, save = trainer_module.mine_triplets, torch.save

    def recording_mine(*a, **k):
        m = mine(*a, **k)
        mined.append(np.concatenate([m.pos_idx[:, None].numpy(),
                                     m.neg_idx.numpy()], 1))
        return m

    def counting_save(obj, path, *a, **k):
        saved.append(str(path))
        return save(obj, path, *a, **k)

    workdir = os.path.join(out_dir, f"{prefix}{key}")
    tr = trainer(inp, out_dir, key, "s2s", workdir, mesh)
    losses, step = [], tr._train_batch

    def recording_step(*a, **k):
        loss = step(*a, **k)
        if loss is not None:
            losses.append(float(loss))
        return loss

    tr._train_batch = recording_step
    trainer_module.mine_triplets = recording_mine
    torch.save = counting_save
    try:
        out[f"{prefix}{key}_loss"] = tr.train_epoch(1)
        out[f"{prefix}{key}_losses"] = np.array(losses)
        tr.save_checkpoint("latest")
    finally:
        trainer_module.mine_triplets, torch.save = mine, save
    out[f"{prefix}{key}_mined"] = np.stack(mined)
    out[f"{prefix}{key}_neg_cache"] = tr.neg_cache.numpy()
    out[f"{prefix}{key}_steps"] = tr.step
    out[f"{prefix}{key}_writes"] = len(saved)
    _state(out, f"{prefix}{key}", tr.model)


def _bev(out, key, desc, bev, ground=None):
    out[f"{key}_desc"] = desc.numpy()
    for name in ("image", "origin_xy", "num_occupied"):
        x = getattr(bev, name)
        out[f"{key}_{name}"] = x.numpy() if isinstance(x, torch.Tensor) else x
    if ground is not None:
        out[f"{key}_ground_q"] = ground.transform.rotation.numpy()
        out[f"{key}_ground_t"] = ground.transform.translation.numpy()
        out[f"{key}_ground_valid"] = ground.valid.numpy()


def case_extract(inp, out, out_dir, mesh):
    """shard_extraction on the all-device, host-stats, i2i-image and
    aligned paths, a batch the group's size does not divide, and the
    aligned path's unsharded call with the same seed."""
    cfg = _cfg(inp, "x")
    pts, mask = inp["x_pts"], inp["x_mask"]

    def localizer(c, weights, **kw):
        return GlobalLocalizer(c, _model(c, out_dir, weights), device="cpu",
                               **kw)

    for key, host_stats in (("x_device", False), ("x_hoststats", True)):
        loc = localizer(cfg, "x", host_stats=host_stats)
        loc.shard_extraction(mesh)
        _bev(out, key, *loc.extract(pts, mask)[:2])
        _bev(out, f"{key}_odd", *loc.extract(pts[:3], mask[:3])[:2])
        plain = localizer(cfg, "x", host_stats=host_stats)
        _bev(out, f"{key}_plain", *plain.extract(pts[:3], mask[:3])[:2])
    icfg = _cfg(inp, "xi")
    loc = localizer(icfg, "i2i")
    loc.shard_extraction(mesh)
    _bev(out, "x_i2i", *loc.extract(inp["xi_images"],
                                    origins=inp["xi_origins"])[:2])
    acfg = _cfg(inp, "xa")
    for key, sharded in (("x_aligned", True), ("x_aligned_plain", False)):
        loc = localizer(acfg, "x", align_ground=True, seed=5)
        if sharded:
            loc.shard_extraction(mesh)
        _bev(out, key, *loc.extract(inp["xa_pts"], inp["xa_mask"]))
        out[f"{key}_gen"] = loc._gen.get_state().numpy()


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
        mesh = dist.group.WORLD
        case_steps(inp, out, out_dir, mesh)
        for key in EPOCHS:
            case_epoch(inp, out, out_dir, mesh, key)
        case_extract(inp, out, out_dir, mesh)
        # the port's one-process calls on the same weights and batches,
        # half on each rank
        case_steps(inp, out, out_dir, None, STEPS[2 * rank:2 * rank + 2],
                   prefix="one_")
        case_epoch(inp, out, out_dir, None, EPOCHS[rank], prefix="one_")
        out["jax_loaded"] = any(m == "jax" or m.startswith(("jax.", "flax",
                                                            "gloc3d_tpu."))
                                for m in sys.modules)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
