"""One rank of the CPU process group that tests/test_torch_sharding.py
spawns: a gloo group over ``tcp://127.0.0.1:<port>`` runs every case of the
port's sharded search on the inputs the test wrote, and each rank writes
what it got to ``<dir>/rank<r>.npz`` for the test to hold against JAX.

    python tests/_torch_dist_worker.py RANK WORLD PORT DIR

Imports torch, numpy and the port only: neither JAX nor the tests' conftest
is loaded in a rank.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from gloc3d_tpu_torch.config import PipelineConfig  # noqa: E402
from gloc3d_tpu_torch.index.ivf import IVFBank, ShardedIVF  # noqa: E402
from gloc3d_tpu_torch.models.descriptor import build_model  # noqa: E402
from gloc3d_tpu_torch.ops.topk import quantize_rows  # noqa: E402
from gloc3d_tpu_torch.parallel import (  # noqa: E402
    ShardedBank, sharded_topk, sharded_topk_int8,
)
from gloc3d_tpu_torch.pipeline import GlobalLocalizer  # noqa: E402


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def case_topk(inp, out):
    """sharded_topk with and without ``valid``, a tie across the shards,
    sharded_topk_int8."""
    q, bank = _t(inp["topk_q"]), _t(inp["topk_bank"])
    res = {"": sharded_topk(None, q, bank, 10),
           "valid": sharded_topk(None, q, bank, 10, _t(inp["topk_valid"])),
           "tie": sharded_topk(None, _t(inp["tie_q"]), _t(inp["tie_bank"]),
                               4)}
    codes, scales, bsq = quantize_rows(_t(inp["int8_bank"]))
    res["int8"] = sharded_topk_int8(None, _t(inp["int8_q"]), codes, scales,
                                    bsq, 10)
    for name, (d2, idx) in res.items():
        out[f"topk_{name}_d2"], out[f"topk_{name}_id"] = _host(d2), _host(idx)


def case_bank(inp, out):
    """ShardedBank: ragged incremental adds, query, exclude_after,
    truncate, to_host; the int8 bank."""
    rows = inp["sb_rows"]
    sb = ShardedBank(None, dim=rows.shape[1], capacity=64, device="cpu")
    for i in range(0, len(rows), 5):
        sb.add(rows[i:i + 5])
    out["sb_len"] = len(sb)
    out["sb_local_rows"] = sb._bank.shape[0]
    out["sb_host"] = sb.to_host()
    q = rows[7:9] + 0.01
    out["sb_d2"], out["sb_id"] = sb.query(q, k=4)
    out["sb_x_d2"], out["sb_x_id"] = sb.query(q, k=4, exclude_after=8)
    sb.truncate(10)
    out["sb_t_d2"], out["sb_t_id"] = sb.query(q, k=4)
    d = inp["int8_bank"]
    sb8 = ShardedBank(None, dim=d.shape[1], capacity=len(d),
                      quantize="int8", device="cpu")
    sb8.add(d)
    out["sb8_d2"], out["sb8_id"] = sb8.query(inp["int8_q"], k=10)
    out["sb8_host"] = sb8.to_host()


def case_ivf(inp, out):
    """ShardedIVF on JAX's centroids, fp32 and int8: a query at nprobe <
    num_cells, exclude_after, an add after sharding."""
    for quantize in ("none", "int8"):
        data, q = inp[f"ivf_{quantize}_data"], inp[f"ivf_{quantize}_q"]
        ivf = IVFBank(dim=data.shape[1], num_cells=16, cell_capacity=64,
                      nprobe=4, quantize=quantize, device="cpu")
        ivf.centroids = _t(inp[f"ivf_{quantize}_centroids"])
        ivf.add(data[:1500])
        s = ShardedIVF(None, ivf)
        key = f"ivf_{quantize}"
        out[f"{key}_d2"], out[f"{key}_id"] = s.query(q, k=5)
        out[f"{key}_x_d2"], out[f"{key}_x_id"] = s.query(q, k=5,
                                                         exclude_after=700)
        s.add(data[1500:])
        out[f"{key}_add_d2"], out[f"{key}_add_id"] = s.query(q, k=5)
        out[f"{key}_local_cells"] = s._dev[0].shape[0]


def _locate(loc, inp, out, key, batch=False):
    results = (loc.locate_batch(inp["q_pts"], inp["q_mask"]) if batch else
               [loc.locate(p, m) for p, m in zip(inp["q_pts"],
                                                 inp["q_mask"])])
    for i, res in enumerate(results):
        out[f"{key}_{i}_ok"] = res.success
        out[f"{key}_{i}_db"] = res.db_index
        out[f"{key}_{i}_cand"] = np.asarray(res.candidates)
        out[f"{key}_{i}_dist"] = np.asarray(res.candidate_dists)
        out[f"{key}_{i}_t"] = (np.asarray(res.pose.translation)
                               if res.success else np.full(3, np.nan))


def case_localizer(inp, out, out_dir):
    """GlobalLocalizer.shard_bank on the flat bank: locate, an
    exclude-recent query, save, add_keyframes after sharding, and
    locate_fused's refusal; then the IVF backend trained on every rank,
    sharded and searched at full probe by ``locate_batch``."""
    cfg = PipelineConfig.from_json(str(inp["cfg_json"]))
    params = torch.load(os.path.join(out_dir, "params.pt"))
    pts, mask = inp["kf_pts"], inp["kf_mask"]

    def build(cfg):
        loc = GlobalLocalizer(cfg, build_model(cfg.model, cfg.voxel), params,
                              host_stats=True, device="cpu",
                              device_keyframes=True)
        for sl in (slice(0, 4), slice(4, None)):
            loc.add_keyframes(pts[sl], mask[sl])
        return loc

    loc = build(cfg)
    out["loc_flat_rows"] = loc.bank.data.numpy()
    loc.shard_bank(None)
    _locate(loc, inp, out, "loc")
    out["loc_xr_d2"], out["loc_xr_id"] = loc.bank.query(
        out["loc_flat_rows"][:1], k=3, exclude_recent=True)
    try:
        loc.locate_fused(inp["q_pts"][0], inp["q_mask"][0])
        out["loc_fused_refused"] = ""
    except RuntimeError as e:
        out["loc_fused_refused"] = str(e)
    loc.save(os.path.join(out_dir, "map"))
    loc.add_keyframes(inp["extra_pts"][None], inp["extra_mask"][None])
    out["loc_len_after_add"] = len(loc.bank)
    res = loc.locate(inp["extra_pts"], inp["extra_mask"])
    out["loc_extra_db"], out["loc_extra_cand"] = res.db_index, res.candidates

    ivf_cfg = cfg.replace(index=cfg.index.replace(
        backend="ivf", ivf_num_cells=2, ivf_nprobe=2, ivf_cell_capacity=4,
        ivf_train_sample=64))
    loc = build(ivf_cfg)
    loc.shard_bank(None)
    _locate(loc, inp, out, "ivf", batch=True)
    out["ivf_centroids"] = loc.bank._ivf.centroids.numpy()


def main(rank: int, world: int, port: int, out_dir: str) -> None:
    torch.set_num_threads(2)  # as the port's test files run
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
        out = {}
        case_topk(inp, out)
        case_bank(inp, out)
        case_ivf(inp, out)
        case_localizer(inp, out, out_dir)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
