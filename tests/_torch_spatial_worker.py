"""One rank of the CPU process group that tests/test_torch_spatial.py
spawns: a gloo group over ``tcp://127.0.0.1:<port>`` runs the i2i spatial
partition (``parallel/spatial.py::spatial_sharded_apply`` and
``GlobalLocalizer.shard_spatial``) on the inputs the test writes while the
ranks start (``<dir>/inputs.npz``, awaited), and each rank writes what it
got to ``<dir>/rank<r>.npz``.

    python tests/_torch_spatial_worker.py RANK WORLD PORT DIR

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

from gloc3d_tpu_torch.config import PipelineConfig  # noqa: E402
from gloc3d_tpu_torch.models.descriptor import (  # noqa: E402
    build_model, init_params,
)
from gloc3d_tpu_torch.parallel import spatial_sharded_apply  # noqa: E402
from gloc3d_tpu_torch.pipeline import GlobalLocalizer  # noqa: E402

# the zoo: (encoder, its channels, pooling, image size); AlexNet's bands at
# 96² are uneven (23 → 11 → 5 rows), and ResNet18 at 32² leaves rank 0 no
# row of the last stage's single row
ZOO = (("resnet18", 512, "netvlad", 96), ("mobilenet", 320, "max", 96),
       ("alexnet", 256, "avg", 96), ("resnet18", 512, "netvlad", 32))


def _record(out, key, results):
    for i, res in enumerate(results):
        out[f"{key}_{i}_ok"] = res.success
        out[f"{key}_{i}_db"] = res.db_index
        out[f"{key}_{i}_cand"] = np.asarray(res.candidates)
        out[f"{key}_{i}_dist"] = np.asarray(res.candidate_dists)
        out[f"{key}_{i}_t"] = (np.asarray(res.pose.translation)
                               if res.success else np.full(3, np.nan))


def case_vgg(inp, out, out_dir):
    """VGG16 + NetVLAD-FC: the spatial forward against the unsharded one;
    shard_spatial + add_keyframes, locate_batch, locate and locate_fused
    against the unsharded localizer."""
    cfg = PipelineConfig.from_json(str(inp["cfg_json"]))
    model = build_model(cfg.model, cfg.voxel)
    model.load_state_dict(torch.load(os.path.join(out_dir, "params.pt")))
    model.eval()
    imgs = torch.from_numpy(inp["imgs"])
    with torch.no_grad():
        out["vgg_ref"] = model(imgs).numpy()
    out["vgg_sp"] = spatial_sharded_apply(None, model)(imgs).numpy()
    try:  # a band's rows over every rank are its width: square images only
        spatial_sharded_apply(None, model)(imgs[:, :, :-16])
        out["non_square"] = "returned"
    except ValueError as e:
        out["non_square"] = str(e)

    db3, q3 = inp["db3"], inp["q3"]
    for name in ("base", "sp"):
        loc = GlobalLocalizer(cfg, model, device="cpu", device_keyframes=True)
        if name == "sp":
            loc.shard_spatial(None)
            loc.shard_extraction(None)  # images keep the spatial forward
        loc.add_keyframes(db3)
        out[f"{name}_bank"] = loc.bank.data.numpy()
        _record(out, f"{name}_batch", loc.locate_batch(q3))
        _record(out, f"{name}_one", [loc.locate(q3[0])])
        _record(out, f"{name}_fused", [loc.locate_fused(q3[1])])


def case_zoo(inp, out):
    """Each zoo encoder's spatial forward against its unsharded forward,
    fp32, seeded weights with non-trivial BatchNorm statistics."""
    cfg = PipelineConfig.from_json(str(inp["cfg_json"]))
    for enc, dim, pool, s in ZOO:
        mc = cfg.model.replace(encoder=enc, encoder_dim=dim, pooling=pool)
        model = init_params(build_model(mc, cfg.voxel), seed=0).eval()
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                    m.running_mean.copy_(0.1 * torch.randn(
                        m.running_mean.shape, generator=g))
                    m.running_var.uniform_(0.5, 2.0, generator=g)
            imgs = torch.from_numpy(inp["imgs"][:, :s, :s])
            out[f"{enc}_{s}_ref"] = model(imgs).numpy()
        out[f"{enc}_{s}_sp"] = spatial_sharded_apply(None, model)(
            imgs).numpy()


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
        case_vgg(inp, out, out_dir)
        case_zoo(inp, out)
        out["jax_modules"] = np.array(sorted(
            m for m in sys.modules if m.split(".")[0] in (
                "jax", "jaxlib", "flax", "gloc3d_tpu")), dtype=str)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
