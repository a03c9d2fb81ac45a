"""A train step built from the port alone, for the card tests.

The card machine has PyTorch and no JAX or Flax, so a card test cannot take
its config, dataset and trainer from the JAX-parity tests. ``standalone_step``
builds them from ``gloc3d_tpu_torch`` only: the config of tests/test_train.py
(256-point scans, a 40 x 24 pillar grid, fp32), its clustered world with a
padded tail, the port's seeded init, NetVLAD initialised from data by the
port's ``init_vlad_from_data``, and one fixed mined batch. The CPU test runs
it in a fresh interpreter with ``flax`` and ``gloc3d_tpu`` blocked, one step
on each train path, so the repair shows without a card.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from gloc3d_tpu_torch.config import (
    BEVConfig, IndexConfig, ModelConfig, PipelineConfig, TrainConfig,
    VoxelConfig,
)
from gloc3d_tpu_torch.data.dataset import TripletDataset
from gloc3d_tpu_torch.models.descriptor import build_model, init_params
from gloc3d_tpu_torch.train import Trainer, init_vlad_from_data
from gloc3d_tpu_torch.train.trainer import rotate_clouds_z
from test_torch_threads import _two_threads  # noqa: F401


N_PTS = 256
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = PipelineConfig(
    bev=BEVConfig(image_size=128, max_points=N_PTS),
    voxel=VoxelConfig(max_points=N_PTS, xbound=(-10.0, 10.0, 0.5),
                      ybound=(-6.0, 6.0, 0.5)),
    model=ModelConfig(encoder="pointpillar", encoder_dim=128,
                      compute_dtype="float32"),
    index=IndexConfig(dim=128),
    train=TrainConfig(batch_size=2, n_neg=3, n_neg_sample=16,
                      cache_refresh_rate=8, epochs=2, eval_every=1, lr=1e-3,
                      augment_yaw=True),
)


def dataset(n_db=16, n_q=8, seed=0) -> TripletDataset:
    """tests/test_train.py's clustered world (scans near each other share
    structure) with the last 32 rows of every scan padding."""
    rng = np.random.RandomState(seed)
    db_inputs = np.zeros((n_db, N_PTS, 4), np.float32)
    utm_db = np.zeros((n_db, 2))
    for i in range(n_db):
        utm_db[i] = ((i % 4) * 60.0, (i // 4) * 60.0)
        site = np.random.RandomState(i)
        db_inputs[i, :, 0] = site.uniform(-9, 9, N_PTS)
        db_inputs[i, :, 1] = site.uniform(-5, 5, N_PTS)
        db_inputs[i, :, 2] = site.uniform(0, 3, N_PTS)
    q_inputs = np.zeros((n_q, N_PTS, 4), np.float32)
    utm_q = np.zeros((n_q, 2))
    for j in range(n_q):
        i = j % n_db
        utm_q[j] = utm_db[i] + rng.uniform(-3, 3, 2)
        q_inputs[j] = db_inputs[i]
        q_inputs[j, :, :2] += rng.normal(0, 0.05, (N_PTS, 2)).astype(
            np.float32)
    db_masks = np.ones((n_db, N_PTS), np.float32)
    q_masks = np.ones((n_q, N_PTS), np.float32)
    for a in (db_masks, q_masks, db_inputs, q_inputs):
        a[:, -32:] = 0.0
    return TripletDataset(db_inputs=db_inputs, q_inputs=q_inputs,
                          utm_db=utm_db, utm_q=utm_q, db_masks=db_masks,
                          q_masks=q_masks)


def standalone_trainer(cfg, workdir, device="cpu", seed=0) -> Trainer:
    """A port Trainer on the port's seeded init, NetVLAD from data."""
    ds = dataset()
    model = init_params(build_model(cfg.model, cfg.voxel), seed)
    init_vlad_from_data(cfg, model, ds.db_inputs, ds.db_masks,
                        torch.Generator().manual_seed(3), num_images=8,
                        per_image=50)
    return Trainer(cfg, model, ds, workdir, device=device)


def standalone_step(host_stats: bool, workdir, device="cpu",
                    tr: Trainer = None) -> Trainer:
    """One train step on one fixed mined batch (queries, positives,
    negatives, one padded negative slot, a fixed yaw) on the given path, by
    ``tr`` or a new standalone trainer; returns the trainer, its gradients
    kept."""
    cfg = CFG.replace(train=CFG.train.replace(host_stats=host_stats))
    tr = tr or standalone_trainer(cfg, workdir, device)
    b, n_neg = cfg.train.batch_size, cfg.train.n_neg
    ds = tr.ds
    q_in, q_mk = ds.q_inputs[:b], ds.q_masks[:b]
    p_in, p_mk = ds.db_inputs[:b], ds.db_masks[:b]
    n_in = ds.db_inputs[b:b + b * n_neg]
    n_mk = ds.db_masks[b:b + b * n_neg]
    neg_valid = np.ones((b, n_neg), np.float32)
    neg_valid[1, -1] = 0.0
    q_valid = np.ones(b, np.float32)
    yaw = np.array([0.4, -2.1], np.float32)
    if host_stats:
        q_rot = rotate_clouds_z(torch.from_numpy(q_in),
                                torch.from_numpy(yaw)).numpy()
        cat_in = np.concatenate([q_rot, p_in, n_in])
        cat_mk = np.concatenate([q_mk, p_mk, n_mk])
        loss = tr.train_step_hs(*tr._host_sorted(cat_in, cat_mk), neg_valid,
                                q_valid)
    else:
        loss = tr.train_step(q_in, q_mk, p_in, p_mk, n_in, n_mk, neg_valid,
                             q_valid, yaw=yaw)
    assert np.isfinite(float(loss)), "train step loss"
    return tr


def encoder_grads_nonzero(tr) -> dict:
    """Per encoder parameter: whether its gradient is there and nonzero."""
    return {name: p.grad is not None and float(p.grad.abs().max()) > 0
            for name, p in tr.model.named_parameters()
            if name.startswith("encoder.")}


def test_standalone_step_runs_without_flax_or_jax_package(tmp_path):
    """Both train paths, one step each, in an interpreter where importing
    flax or gloc3d_tpu fails: every encoder parameter gets a gradient."""
    code = textwrap.dedent(f"""
        import sys
        sys.modules["flax"] = None
        sys.modules["gloc3d_tpu"] = None
        sys.path[:0] = [{REPO!r}, {os.path.join(REPO, "tests")!r}]
        import torch
        torch.set_num_threads(2)
        from test_torch_standalone_train import (
            encoder_grads_nonzero, standalone_step)
        for hs in (False, True):
            tr = standalone_step(hs, {str(tmp_path)!r} + f"/run{{hs}}")
            grads = encoder_grads_nonzero(tr)
            bad = [k for k, ok in grads.items() if not ok]
            assert grads and not bad, (hs, bad)
            print("path", hs, len(grads), "encoder parameters")
        assert not any(m == "flax" or m.startswith(("flax.", "gloc3d_tpu."))
                       or m == "gloc3d_tpu"
                       for m, mod in sys.modules.items() if mod is not None)
        print("OK")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().endswith("OK")


@pytest.mark.parametrize("host_stats", [False, True])
def test_standalone_step_changes_the_weights(tmp_path, host_stats):
    """The standalone step is a real step: SGD moves the encoder."""
    cfg = CFG.replace(train=CFG.train.replace(host_stats=host_stats))
    tr = standalone_trainer(cfg, str(tmp_path))
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    standalone_step(host_stats, str(tmp_path), tr=tr)
    moved = [k for k, v in tr.model.state_dict().items()
             if k.startswith("encoder.") and v.is_floating_point()
             and not torch.equal(v, before[k])]
    assert moved
