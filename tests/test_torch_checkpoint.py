"""Reference checkpoints into the port: ``convert.load_reference_checkpoint``.

The port's seeded model (BatchNorm running statistics made non-trivial)
stands in for a trained reference checkpoint: saved as the reference saves
it, ``{'state_dict': {'module.' + name: tensor}}``, it loads back equal. The
same dict through the JAX package's converter (``tools/
convert_torch_checkpoint.py``) and npz loader gives a JAX forward that the
port's forward matches at fp32 within atol 2e-4 / rtol 2e-3, the descriptor
bound of tests/test_torch_pointpillar.py (fp32 sums in another order).
A checkpoint that carries the pose head ``encoder.conv_out_pose.*`` loads
strictly into a PointPillar built with both heads; into the s2s
DescriptorModel with the pose entries handed back by name; and its pose
head's forward matches JAX's (mode "pose") from the same converted file.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gloc3d_tpu.config import ModelConfig, VoxelConfig
from gloc3d_tpu.data.native import compute_voxel_stats_host_sorted
from gloc3d_tpu.models import build_model as jax_build_model
from gloc3d_tpu.models.pointpillar import PointPillar as JaxPointPillar
from gloc3d_tpu.models.pointpillar import load_pointpillar_npz
from gloc3d_tpu_torch.convert import (
    POSE_HEAD, encoder_state_dict, load_reference_checkpoint,
    load_reference_into,
)
from gloc3d_tpu_torch.models.descriptor import build_model, init_params
from gloc3d_tpu_torch.models.pointpillar import PointPillar
from test_pipeline import scan_at
from test_torch_threads import _two_threads  # noqa: F401


N_PTS = 2048
VC = VoxelConfig(max_points=N_PTS)
MC = ModelConfig(encoder="pointpillar", encoder_dim=128,
                 compute_dtype="float32")
DESC_TOL = dict(atol=2e-4, rtol=2e-3)
TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


def _reference_state_dict():
    """A seeded port model's state dict with random BN running stats."""
    model = init_params(build_model(MC, VC), seed=5)
    rng = np.random.RandomState(5)
    sd = model.state_dict()
    for k, v in sd.items():
        if k.endswith("running_mean"):
            v.copy_(torch.from_numpy(0.1 * rng.randn(*v.shape)))
        elif k.endswith("running_var"):
            v.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, v.shape)))
    return sd


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


@pytest.mark.parametrize("wrapped,prefixed,from_path", [
    (True, True, True), (True, False, True), (False, True, False),
    (False, False, False)])
def test_reference_checkpoint_loads_back_equal(tmp_path, wrapped, prefixed,
                                               from_path):
    sd = _reference_state_dict()
    saved = {("module." + k if prefixed else k): v for k, v in sd.items()}
    obj = {"state_dict": saved, "epoch": 3} if wrapped else saved
    if from_path:
        path = tmp_path / "checkpoint.pth.tar"
        torch.save(obj, path)
        obj = str(path)
    got = load_reference_checkpoint(obj)
    _assert_same(got, sd)
    model = build_model(MC, VC)
    model.load_state_dict(got)  # strict: every name is the port's


def test_reference_checkpoint_rejects_other_objects():
    with pytest.raises(TypeError, match="state dict"):
        load_reference_checkpoint([1, 2, 3])


def test_reference_checkpoint_forward_matches_jax(tmp_path):
    sd = _reference_state_dict()
    blob = {"state_dict": {"module." + k: v for k, v in sd.items()}}
    path = tmp_path / "checkpoint.pth.tar"
    torch.save(blob, path)

    sys.path.insert(0, TOOLS)
    try:
        from convert_torch_checkpoint import convert_pointpillar_checkpoint
    finally:
        sys.path.remove(TOOLS)
    npz = str(tmp_path / "checkpoint.npz")
    np.savez(npz, **convert_pointpillar_checkpoint(blob["state_dict"]))

    scans = [scan_at(3, -5, 0.7, n=N_PTS), scan_at(-10, 12, 2.5, n=N_PTS)]
    pts = np.stack([s[0] for s in scans])
    counts = np.asarray([s[1].sum() for s in scans], np.int64)
    p, v, *vs = compute_voxel_stats_host_sorted(
        pts, counts, VC.xbound, VC.ybound, VC.zbound, crop=False,
        per_point=True)
    jmodel = jax_build_model(MC, VC)
    jvs = tuple(jnp.asarray(a) for a in vs)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(p),
                                     jnp.asarray(v), voxel_stats=jvs)
    variables = load_pointpillar_npz(variables, npz)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(p),
                                   jnp.asarray(v), voxel_stats=jvs))

    model = build_model(MC, VC)
    model.load_state_dict(load_reference_checkpoint(str(path)))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(p), torch.from_numpy(v),
                    voxel_stats=tuple(torch.from_numpy(a) for a in vs)
                    ).numpy()
    assert got.shape == want.shape == (2, 128)
    np.testing.assert_allclose(got, want, **DESC_TOL)


def _reference_with_pose_head():
    """The reference state dict plus a seeded pose head with random BN
    running statistics, as a reference s2s checkpoint may carry it."""
    sd = _reference_state_dict()
    pp = init_params(PointPillar(VC.xbound, VC.ybound, VC.zbound,
                                 torch.float32, mode="both"), seed=6)
    rng = np.random.RandomState(6)
    for k, v in pp.state_dict().items():
        if not k.startswith("conv_out_pose."):
            continue
        if k.endswith("running_mean"):
            v = torch.from_numpy(0.1 * rng.randn(*v.shape).astype(np.float32))
        elif k.endswith("running_var"):
            v = torch.from_numpy(rng.uniform(0.5, 2.0, v.shape).astype(
                np.float32))
        sd["encoder." + k] = v
    return sd


def test_checkpoint_with_pose_head_loads(tmp_path):
    sd = _reference_with_pose_head()
    path = tmp_path / "checkpoint.pth.tar"
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}},
               path)
    got = load_reference_checkpoint(str(path))
    pose = sorted(k for k in got if k.startswith(POSE_HEAD))
    assert len(pose) == 12  # two conv weights, two BatchNorms of 5 entries

    # strictly into a PointPillar that has both heads
    pp = PointPillar(VC.xbound, VC.ybound, VC.zbound, torch.float32,
                     mode="both")
    pp.load_state_dict(encoder_state_dict(got))
    # into the descriptor model: the pose head handed back by name
    model = build_model(MC, VC)
    with pytest.raises(RuntimeError, match="conv_out_pose"):
        model.load_state_dict(got)
    rest = load_reference_into(model, got)
    assert sorted(rest) == pose
    assert all(torch.equal(rest[k], sd[k]) for k in pose)
    _assert_same({k: v for k, v in model.state_dict().items()},
                 {k: v for k, v in sd.items() if k not in rest})
    # any other stray or missing key still raises
    with pytest.raises(RuntimeError, match="stray"):
        load_reference_into(build_model(MC, VC), {**got, "stray": rest[pose[0]]})


def test_checkpoint_pose_head_forward_matches_jax(tmp_path):
    sd = _reference_with_pose_head()
    sys.path.insert(0, TOOLS)
    try:
        from convert_torch_checkpoint import convert_pointpillar_checkpoint
    finally:
        sys.path.remove(TOOLS)
    npz = str(tmp_path / "checkpoint.npz")
    np.savez(npz, **convert_pointpillar_checkpoint(sd))

    scans = [scan_at(3, -5, 0.7, n=N_PTS), scan_at(-10, 12, 2.5, n=N_PTS)]
    pts = np.stack([s[0] for s in scans])
    mask = np.stack([s[1] for s in scans]).astype(np.float32)
    jm = JaxPointPillar(xbound=VC.xbound, ybound=VC.ybound,
                        zbound=VC.zbound, compute_dtype=jnp.float32)
    v = jax.jit(lambda k, p, m: jm.init(k, p, m, mode="both"))(
        jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(mask))
    v = load_pointpillar_npz({"params": {"encoder": v["params"]},
                              "batch_stats": {"encoder": v["batch_stats"]}},
                             npz)
    v = {"params": v["params"]["encoder"],
         "batch_stats": v["batch_stats"]["encoder"]}
    want = np.asarray(jax.jit(lambda v, p, m: jm.apply(v, p, m, mode="pose"))(
        v, jnp.asarray(pts), jnp.asarray(mask)))

    pp = PointPillar(VC.xbound, VC.ybound, VC.zbound, torch.float32,
                     mode="both")
    pp.load_state_dict(encoder_state_dict(sd))
    pp.eval()
    with torch.no_grad():
        got = pp(torch.from_numpy(pts), torch.from_numpy(mask),
                 mode="pose").numpy()
    assert got.shape == want.shape == (2, 80, 140, 128)
    np.testing.assert_allclose(got, want, **DESC_TOL)
