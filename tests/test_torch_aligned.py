"""The gravity-aligned located query in the port (``align_ground=True``), on
the all-device path and on the host-stats path, at a small size on the CPU
(kernels run their plain versions).

Tilted scans of the synthetic world of tests/test_pipeline_ground.py: the
query must localize within the reference's 1 m / 5° gate in 6-DoF and
recover the height difference within 0.3 m, and the two extraction paths
must agree (same ground transform and BEV exactly, descriptors to atol 2e-4
/ rtol 2e-3, the bound tests/test_pipeline_hoststats.py holds between the
two JAX paths)."""

import numpy as np
import pytest
import torch

from gloc3d_tpu_torch.core.transforms import Rigid3, quat_from_rpy
from gloc3d_tpu_torch.eval.registration import (
    compose_6dof, registration_errors,
)
from gloc3d_tpu_torch.models.descriptor import build_model, init_params
from gloc3d_tpu_torch.pipeline import GlobalLocalizer, Keyframe
from test_pipeline import scan_at
from test_pipeline_ground import CFG, tilted_scan
from test_torch_threads import _two_threads  # noqa: F401


DB_POSES = [(-30, -30, 0.0), (0, -30, 0.4), (30, 0, 1.5), (0, 30, 3.0)]
DB_TILTS = [(0.02, -0.01), (-0.015, 0.02), (0.01, 0.015), (-0.02, -0.02)]
DESC_TOL = dict(atol=2e-4, rtol=2e-3)


def _model():
    return init_params(build_model(CFG.model, CFG.voxel), seed=0)


@pytest.fixture(scope="module")
def localizer():
    loc = GlobalLocalizer(CFG, _model(), host_stats=False, align_ground=True,
                          device="cpu")
    scans = [tilted_scan(*p, roll=r, pitch=pi, seed=i)
             for i, (p, (r, pi)) in enumerate(zip(DB_POSES, DB_TILTS))]
    loc.add_keyframes(np.stack([s[0] for s in scans]),
                      np.stack([s[1] for s in scans]))
    return loc


def _pose6(p, tilt, h):
    q = quat_from_rpy(torch.tensor(tilt[0]), torch.tensor(tilt[1]),
                      torch.tensor(float(p[2])))
    return Rigid3(q, torch.tensor([p[0], p[1], h], dtype=torch.float32))


def test_ground_transforms_stored(localizer):
    assert len(localizer.keyframes) == len(DB_POSES)
    for kf in localizer.keyframes:
        assert kf.ground is not None
        assert isinstance(kf.ground.rotation, np.ndarray)
        # lidar height ~1.7 recovered in the z translation
        assert abs(float(kf.ground.translation[2]) - 1.7) < 0.15


@pytest.mark.parametrize("db,offset,q_tilt,height,seed", [
    (1, (2.5, -1.5, 0.3), (0.03, -0.02), 1.65, 99),
    (0, (-2.0, 1.0, -0.4), (-0.04, 0.01), 1.85, 300),
    (2, (1.0, 2.5, 0.2), (0.02, 0.045), 1.6, 301),
    (3, (-1.5, -2.0, -0.1), (-0.01, -0.03), 1.75, 302),
])
def test_locate_composes_full_6dof(localizer, db, offset, q_tilt, height,
                                   seed):
    x, y, yaw = DB_POSES[db]
    q_pose = (x + offset[0], y + offset[1], yaw + offset[2])
    pts, mask = tilted_scan(*q_pose, roll=q_tilt[0], pitch=q_tilt[1],
                            height=height, seed=seed)
    res = localizer.locate(pts, mask)
    assert res.success
    gt = _pose6(DB_POSES[res.db_index], DB_TILTS[res.db_index], 1.7
                ).inverse().compose(_pose6(q_pose, q_tilt, height))
    err_pos, err_rot = registration_errors(res.pose, gt)
    assert float(err_pos) < 1.0, f"pos err {float(err_pos)}"
    assert float(err_rot) < 5.0, f"rot err {float(err_rot)}"
    assert abs(float(res.pose.translation[2]) - float(gt.translation[2])) < 0.3


def test_mixed_mode_map_does_not_crash(localizer):
    """A db keyframe without a ground frame (ingested unaligned) composes
    through the non-aligned branch instead of failing."""
    i = 1
    x, y, yaw = DB_POSES[i]
    pts, mask = tilted_scan(x + 2.0, y - 1.0, yaw + 0.2, roll=0.02,
                            pitch=-0.01, seed=123)
    saved = localizer.keyframes[i]
    try:
        localizer.keyframes[i] = Keyframe(saved.image, saved.origin_xy, None)
        res = localizer.locate(pts, mask)
        assert res.success and res.pose is not None
        assert res.db_index == i
        # identity db ground: x/y/yaw straight from the 2-D match, z = 0
        flat = compose_6dof(torch.from_numpy(res.match_xy_yaw))
        np.testing.assert_array_equal(res.pose.rotation,
                                      flat.rotation.numpy())
        assert res.pose.translation[2] == 0.0
        assert abs(float(res.pose.translation[0]) - 2.0) < 1.0
    finally:
        localizer.keyframes[i] = saved


def _tilted_plane_scan(n):
    """A scan with a dense tilted ground plane, so the estimate is stable
    (the scene of tests/test_pipeline_hoststats.py)."""
    rng = np.random.RandomState(0)
    n_g = n // 2
    gx = rng.uniform(-15, 15, n_g)
    gy = rng.uniform(-15, 15, n_g)
    walls, wmask = scan_at(3, -5, 0.7, n=n)
    pts = walls.copy()
    pts[:n_g, 0], pts[:n_g, 1] = gx, gy
    pts[:n_g, 2] = 0.06 * gx - 0.04 * gy - 1.5
    mask = np.maximum(wmask, np.concatenate(
        [np.ones(n_g, np.float32), np.zeros(n - n_g, np.float32)]))
    return pts, mask


def test_host_stats_aligned_extract_matches_all_device():
    """host_stats=True with align_ground: the device aligns, the host bins
    the aligned floats; the same seed draws the same numbers, so the ground
    transform and the BEV are those of the all-device path."""
    pts, mask = _tilted_plane_scan(CFG.voxel.max_points)
    model = _model()
    dev = GlobalLocalizer(CFG, model, host_stats=False, align_ground=True,
                          seed=7, device="cpu")
    host = GlobalLocalizer(CFG, model, host_stats=True, align_ground=True,
                           seed=7, device="cpu")
    d0, bev0, g0 = dev.extract(pts[None], mask[None])
    d1, bev1, g1 = host.extract(pts[None], mask[None])
    assert bool(g0.valid[0]) and bool(g1.valid[0])
    np.testing.assert_array_equal(g0.transform.rotation.numpy(),
                                  g1.transform.rotation.numpy())
    np.testing.assert_array_equal(g0.transform.translation.numpy(),
                                  g1.transform.translation.numpy())
    np.testing.assert_array_equal(bev0.image.numpy(), bev1.image)
    np.testing.assert_array_equal(bev0.origin_xy.numpy(), bev1.origin_xy)
    np.testing.assert_allclose(d0.numpy(), d1.numpy(), **DESC_TOL)
    # the estimate levels the tilted plane: its normal maps to +z
    assert abs(float(g0.plane[0, 2])) > 0.99


@pytest.mark.parametrize("host_stats,align", [(False, False), (True, True)])
def test_three_column_scans_get_zero_intensity(host_stats, align):
    pts, mask = _tilted_plane_scan(CFG.voxel.max_points)
    pts[:, 3] = 0.0
    out = []
    for cols in (3, 4):
        loc = GlobalLocalizer(CFG, _model(), host_stats=host_stats,
                              align_ground=align, seed=3, device="cpu")
        out.append(loc.extract(pts[None, :, :cols], mask[None]))
    np.testing.assert_array_equal(out[0][0].numpy(), out[1][0].numpy())
    np.testing.assert_array_equal(np.asarray(out[0][1].image),
                                  np.asarray(out[1][1].image))
