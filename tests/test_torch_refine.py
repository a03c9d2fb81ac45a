"""ops/refine.py: the port against the JAX functions on the same numpy-seeded
inputs, the cases of tests/test_refine.py plus the degenerate Kabsch steps
and the virtual-cloud permutation.

Tolerances. ICP: the two sides build the same fp32 distance matrices in a
different summation order, and the nearest-neighbour argmin and the 3×3 SVD
amplify that to a few 1e-5; translations and quaternions are held to 1e-4
(5e-4 in the planar case, whose SVD has a zero singular value), inlier
counts exactly. NDT: counts and validity exactly (sums of 1.0); means to
1e-5; inverse covariances to 1e-4 of their scale (the adjugate divides by
a small determinant); scores to 1e-5. The NDT refinement walks 40
normalised gradient steps, so its pose is held to 1e-3. The virtual clouds
with JAX's own permutation are equal; the matcher's (dx, dy, yaw) after the
sweep to 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gloc3d_tpu.config import BEVConfig, MatchConfig
from gloc3d_tpu.core import transforms as jt
from gloc3d_tpu.ops import refine as jr
from gloc3d_tpu.ops.bev import scan_to_bev as jax_scan_to_bev
from gloc3d_tpu_torch.core import transforms as tt
from gloc3d_tpu_torch.ops import refine as tr
from test_refine import _cloud
from test_torch_threads import _two_threads  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def _jax_perm(s):
    """JAX's virtual-cloud permutation, injected into the port."""
    return torch.from_numpy(np.asarray(
        jax.random.permutation(jax.random.PRNGKey(0), s * s)).astype(
            np.int64))


# ------------------------------------------------------------ 3-D ICP
def _icp_case(case):
    """(src, dst, init, iterations, gate) of tests/test_refine.py's ICP
    case, or a degenerate variant of it."""
    src = _cloud(0)
    true = jt.Rigid3(jt.quat_from_rpy(jnp.float32(0.02), jnp.float32(-0.03),
                                      jnp.float32(0.3)),
                     jnp.array([0.8, -0.5, 0.1]))
    if case == "planar":  # every point at z = 0: cov has rank 2
        src = src.copy()
        src[:, 2] = 0.0
    dst = np.asarray(jt.transform_points(true, jnp.asarray(src)))
    if case == "no_correspondence":  # every pair beyond the gate
        dst = dst + np.array([100.0, 0.0, 0.0], np.float32)
    init_q = np.asarray(jt.quat_from_rpy(jnp.float32(0.0), jnp.float32(0.0),
                                         jnp.float32(0.25)))
    init_t = np.array([0.6, -0.3, 0.0], np.float32)
    return src, dst, true, (init_q, init_t)


@pytest.mark.parametrize("case,atol", [("perturbed", 1e-4),
                                       ("no_correspondence", 1e-6),
                                       ("planar", 5e-4)])
def test_icp_point_to_point_matches_jax(case, atol):
    src, dst, true, (init_q, init_t) = _icp_case(case)
    mask = np.ones(len(src), np.float32)
    mask[::7] = 0.0  # masked rows take no part on either side
    want = jr.icp_point_to_point(
        jnp.asarray(src), jnp.asarray(mask), jnp.asarray(dst),
        jnp.asarray(mask), jt.Rigid3(jnp.asarray(init_q),
                                     jnp.asarray(init_t)),
        iterations=25, max_corr_dist=1.5)
    got = tr.icp_point_to_point(
        _t(src), _t(mask), _t(dst), _t(mask),
        tt.Rigid3(_t(init_q), _t(init_t)), iterations=25, max_corr_dist=1.5)
    _close(got.transform.rotation, want.transform.rotation, atol)
    _close(got.transform.translation, want.transform.translation, atol)
    assert int(got.num_inliers) == int(want.num_inliers)
    assert abs(float(got.rmse) - float(want.rmse)) < 1e-3
    if case == "no_correspondence":  # the pose stays where it started
        assert int(got.num_inliers) == 0
        _close(got.transform.translation, init_t, 1e-6)
    else:  # tests/test_refine.py's own gate
        err = np.linalg.norm(got.transform.translation.numpy()
                             - np.asarray(true.translation))
        assert err < 0.05 and float(got.rmse) < 0.05


# ------------------------------------------------------------ 2-D NDT
def test_ndt_grid_and_score_match_jax():
    pts = _cloud(1)[:, :2]
    mask = np.ones(len(pts), np.float32)
    want = jr.build_ndt_grid(jnp.asarray(pts), jnp.asarray(mask), size=64,
                             cell_size=0.5, origin_xy=(-16.0, -16.0))
    got = tr.build_ndt_grid(_t(pts), _t(mask), size=64, cell_size=0.5,
                            origin_xy=(-16.0, -16.0))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    valid = np.asarray(want.valid)
    _close(got.mean.numpy()[valid], np.asarray(want.mean)[valid], 1e-5)
    ic_want = np.asarray(want.inv_cov)[valid]
    _close(got.inv_cov.numpy()[valid] / np.abs(ic_want).max(),
           ic_want / np.abs(ic_want).max(), 1e-4)
    for pose in ([0.0, 0.0, 0.0], [1.5, 1.0, 0.2], [0.3, -0.2, -0.05]):
        s_t = float(tr.ndt_score(got, _t(pts), _t(mask), _t(pose)))
        s_j = float(jr.ndt_score(want, jnp.asarray(pts), jnp.asarray(mask),
                                 jnp.asarray(pose, jnp.float32)))
        assert abs(s_t - s_j) < 1e-5, (pose, s_t, s_j)
    s_true = float(tr.ndt_score(got, _t(pts), _t(mask), _t([0, 0, 0])))
    s_off = float(tr.ndt_score(got, _t(pts), _t(mask), _t([1.5, 1.0, 0.2])))
    assert s_true > 0.5 and s_true > 2.0 * s_off


# ------------------------------------------------------------ ergodic sweep
def test_ergodic_sweep_matches_jax():
    """tests/test_refine.py's sweep scene, a scan tilted by (2°, -1°)
    against its untilted BEV, on a ±2° grid in 2° steps (9 BEVs; JAX's
    test takes 49 at ±3°, 1°); the port picks the same tilt and the same
    match."""
    bev_cfg = BEVConfig(image_size=128, max_points=1024)
    match_cfg = MatchConfig(image_size=128, min_score=0.1,
                            min_overlap_pixels=16, num_rotations=60)
    cloud = _cloud(2)[:1024]
    padded = np.zeros((1024, 3), np.float32)
    padded[: len(cloud)] = cloud
    mask = np.zeros(1024, np.float32)
    mask[: len(cloud)] = 1.0
    db = jax_scan_to_bev(jnp.asarray(padded), jnp.asarray(mask), bev_cfg)
    q_tilt = jt.quat_from_rpy(jnp.deg2rad(jnp.float32(2.0)),
                              jnp.deg2rad(jnp.float32(-1.0)),
                              jnp.float32(0.0))
    tilted = np.asarray(jt.quat_rotate(jt.quat_conj(q_tilt)[None],
                                       jnp.asarray(padded)))
    want, rp_want = jr.ergodic_rp_sweep_match(
        jnp.asarray(tilted), jnp.asarray(mask), db.image, db.origin_xy,
        bev_cfg, match_cfg, half_deg=2.0, step_deg=2.0)
    got, rp_got = tr.ergodic_rp_sweep_match(
        _t(tilted), _t(mask), _t(db.image), _t(db.origin_xy), bev_cfg,
        match_cfg, half_deg=2.0, step_deg=2.0)
    assert bool(got.success) and bool(want.success)
    _close(rp_got, rp_want, 1e-7)
    _close(got.xy_yaw, want.xy_yaw, 1e-4)
    assert abs(float(got.score) - float(want.score)) < 1e-4
    assert np.abs(got.xy_yaw[:2].numpy()).max() < 0.6


# ------------------------------------------------------------ planar ICP
def test_icp_planar_matches_jax():
    src = _cloud(3)[:, :2]
    mask = np.ones(len(src), np.float32)
    th, tx, ty = 0.12, 0.7, -0.4
    c, s = np.cos(th), np.sin(th)
    dst = (src @ np.array([[c, s], [-s, c]], np.float32)
           + np.array([tx, ty], np.float32)).astype(np.float32)
    init = np.array([0.5, -0.2, 0.05], np.float32)
    for trim in (1.0, 0.7):
        want = jr.icp_planar(jnp.asarray(src), jnp.asarray(mask),
                             jnp.asarray(dst), jnp.asarray(mask),
                             jnp.asarray(init), iterations=15,
                             trim_fraction=trim)
        got = tr.icp_planar(_t(src), _t(mask), _t(dst), _t(mask), _t(init),
                            iterations=15, trim_fraction=trim)
        _close(got.xy_yaw, want.xy_yaw, 1e-4)
        assert int(got.num_inliers) == int(want.num_inliers)
        assert abs(float(got.rmse) - float(want.rmse)) < 1e-4
    got = tr.icp_planar(_t(src), _t(mask), _t(dst), _t(mask), _t(init),
                        iterations=15, trim_fraction=1.0).xy_yaw.numpy()
    assert abs(got[2] - th) < 5e-3
    np.testing.assert_allclose(got[:2], [tx, ty], atol=0.02)


def _bev_pair():
    """tests/test_refine.py's refine_match_icp scene: a db view and a query
    view offset by a transform that is not a grid multiple."""
    cfg = BEVConfig(image_size=128, max_points=4096)
    cloud = _cloud(4, n=1600)
    pad = np.zeros((4096, 3), np.float32)
    pad[: len(cloud)] = cloud
    mask = np.zeros(4096, np.float32)
    mask[: len(cloud)] = 1.0
    th, tx, ty = 0.07, 0.73, -0.31
    c, s = np.cos(-th), np.sin(-th)
    qc = cloud.copy()
    qc[:, 0] -= tx
    qc[:, 1] -= ty
    qpad = pad.copy()
    qpad[: len(cloud), 0] = c * qc[:, 0] - s * qc[:, 1]
    qpad[: len(cloud), 1] = s * qc[:, 0] + c * qc[:, 1]
    bev_db = jax_scan_to_bev(jnp.asarray(pad), jnp.asarray(mask), cfg)
    bev_q = jax_scan_to_bev(jnp.asarray(qpad), jnp.asarray(mask), cfg)
    return cfg, bev_q, bev_db, (th, tx, ty)


def test_refine_match_icp_matches_jax_with_its_permutation():
    cfg, bev_q, bev_db, (th, tx, ty) = _bev_pair()
    init = np.array([round(tx / 0.2) * 0.2, round(ty / 0.2) * 0.2, 0.06],
                    np.float32)
    want = jr.refine_match_icp(bev_q.image, bev_q.origin_xy, bev_db.image,
                               bev_db.origin_xy, jnp.asarray(init),
                               cfg.resolution, budget=2048, iterations=12,
                               max_corr_dist=0.8)
    got = tr.refine_match_icp(_t(bev_q.image), _t(bev_q.origin_xy),
                              _t(bev_db.image), _t(bev_db.origin_xy),
                              _t(init), cfg.resolution, budget=2048,
                              iterations=12, max_corr_dist=0.8,
                              perm=_jax_perm(cfg.image_size))
    _close(got.xy_yaw, want.xy_yaw, 1e-4)
    assert int(got.num_inliers) == int(want.num_inliers)
    xy = got.xy_yaw.numpy()
    err_init = np.hypot(init[0] - tx, init[1] - ty)
    assert np.hypot(xy[0] - tx, xy[1] - ty) < min(err_init, 0.1)
    assert abs(xy[2] - th) < 0.02


@pytest.mark.parametrize("budget", [256, 2048])
def test_virtual_points_match_jax_with_its_permutation(budget):
    """Over budget (256) the selection follows the permutation: equal to
    JAX's point for point when given JAX's; under budget every occupied
    pixel is in."""
    cfg, bev_q, _, _ = _bev_pair()
    want = jr.bev_to_virtual_points(bev_q.image, bev_q.origin_xy,
                                    cfg.resolution, budget)
    got = tr.bev_to_virtual_points(_t(bev_q.image), _t(bev_q.origin_xy),
                                   cfg.resolution, budget,
                                   perm=_jax_perm(cfg.image_size))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_virtual_points_under_budget_are_the_occupied_set():
    """At or under budget the valid points are every occupied pixel,
    whatever the permutation (JAX's, the port's default, reversed)."""
    cfg, bev_q, _, _ = _bev_pair()
    img = np.asarray(bev_q.image)
    n_occ = int((img < 0.5).sum())
    budget = n_occ + 100
    want = jr.bev_to_virtual_points(bev_q.image, bev_q.origin_xy,
                                    cfg.resolution, budget)
    want_set = {tuple(p) for p in np.asarray(want[0])[np.asarray(want[1])
                                                      > 0]}
    assert len(want_set) == n_occ
    s = cfg.image_size
    for perm in (_jax_perm(s), None, torch.arange(s * s - 1, -1, -1)):
        pts, valid = tr.bev_to_virtual_points(
            _t(img), _t(bev_q.origin_xy), cfg.resolution, budget, perm=perm)
        assert int(valid.sum()) == n_occ
        assert {tuple(p) for p in pts.numpy()[valid.numpy() > 0]} == \
            want_set


# ------------------------------------------------------------ 3-D NDT
def _ndt3d_grid(pts, mask):
    kw = dict(origin=(-15.0, -15.0, -2.0), dims=(60, 60, 10), cell_size=0.5)
    return (jr.build_ndt_grid_3d(jnp.asarray(pts), jnp.asarray(mask), **kw),
            tr.build_ndt_grid_3d(_t(pts), _t(mask), **kw))


def test_ndt3d_grid_and_score_match_jax():
    pts = _cloud(7)
    mask = np.ones(len(pts), np.float32)
    mask[::11] = 0.0
    want, got = _ndt3d_grid(pts, mask)
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert valid.sum() >= 10
    _close(got.mean.numpy()[valid], np.asarray(want.mean)[valid], 1e-5)
    ic_want = np.asarray(want.inv_cov)[valid]
    scale = np.abs(ic_want).max(axis=(1, 2), keepdims=True)
    _close(got.inv_cov.numpy()[valid] / scale, ic_want / scale, 1e-4)
    s0 = None
    for d in ([0, 0, 0, 0, 0, 0], [0.4, 0, 0, 0, 0, 0], [0, 0.4, 0, 0, 0, 0],
              [0, 0, 0, 0, 0, 0.06]):
        s_t = float(tr.ndt_score_3d(got, _t(pts), _t(mask), _t(d)))
        s_j = float(jr.ndt_score_3d(want, jnp.asarray(pts),
                                    jnp.asarray(mask),
                                    jnp.asarray(d, jnp.float32)))
        assert abs(s_t - s_j) < 1e-5, (d, s_t, s_j)
        if s0 is None:
            s0 = s_t
        else:  # tests/test_refine.py: the score peaks at the truth
            assert s_t < s0


def test_ndt3d_refine_matches_jax():
    src = _cloud(8)
    mask = np.ones(len(src), np.float32)
    true = jt.Rigid3(jt.quat_from_rpy(jnp.float32(0.0), jnp.float32(0.0),
                                      jnp.float32(0.08)),
                     jnp.array([0.45, -0.3, 0.05]))
    dst = np.asarray(jt.transform_points(true, jnp.asarray(src)))
    want_grid, got_grid = _ndt3d_grid(dst, mask)
    init = np.array([0.2, -0.1, 0.0, 0.0, 0.0, 0.02], np.float32)
    pose_j, score_j = jr.ndt_refine_3d(want_grid, jnp.asarray(src),
                                       jnp.asarray(mask), jnp.asarray(init),
                                       iterations=40)
    pose_t, score_t = tr.ndt_refine_3d(got_grid, _t(src), _t(mask),
                                       _t(init), iterations=40)
    _close(pose_t, pose_j, 1e-3)
    assert abs(float(score_t) - float(score_j)) < 1e-4
    s_init = float(tr.ndt_score_3d(got_grid, _t(src), _t(mask), _t(init)))
    assert float(score_t) > s_init
    got = pose_t.numpy()
    err_init = np.linalg.norm(init[:2] - np.array([0.45, -0.3]))
    assert np.linalg.norm(got[:2] - np.array([0.45, -0.3])) < err_init
    assert abs(got[5] - 0.08) < abs(0.02 - 0.08)
