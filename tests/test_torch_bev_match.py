"""FFT BEV registration: the port's match_bev_topk against the JAX matcher at
S = 128 on scan pairs of the synthetic wall world, both fed the same host
BEV images.

Tolerances: `success` equal; xy within one cell (0.2 m) and yaw within one
fine bin (0.6°), since cuFFT/pocketFFT rounding may move a near-tied peak by
one bin; score within 1e-3 (fp32 FFT correlations of integer counts). The
batched call (B queries × K candidates) is held lane by lane to
``jax.vmap(match_bev_topk)`` at the same tolerances, and to the port's own
one-query calls bit for bit."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gloc3d_tpu.config import BEVConfig, MatchConfig, PipelineConfig
from gloc3d_tpu.data.native import compute_bev_host
from gloc3d_tpu.ops import bev_match as jbm
from gloc3d_tpu.ops.bev import BEVImage as JaxBEV
from gloc3d_tpu_torch.ops import bev_match as tbm
from gloc3d_tpu_torch.ops.bev import BEVImage
from gloc3d_tpu_torch.ops.bev_match import MatchResult
from test_pipeline import scan_at
from test_torch_threads import _two_threads  # noqa: F401


S, N_PTS, RES = 128, 2048, 0.2
BCFG = BEVConfig(image_size=S, max_points=N_PTS)
MCFG = MatchConfig(image_size=S, min_score=0.1, min_overlap_pixels=16)
CELL, FINE_BIN = RES, math.radians(0.6)


def _bev(pose):
    pts, mask = scan_at(*pose, n=N_PTS)
    img, org, _ = compute_bev_host(pts[None], np.asarray([mask.sum()],
                                                        np.int64), BCFG)
    return img[0], org[0]


def _both(q_pose, db_poses, cfg):
    q_img, q_org = _bev(q_pose)
    dbs = [_bev(p) for p in db_poses]
    imgs = np.stack([d[0] for d in dbs])
    orgs = np.stack([d[1] for d in dbs])
    want = jbm.match_bev_topk(
        JaxBEV(jnp.asarray(q_img), jnp.asarray(q_org), jnp.float32(RES),
               jnp.int32(0)), jnp.asarray(imgs), jnp.asarray(orgs), cfg,
        resolution=RES)
    got = tbm.match_bev_topk(
        BEVImage(torch.from_numpy(q_img), torch.from_numpy(q_org), RES, None),
        torch.from_numpy(imgs), torch.from_numpy(orgs), cfg, resolution=RES)
    return got, want


def _assert_close(got, want):
    np.testing.assert_array_equal(got.success.numpy(),
                                  np.asarray(want.success))
    xy = got.xy_yaw.numpy()
    ref = np.asarray(want.xy_yaw)
    assert np.abs(xy[:, :2] - ref[:, :2]).max() <= CELL + 1e-4
    dyaw = np.angle(np.exp(1j * (xy[:, 2] - ref[:, 2])))
    assert np.abs(dyaw).max() <= FINE_BIN + 1e-5
    np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score),
                               atol=1e-3)
    np.testing.assert_allclose(got.overlap.numpy(), np.asarray(want.overlap),
                               rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("q_pose,db_poses", [
    ((25, 5, 1.2), [(25, 5, 1.2), (-30, -30, 0.0)]),
    ((3, -2, 0.35), [(0, 0, 0.0), (5, 0, -0.3), (30, 30, 2.9)]),
    ((-12, 8, -2.0), [(-10, 10, -1.5), (-14, 5, 3.0)]),
])
def test_match_bev_topk_matches_jax(q_pose, db_poses):
    got, want = _both(q_pose, db_poses, MCFG)
    _assert_close(got, want)


def test_identical_scan_registers_to_identity():
    got, _ = _both((25, 5, 1.2), [(25, 5, 1.2)], MCFG)
    assert bool(got.success[0])
    np.testing.assert_allclose(got.xy_yaw[0].numpy(), 0.0, atol=1e-4)


@pytest.mark.parametrize("cfg", [
    MCFG.replace(coarse_rot_downsample=8),
    MCFG.replace(fine_downsample=2, min_peak_ratio=1.01),
])
def test_matcher_options_match_jax(cfg):
    got, want = _both((3, -2, 0.35), [(0, 0, 0.0), (5, 0, -0.3)], cfg)
    _assert_close(got, want)
    if cfg.min_peak_ratio:
        np.testing.assert_allclose(got.ratio.numpy(), np.asarray(want.ratio),
                                   rtol=1e-3)


def test_match_bev_single_candidate():
    q_img, q_org = _bev((3, -2, 0.35))
    db_img, db_org = _bev((0, 0, 0.0))
    got = tbm.match_bev(
        BEVImage(torch.from_numpy(q_img), torch.from_numpy(q_org), RES, None),
        BEVImage(torch.from_numpy(db_img), torch.from_numpy(db_org), RES,
                 None), MCFG)
    want = jbm.match_bev(
        JaxBEV(jnp.asarray(q_img), jnp.asarray(q_org), jnp.float32(RES),
               jnp.int32(0)),
        JaxBEV(jnp.asarray(db_img), jnp.asarray(db_org), jnp.float32(RES),
               jnp.int32(0)), MCFG)
    assert got.xy_yaw.shape == (3,)
    assert bool(got.success) == bool(want.success)
    np.testing.assert_allclose(got.xy_yaw.numpy(), np.asarray(want.xy_yaw),
                               atol=CELL)


def test_rotation_helpers_match_jax():
    img = (np.random.RandomState(0).rand(32, 32) > 0.8).astype(np.float32)
    angles = np.asarray([0.0, 0.3, -1.2, 2.0, 3.1, -2.9], np.float32)
    want = np.asarray(jbm._rotate_image_shear(jnp.asarray(img),
                                              jnp.asarray(angles)))
    got = tbm._rotate_image_shear(torch.from_numpy(img),
                                  torch.from_numpy(angles)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    deltas = np.linspace(-0.05, 0.05, 5).astype(np.float32)
    want = np.asarray(jbm._fan_rfft2(jnp.asarray(img), jnp.asarray(deltas),
                                     48, 0.05))
    got = tbm._fan_rfft2(torch.from_numpy(img), torch.from_numpy(deltas),
                         48, 0.05).resolve_conj().numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)
    for n in (1, 97, 274, 768 + 192):
        assert tbm._good_fft_size(n) == jbm._good_fft_size(n)


FM_CFG = MCFG.replace(coarse_mode="fm")
SERVING = {
    "fm": FM_CFG,
    "two-stage fine": MCFG.replace(fine_argmax_downsample=2),
    "overlap_norm": MCFG.replace(overlap_norm=True),
    "overlap_norm, two-stage": MCFG.replace(overlap_norm=True,
                                            fine_argmax_downsample=2),
    "fast_match()": PipelineConfig(match=MCFG).fast_match().match,
    "fast_match(fm=True)": PipelineConfig(match=MCFG).fast_match(fm=True).match,
}


# six candidates, so that fast_match's fine_top_f = 4 prunes; each clears
# the fm preset's 180° check by > 1 % at the /8 pooling and has one best
# coarse angle (at S = 128 some keyframes tie there within rounding, and
# the two packages then settle the tie apart)
SERVING_DB = [(2, -1, 0.0), (8, -4, -0.5), (5, 0, -0.3), (6, -1, 0.3),
              (0, -6, -1.0), (1, -3, 0.6)]


@pytest.mark.parametrize("name", list(SERVING))
def test_serving_options_match_jax(name):
    got, want = _both((3, -2, 0.35), SERVING_DB, SERVING[name])
    _assert_close(got, want)
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


@pytest.mark.parametrize("coarse_mode", ["stack", "fm"])
def test_fine_top_f_keeps_the_earliest_of_tied_candidates(coarse_mode):
    """Five candidates, the last three the query's own keyframe (as
    locate's clamped filler candidates repeat one keyframe): their coarse
    scores tie exactly at the top, so the cut at F = 2 falls inside the
    tie, and the earlier two are registered, as jax.lax.top_k keeps the
    lower index."""
    cfg = MCFG.replace(fine_top_f=2, coarse_mode=coarse_mode)
    q_pose = (3, -2, 0.35)
    got, want = _both(q_pose, SERVING_DB[:2] + [q_pose] * 3, cfg)
    _assert_close(got, want)
    for res in (got.score.numpy(), np.asarray(want.score)):
        assert list(np.flatnonzero(res != 0)) == [2, 3]
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


def test_angular_signature_matches_jax():
    q_img, _ = _bev((3, -2, 0.35))
    occ = tbm._maxpool(tbm._occupancy(torch.from_numpy(q_img)), 4)
    want = np.asarray(jbm._angular_signature(jnp.asarray(occ.numpy()), 180))
    got = tbm._angular_signature(occ[None], 180)[0].numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    for a, b in zip(tbm._polar_weights(32, 180, 3),
                    jbm._polar_weights(32, 180, 3)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- batch
# B = 3 queries × K = 4 candidates; query 0's last two candidates are its
# own keyframe, so fine_top_f = 2 cuts inside a tie of coarse scores
BATCH = [((3, -2, 0.35), SERVING_DB[:2] + [(3, -2, 0.35)] * 2),
         ((25, 5, 1.2), [(25, 5, 1.2), (-30, -30, 0.0), (5, 0, -0.3),
                         (30, 30, 2.9)]),
         ((-12, 8, -2.0), [(-10, 10, -1.5), (-14, 5, 3.0), (2, -1, 0.0),
                           (6, -1, 0.3)])]
BATCH_CFGS = {
    "stack": MCFG,
    "fm": FM_CFG,
    "fine_top_f with ties": MCFG.replace(fine_top_f=2),
    "overlap_norm": SERVING["overlap_norm"],
    "two-stage fine": SERVING["two-stage fine"],
}


@pytest.fixture(scope="module")
def batch_inputs():
    """The batch's query images (B, S, S) and origins (B, 2), and its
    candidates (B, K, S, S) and (B, K, 2), as numpy."""
    qs = [_bev(q) for q, _ in BATCH]
    dbs = [[_bev(p) for p in db] for _, db in BATCH]
    return (np.stack([q[0] for q in qs]), np.stack([q[1] for q in qs]),
            np.stack([[d[0] for d in db] for db in dbs]),
            np.stack([[d[1] for d in db] for db in dbs]))


def _port(cfg, q_img, q_org, imgs, orgs):
    return tbm.match_bev_topk(
        BEVImage(torch.from_numpy(q_img), torch.from_numpy(q_org), RES,
                 None), torch.from_numpy(imgs), torch.from_numpy(orgs), cfg,
        resolution=RES)


@pytest.mark.parametrize("name", list(BATCH_CFGS))
def test_batched_matcher_matches_jax_vmap(batch_inputs, name):
    """One port call over (B, K) against ``jax.vmap(match_bev_topk)``, lane
    by lane at the tolerances above."""
    cfg = BATCH_CFGS[name]
    q_img, q_org, imgs, orgs = batch_inputs
    got = _port(cfg, q_img, q_org, imgs, orgs)
    want = jax.jit(jax.vmap(lambda qi, qo, di, do: jbm.match_bev_topk(
        JaxBEV(qi, qo, jnp.float32(RES), jnp.int32(0)), di, do, cfg,
        resolution=RES)))(*map(jnp.asarray, batch_inputs))
    assert got.xy_yaw.shape == (3, 4, 3) and got.success.shape == (3, 4)
    assert bool(np.asarray(want.success).any())
    for q in range(len(BATCH)):
        _assert_close(MatchResult(*(x[q] for x in got)),
                      MatchResult(*(np.asarray(x[q]) for x in want)))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    if cfg.fine_top_f:
        for res in (got.score.numpy(), np.asarray(want.score)):
            assert list(np.flatnonzero(res[0] != 0)) == [2, 3]


@pytest.mark.parametrize("name", list(BATCH_CFGS))
def test_batched_matcher_equals_one_query_calls(batch_inputs, name):
    """The batch equals B one-query calls, bit for bit."""
    cfg = BATCH_CFGS[name]
    q_img, q_org, imgs, orgs = batch_inputs
    got = _port(cfg, q_img, q_org, imgs, orgs)
    for q in range(len(BATCH)):
        one = _port(cfg, q_img[q], q_org[q], imgs[q], orgs[q])
        for g, w in zip(got, one):
            assert torch.equal(g[q], w)
