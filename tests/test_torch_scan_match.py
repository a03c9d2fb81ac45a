"""ops/scan_match.py: the port against the JAX functions on the same
numpy-seeded inputs, the cases of tests/test_scan_match_fast.py (all but the
sharded matcher) and tests/test_occupancy.py's matcher case, at their sizes.

What is held, and how closely:

- The rotation grid is bit-equal to ``jnp.linspace``'s definition evaluated
  in fp32 with numpy. JAX's own compiled grid differs from it by at most 2
  ulp of π (4.8e-7 rad, eager and jitted alike; XLA contracts the
  expression into fused multiply-adds), and that moves no scan point of
  these cases into another cell: 0 of 257 870 (R = 2410).
- Matchers are held to JAX's optimum: the score within 1e-5, and the same
  pose or, where the poses differ, a pose whose exact score (``score_at``)
  is within 1e-5 of JAX's. Probabilities from ``from_bev_image`` take two
  values, so tied shifts are common, and the FFT's round-off differs
  between XLA's and torch's CPU FFTs. JAX runs jitted, as
  ``match_full_submap`` runs it.
- ``match_scan_fast``'s best unexpanded bound equals JAX's within 1e-3
  counts, and its certificate equals JAX's wherever its margin
  |raw − bound + slack| exceeds 1e-2 counts (both packages' margins);
  inside that band round-off alone decides it.
- The chunked exhaustive search is bit-equal to the one-shot search.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gloc3d_tpu.ops import scan_match as js
from gloc3d_tpu_torch.convert import grid_state_to_port
from gloc3d_tpu_torch.ops import scan_match as ts
from gloc3d_tpu_torch.ops.occupancy import ProbabilityGrid2D
from test_scan_match_fast import (
    _carpet_grid_and_scan, _noisy_scan, _offset_scan, _random_grid_and_scan,
)

SCORE_TOL = 1e-5
CERT_MARGIN = 1e-2
BOUND_TOL = 1e-3  # counts; XLA's and torch's CPU FFTs: 3.8e-6 in these cases
from test_torch_threads import _two_threads  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


_jax_match = jax.jit(js.match_scan, static_argnames=(
    "num_rotations", "angular_halfwidth", "pad", "rotation_chunk"))
_jax_fast_core = jax.jit(js._match_fast_core, static_argnames=(
    "coarse_factor", "num_candidates"))


class _Case:
    """One grid and scan in both packages."""

    def __init__(self, jgrid, scan, mask=None):
        mask = np.ones(len(scan), np.float32) if mask is None else mask
        self.jgrid, self.scan, self.mask = jgrid, scan, mask
        self.jpts, self.jmask = jnp.asarray(scan), jnp.asarray(mask)
        self.grid = grid_state_to_port(jgrid, device="cpu")
        self.pts, self.tmask = _t(scan), _t(mask)

    def exact(self, **kw):
        return (ts.match_scan(self.grid, self.pts, self.tmask, **kw),
                _jax_match(self.jgrid, self.jpts, self.jmask, **kw))

    def fast(self, num_rotations=256, angular_center=0.0,
             angular_halfwidth=math.pi, coarse_factor=4, num_candidates=128,
             certificate_slack=0.05):
        """Both fast matchers: (port result, port certificate, JAX result,
        JAX certificate, the smaller of the two certificate margins)."""
        kw = dict(num_rotations=num_rotations, angular_center=angular_center,
                  angular_halfwidth=angular_halfwidth,
                  coarse_factor=coarse_factor, num_candidates=num_candidates)
        got, cert = ts.match_scan_fast(self.grid, self.pts, self.tmask,
                                       certificate_slack=certificate_slack,
                                       **kw)
        _, raw, bound, _ = ts._match_fast_core(
            self.grid, self.pts, self.tmask, ts.rotation_grid(
                num_rotations, angular_center, angular_halfwidth, "cpu"),
            coarse_factor, num_candidates)
        thetas = angular_center + jnp.linspace(
            -angular_halfwidth, angular_halfwidth, num_rotations,
            endpoint=False)
        jpose, jraw, jbound, jn = _jax_fast_core(
            self.jgrid, self.jpts, self.jmask, thetas,
            coarse_factor=coarse_factor, num_candidates=num_candidates)
        want = js.ScanMatchResult(jpose, jraw / jn)
        # the best unexpanded bound is the same cell's bound, or a tied
        # one's, in both packages: equal up to the two FFTs' round-off
        assert abs(float(bound) - float(jbound)) < BOUND_TOL, (
            float(bound), float(jbound))
        jcert = bool(jraw >= jbound - certificate_slack)
        margin = min(abs(float(raw - bound) + certificate_slack),
                     abs(float(jraw - jbound) + certificate_slack))
        return got, bool(cert), want, jcert, margin

    def same_optimum(self, got, want, ctx=""):
        """tests/test_scan_match_fast.py::_assert_same_optimum at 1e-5:
        the same score, and the same pose or a score-tied one."""
        assert abs(float(got.score) - float(want.score)) < SCORE_TOL, (
            ctx, float(got.score), float(want.score))
        pose = got.pose.numpy()
        if not np.allclose(pose, np.asarray(want.pose), atol=1e-5):
            refit = float(ts.score_at(self.grid, self.pts, self.tmask,
                                      got.pose))
            assert abs(refit - float(want.score)) < SCORE_TOL, (
                ctx, "pose is not score-tied with JAX's optimum", pose,
                np.asarray(want.pose), refit, float(want.score))


def _same_certificate(cert, jcert, margin):
    if margin > CERT_MARGIN:
        assert cert == jcert, (cert, jcert, margin)


@pytest.mark.parametrize("num_rotations", [7, 64, 2410])
def test_rotation_grid_follows_linspace(num_rotations):
    for hw, center in ((math.pi, 0.0), (0.3, 0.1), (0.15, -2.0)):
        got = ts.rotation_grid(num_rotations, center, hw, "cpu").numpy()
        i = np.arange(num_rotations, dtype=np.float32)
        step = i / np.float32(num_rotations)
        lin = (np.float32(-hw) * (np.float32(1) - step)
               + np.float32(hw) * step)
        np.testing.assert_array_equal(got, np.float32(center) + lin)
        for want in (center + jnp.linspace(-hw, hw, num_rotations,
                                           endpoint=False),
                     jax.jit(lambda c: c + jnp.linspace(
                         -hw, hw, num_rotations, endpoint=False))(center)):
            np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                       atol=4.8e-7)
    # JAX's cells(θ) against the port's for a scan of the randomized case
    jgrid, map_pts = _random_grid_and_scan(0)
    scan = _offset_scan(map_pts, np.array([0.3, -0.7, 1.1]))
    org, res = np.asarray(jgrid.origin_xy), jgrid.resolution
    th = jnp.linspace(-math.pi, math.pi, num_rotations, endpoint=False)
    c, s = jnp.cos(th)[:, None], jnp.sin(th)[:, None]
    x = c * scan[None, :, 0] - s * scan[None, :, 1]
    y = s * scan[None, :, 0] + c * scan[None, :, 1]
    want = np.stack([np.asarray(jnp.round((x - org[0]) / res)),
                     np.asarray(jnp.round((y - org[1]) / res))])
    col, row = ts._cells(ts.rotation_grid(num_rotations, 0.0, math.pi, "cpu"),
                         _t(scan), _t(org), res)
    differ = (np.stack([col.numpy(), row.numpy()]) != want).any(0).sum()
    assert differ == 0, f"{differ} of {col.numel()} cells differ"


@pytest.mark.parametrize("seed", range(4))
def test_fast_matches_exhaustive_randomized(seed):
    jgrid, map_pts = _random_grid_and_scan(seed)
    rng = np.random.RandomState(100 + seed)
    gt = np.array([rng.uniform(-2, 2), rng.uniform(-2, 2),
                   rng.uniform(-np.pi, np.pi)])
    case = _Case(jgrid, _offset_scan(map_pts, gt))
    exact, jexact = case.exact(num_rotations=64)
    case.same_optimum(exact, jexact, "exhaustive")
    fast, cert, jfast, jcert, margin = case.fast(num_rotations=64)
    assert cert, f"seed {seed}: certificate failed"
    _same_certificate(cert, jcert, margin)
    case.same_optimum(fast, jfast, "fast")
    case.same_optimum(fast, jexact, "fast vs exhaustive")


@pytest.mark.parametrize("t", [(-0.25, -0.25), (-0.75, -0.5)])
def test_fast_negative_edge_translation(t):
    """An optimum in coarse cell Q = -1 is not missed."""
    size, res, f = 64, 0.25, 4
    img = np.ones((size, size), np.float32)
    img[10:50:4, 12:52:5] = 0.0
    origin = np.array([-size * res / 2, -size * res / 2], np.float32)
    rr, cc = np.nonzero(img == 0.0)
    map_pts = np.stack([origin[0] + cc * res, origin[1] + rr * res], 1)
    jgrid = js.ProbabilityGrid2D.from_bev_image(
        jnp.asarray(img), jnp.asarray(origin), res)
    case = _Case(jgrid, _offset_scan(map_pts, np.array([*t, 0.0])))
    exact, jexact = case.exact(num_rotations=32)
    case.same_optimum(exact, jexact, "exhaustive")
    fast, cert, jfast, jcert, margin = case.fast(num_rotations=32,
                                                 coarse_factor=f)
    assert cert
    _same_certificate(cert, jcert, margin)
    case.same_optimum(fast, jfast, "fast")
    case.same_optimum(fast, jexact, "fast vs exhaustive")


def test_fast_narrow_window_and_masks():
    jgrid, map_pts = _random_grid_and_scan(7)
    gt = np.array([0.9, -0.6, 0.12])
    scan = _offset_scan(map_pts, gt)
    pts = np.concatenate([scan, np.full((64, 2), 1e3, np.float32)])
    m = np.concatenate([np.ones(len(scan)), np.zeros(64)]).astype(np.float32)
    case = _Case(jgrid, pts, m)
    kw = dict(num_rotations=32, angular_center=0.1, angular_halfwidth=0.3)
    exact, jexact = case.exact(**kw)
    case.same_optimum(exact, jexact, "exhaustive")
    fast, cert, jfast, jcert, margin = case.fast(**kw)
    assert cert
    _same_certificate(cert, jcert, margin)
    case.same_optimum(fast, jfast, "fast")
    case.same_optimum(fast, jexact, "fast vs exhaustive")
    assert abs(float(fast.pose[0]) - gt[0]) < 2 * jgrid.resolution


def test_certificate_slack_calibration():
    """The port's FFT correlation (torch's CPU FFT) against a float64 direct
    sum, tests/test_scan_match_fast.py's data: below 5e-3 counts, 10× under
    the certificate's 0.05."""
    rng = np.random.RandomState(3)
    size, npts = 192, 2000
    pad = size + size // 2
    probs = rng.rand(size, size).astype(np.float32)
    counts = np.zeros((pad, pad), np.float32)
    idx = rng.randint(0, size, (npts, 2))
    np.add.at(counts, (idx[:, 0], idx[:, 1]), 1.0)
    ft = torch.fft.rfft2(torch.nn.functional.pad(
        _t(probs), (0, pad - size, 0, pad - size)))
    corr = ts._fft_corr(_t(counts), ft, pad).numpy()
    errs = []
    for _ in range(32):
        dy, dx = rng.randint(-size // 2, size // 2, 2)
        rows, cols = idx[:, 0] + dy, idx[:, 1] + dx
        inb = (rows >= 0) & (rows < size) & (cols >= 0) & (cols < size)
        exact = probs[rows[inb], cols[inb]].astype(np.float64).sum()
        errs.append(abs(corr[dy % pad, dx % pad] - exact))
    assert max(errs) < 5e-3, max(errs)


def _policy_case(carpet, seed, gt, noise_seed=None):
    if carpet:
        jgrid, map_pts = _carpet_grid_and_scan(seed=seed)
        return _Case(jgrid, _noisy_scan(map_pts, gt, seed=noise_seed))
    jgrid, map_pts = _random_grid_and_scan(seed)
    return _Case(jgrid, _offset_scan(map_pts, gt))


def _submap_both(case, **kw):
    return (ts.match_full_submap(case.grid, case.pts, case.tmask, **kw),
            js.match_full_submap(case.jgrid, case.jpts, case.jmask, **kw))


def test_match_full_submap_certified_no_fallback():
    case = _policy_case(False, 2, np.array([1.0, -0.5, 0.8]))
    got, want = _submap_both(case, num_rotations=64)
    assert got.certified and not got.used_fallback
    assert (got.certified, got.used_fallback) == (want.certified,
                                                  want.used_fallback)
    case.same_optimum(got, want)


def test_match_full_submap_fallback_exact_on_carpet():
    """Where the certificate fails, 'full' returns the exhaustive optimum."""
    case = _policy_case(True, 11, np.array([0.75, -1.25, 2.1]),
                        noise_seed=5)
    got, want = _submap_both(case, num_rotations=48)
    assert got.used_fallback and not got.certified
    assert (got.certified, got.used_fallback) == (want.certified,
                                                  want.used_fallback)
    case.same_optimum(got, want)
    exact, _ = case.exact(num_rotations=48)
    np.testing.assert_array_equal(got.pose.numpy(), exact.pose.numpy())
    assert float(got.score) == float(exact.score)


def test_match_full_submap_theta_and_none_policies():
    case = _policy_case(True, 13, np.array([-0.5, 0.5, -1.3]), noise_seed=6)
    r_none, j_none = _submap_both(case, num_rotations=48, fallback="none")
    r_theta, j_theta = _submap_both(case, num_rotations=48,
                                    fallback="theta")
    assert not r_none.certified and not r_none.used_fallback
    assert r_theta.used_fallback
    for got, want in ((r_none, j_none), (r_theta, j_theta)):
        assert (got.certified, got.used_fallback) == (want.certified,
                                                      want.used_fallback)
        case.same_optimum(got, want)
    assert float(r_theta.score) >= float(r_none.score) - 1e-6
    exact, _ = case.exact(num_rotations=48)
    assert float(r_theta.score) <= float(exact.score) + SCORE_TOL
    with pytest.raises(ValueError):
        ts.match_full_submap(case.grid, case.pts, case.tmask,
                             num_rotations=48, fallback="nearest")


def test_match_full_submap_large_r_goes_exhaustive():
    """Above R = 512 the auto policy goes straight to the exhaustive
    search."""
    case = _policy_case(False, 9, np.array([0.4, 0.9, 1.7]))
    got, want = _submap_both(case, num_rotations=600)
    assert got.used_fallback and not got.certified
    assert (got.certified, got.used_fallback) == (want.certified,
                                                  want.used_fallback)
    case.same_optimum(got, want)


def test_rotation_chunked_exhaustive_identical():
    """The chunked exhaustive search returns the one-shot pose and score
    bit for bit, also where the chunk does not divide R."""
    jgrid, map_pts = _random_grid_and_scan(4)
    case = _Case(jgrid, _offset_scan(map_pts, np.array([0.6, 1.1, -2.0])))
    full, jfull = case.exact(num_rotations=50, rotation_chunk=50)
    case.same_optimum(full, jfull)
    for chunk in (7, 16, 64, None):
        ch = ts.match_scan(case.grid, case.pts, case.tmask,
                           num_rotations=50, rotation_chunk=chunk)
        np.testing.assert_array_equal(ch.pose.numpy(), full.pose.numpy())
        np.testing.assert_array_equal(ch.score.numpy(), full.score.numpy())


def test_rotation_chunk_bounds_memory():
    """The default chunk holds ~1 GiB of FFT intermediates: 113 rotations
    at the 512² grid's pad of 768, every rotation at the tests' pads."""
    assert ts.rotation_chunk_for(768) == 113
    assert ts.rotation_chunk_for(144) >= 2048


def test_olson_rotation_count_default():
    step = ts.olson_angular_step(0.2, 50.0)
    assert step == js.olson_angular_step(0.2, 50.0)
    n = int(np.ceil(2 * np.pi / step))
    assert 1500 <= n <= 1650, n


def test_match_scan_recovers_pose():
    """tests/test_occupancy.py's matcher case: a scan drawn from wall
    segments at a known offset, at the full Olson rotation count."""
    rng = np.random.RandomState(1)
    size, res = 128, 0.2
    img = np.ones((size, size), np.float32)
    for _ in range(12):
        r0, c0 = rng.randint(10, size - 30, 2)
        length = rng.randint(10, 25)
        if rng.rand() < 0.5:
            img[r0, c0:c0 + length] = 0.0
        else:
            img[r0:r0 + length, c0] = 0.0
    origin = np.array([-size * res / 2, -size * res / 2], np.float32)
    rr, cc = np.nonzero(img == 0.0)
    map_pts = np.stack([origin[0] + cc * res, origin[1] + rr * res], 1)
    gt = np.array([1.4, -0.8, 0.5])
    scan = _offset_scan(map_pts, gt)
    step = ts.olson_angular_step(res, float(np.abs(scan).max()))
    n_rot = min(int(2 * np.pi / step) + 1, 1024)
    case = _Case(js.ProbabilityGrid2D.from_bev_image(
        jnp.asarray(img), jnp.asarray(origin), res), scan)
    got, want = case.exact(num_rotations=n_rot)
    case.same_optimum(got, want)
    pose = got.pose.numpy()
    dyaw = np.arctan2(np.sin(pose[2] - gt[2]), np.cos(pose[2] - gt[2]))
    assert abs(dyaw) < 0.05, pose
    assert abs(pose[0] - gt[0]) < 2 * res and abs(pose[1] - gt[1]) < 2 * res
    assert float(got.score) > 0.7


def test_score_at_matches_jax():
    """``score_at`` at on-lattice poses, off-lattice ones (the translation
    rounds to whole cells apart from the rotated points, as in JAX) and
    poses hanging off the grid."""
    jgrid, map_pts = _random_grid_and_scan(5)
    case = _Case(jgrid, _offset_scan(map_pts, np.array([0.5, 0.25, 0.3])))
    jscore = jax.jit(js.score_at)
    rng = np.random.RandomState(8)
    poses = [np.float32([0.5, 0.25, 0.3]), np.float32([30.0, -30.0, 1.0])]
    poses += list(rng.uniform([-3, -3, -np.pi], [3, 3, np.pi],
                              (6, 3)).astype(np.float32))
    for pose in poses:
        got = float(ts.score_at(case.grid, case.pts, case.tmask, _t(pose)))
        want = float(jscore(jgrid, case.jpts, case.jmask, jnp.asarray(pose)))
        assert abs(got - want) < 1e-6, (pose, got, want)


def test_from_bev_image_probabilities():
    """A BEV image's grid: 0.9 where occupied, 0.1 where free, all known,
    origin as float32 on the image's device."""
    img = np.ones((8, 8), np.float32)
    img[2, 3] = 0.0
    g = ProbabilityGrid2D.from_bev_image(_t(img), [1.0, -2.0], 0.5)
    jg = js.ProbabilityGrid2D.from_bev_image(jnp.asarray(img),
                                             jnp.asarray([1.0, -2.0]), 0.5)
    np.testing.assert_array_equal(g.log_odds.numpy(), np.asarray(jg.log_odds))
    assert bool(g.known.all()) and g.origin_xy.dtype == torch.float32
    p = g.probabilities().numpy()
    assert abs(p[2, 3] - 0.9) < 1e-6 and abs(p[0, 0] - 0.1) < 1e-6


def test_non_square_grid_raises():
    """The matchers take square grids only, as JAX's do; the port raises
    where JAX asserts."""
    g = ProbabilityGrid2D.from_bev_image(torch.ones(8, 12), [0.0, 0.0], 0.5)
    pts, m = torch.zeros(4, 2), torch.ones(4)
    for fn in (ts.match_scan, ts.match_scan_fast):
        with pytest.raises(ValueError, match="square"):
            fn(g, pts, m, num_rotations=4)
