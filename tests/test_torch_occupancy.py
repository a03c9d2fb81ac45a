"""ops/occupancy.py: the port against the JAX functions on the same
numpy-seeded inputs, the cases of tests/test_occupancy.py at their sizes
(the matcher's case is in tests/test_torch_scan_match.py), plus the
general projection path, the empty grid, ``grid_to_points``, the functional
state and the state carried across by ``convert.grid_state_to_port``.

Tolerance: none. Insert, ``apply_odds`` and ``max_pyramid`` are integer
sorts, one fp32 add per cell, a clamp and maxima, so log-odds and ``known``
are bit-equal to JAX's; the projections threshold sums of the discrete
probabilities an insert leaves, so images and origins are bit-equal too.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gloc3d_tpu.config import BEVConfig as JaxBEVConfig
from gloc3d_tpu.core import transforms as jt
from gloc3d_tpu.ops import occupancy as jo
from gloc3d_tpu.ops.scan_match import max_pyramid as jax_max_pyramid
from gloc3d_tpu_torch.config import BEVConfig
from gloc3d_tpu_torch.convert import grid_state_to_numpy, grid_state_to_port
from gloc3d_tpu_torch.ops import occupancy as to
from gloc3d_tpu_torch.ops.bev import scan_to_bev
from gloc3d_tpu_torch.ops.scan_match import max_pyramid
from test_torch_threads import _two_threads  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


def _grids():
    """tests/test_occupancy.py's grid, in both packages."""
    return (jo.OccupancyGrid3D.create(resolution=0.2, extent_xy=10.0,
                                      z_min=-2.0, z_max=4.0),
            to.OccupancyGrid3D.create(resolution=0.2, extent_xy=10.0,
                                      z_min=-2.0, z_max=4.0, device="cpu"))


@functools.lru_cache(maxsize=None)
def _jax_insert(resolution, half, kw):
    """JAX's ``insert_range_data`` jitted over the grid's arrays, its
    metadata static (as tests/test_occupancy.py jits it)."""
    def insert(lo, kn, pts, mask, origin):
        out = jo.insert_range_data(jo.OccupancyGrid3D(lo, kn, resolution,
                                                      half),
                                   pts, mask, origin, **dict(kw))
        return out.log_odds, out.known
    return jax.jit(insert)


def _insert_both(jg, tg, pts, mask, origin=None, **kw):
    pts, mask = np.asarray(pts, np.float32), np.asarray(mask, np.float32)
    jorg = None if origin is None else jnp.asarray(origin, jnp.float32)
    torg = None if origin is None else _t(np.asarray(origin, np.float32))
    lo, kn = _jax_insert(jg.resolution, jg.half, tuple(sorted(kw.items())))(
        jg.log_odds, jg.known, jnp.asarray(pts), jnp.asarray(mask), jorg)
    return (jg._replace(log_odds=lo, known=kn),
            to.insert_range_data(tg, _t(pts), _t(mask), torg, **kw))


@functools.lru_cache(maxsize=None)
def _jax_project_fn(resolution, half, cfg, aligned):
    def project(lo, kn, q):
        return jo.project_to_bev(jo.OccupancyGrid3D(lo, kn, resolution, half),
                                 cfg, align_rotation=q if aligned else None)
    return jax.jit(project)


def _jax_project(jg, cfg, q=None):
    """JAX's ``project_to_bev`` jitted over the grid's arrays."""
    return _jax_project_fn(jg.resolution, jg.half, cfg, q is not None)(
        jg.log_odds, jg.known, None if q is None else jnp.asarray(q))


def _assert_grid_equal(tg, jg):
    np.testing.assert_array_equal(tg.log_odds.numpy(),
                                  np.asarray(jg.log_odds))
    np.testing.assert_array_equal(tg.known.numpy(), np.asarray(jg.known))
    assert tg.half == tuple(int(h) for h in jg.half)
    assert tg.resolution == jg.resolution


def test_single_hit_probability():
    jg, tg = _insert_both(*_grids(), [[1.0, 1.0, 0.5]], [1.0])
    _assert_grid_equal(tg, jg)
    p = tg.probabilities()
    assert abs(float(p.max()) - 0.55) < 1e-5
    assert int((p > 0).sum()) >= 1


def test_update_marker_dedupe_within_sweep():
    jg, tg = _insert_both(*_grids(), np.tile([[2.0, 0.0, 0.0]], (50, 1)),
                          np.ones(50))
    _assert_grid_equal(tg, jg)
    assert abs(float(tg.probabilities().max()) - 0.55) < 1e-5


def test_accumulation_across_sweeps_and_clamp():
    jg, tg = _grids()
    for _ in range(3):
        jg, tg = _insert_both(jg, tg, [[1.0, 0.0, 0.0]], [1.0])
    _assert_grid_equal(tg, jg)
    expect = 1 / (1 + math.exp(-3 * to.logit(0.55)))
    assert abs(float(tg.probabilities().max()) - expect) < 1e-4
    for _ in range(40):
        jg, tg = _insert_both(jg, tg, [[1.0, 0.0, 0.0]], [1.0])
    _assert_grid_equal(tg, jg)
    assert abs(float(tg.probabilities().max()) - 0.9) < 1e-5


def test_miss_carves_free_space_with_hit_priority():
    jg, tg = _insert_both(*_grids(), [[4.0, 0.0, 0.0]], [1.0])
    _assert_grid_equal(tg, jg)
    p = tg.probabilities().numpy()
    hx, hy, hz = tg.half
    assert abs(p[hx + 20, hy, hz] - 0.55) < 1e-5
    assert abs(p[hx + 19, hy, hz] - 0.49) < 1e-5
    assert abs(p[hx + 18, hy, hz] - 0.49) < 1e-5
    assert p[hx + 17, hy, hz] == 0.0
    jg2, tg2 = _insert_both(*_grids(), [[4.0, 0.0, 0.0], [3.8, 0.0, 0.0]],
                            [1.0, 1.0])
    _assert_grid_equal(tg2, jg2)
    assert abs(tg2.probabilities().numpy()[hx + 19, hy, hz] - 0.55) < 1e-5


def _sweep_300():
    """tests/test_occupancy.py's projection sweep: 300 real points in a
    512 pad."""
    rng = np.random.RandomState(0)
    pts = np.zeros((512, 3), np.float32)
    pts[:300, 0] = rng.uniform(-6, 6, 300)
    pts[:300, 1] = rng.uniform(-6, 6, 300)
    pts[:300, 2] = rng.uniform(0, 2, 300)
    mask = np.zeros(512, np.float32)
    mask[:300] = 1.0
    return pts, mask


def test_projection_matches_fused_bev_kernel():
    """One sweep through the grid: JAX's projection and the port's fused
    single-scan ``scan_to_bev``, bit for bit."""
    kw = dict(image_size=64, max_points=512, max_range=9.0)
    pts, mask = _sweep_300()
    jg, tg = _insert_both(*_grids(), pts, mask, max_range=9.0)
    _assert_grid_equal(tg, jg)
    img, origin = to.project_to_bev(tg, BEVConfig(**kw))
    jimg, jorigin = _jax_project(jg, JaxBEVConfig(**kw))
    fused = scan_to_bev(_t(pts), _t(mask), BEVConfig(**kw))
    assert int((img < 0.5).sum()) > 0
    np.testing.assert_array_equal(img.numpy(), np.asarray(jimg))
    np.testing.assert_array_equal(origin.numpy(), np.asarray(jorigin))
    np.testing.assert_array_equal(img.numpy(), fused.image.numpy())
    np.testing.assert_array_equal(origin.numpy(), fused.origin_xy.numpy())


@pytest.mark.parametrize("aligned", [False, True],
                         ids=["identity", "aligned"])
def test_projection_of_multi_sweep_and_empty_grid(aligned):
    """Both projection paths (the z-reduction and shifted crop, and the
    rotated-centre scatter) on four sweeps from moving origins, a crop
    smaller than the occupied extent, and the empty grid."""
    pts, mask = _sweep_300()
    jg0, tg0 = _grids()
    jg, tg = jg0, tg0
    for i in range(4):
        moved = pts + np.float32([0.37 * i, -0.21 * i, 0.05 * i])
        jg, tg = _insert_both(jg, tg, moved, mask,
                              origin=[0.3 * i, -0.2 * i, 0.1])
    _assert_grid_equal(tg, jg)
    q = None
    if aligned:
        q = np.asarray(jt.quat_from_rpy(jnp.float32(0.05), jnp.float32(-0.03),
                                        jnp.float32(0.7)))
    for size in (64, 40):
        cfg = dict(image_size=size, max_range=9.0)
        for a, b in ((tg, jg), (tg0, jg0)):
            img, origin = to.project_to_bev(
                a, BEVConfig(**cfg), None if q is None else _t(q))
            jimg, jorigin = _jax_project(b, JaxBEVConfig(**cfg), q)
            np.testing.assert_array_equal(img.numpy(), np.asarray(jimg))
            np.testing.assert_array_equal(origin.numpy(),
                                          np.asarray(jorigin))
    assert int((img < 0.5).sum()) == 0  # the empty grid projects nothing


def test_probability_grid_2d_updates():
    rows = np.array([3, 3, 5], np.int32)
    cols = np.array([4, 4, 6], np.int32)
    g = to.ProbabilityGrid2D.create(32, 0.1, device="cpu").apply_odds(
        _t(rows), _t(cols), torch.ones(3, dtype=torch.bool), 0.55)
    jg = jo.ProbabilityGrid2D.create(32, 0.1)

    @functools.partial(jax.jit, static_argnums=(5,))
    def jax_apply(lo, kn, r, c, v, p_update):
        return jg._replace(log_odds=lo, known=kn).apply_odds(
            r, c, v, p_update)[:2]

    jg = jg._replace(**dict(zip(("log_odds", "known"), jax_apply(
        jg.log_odds, jg.known, jnp.asarray(rows), jnp.asarray(cols),
        jnp.ones(3, bool), 0.55))))
    p = g.probabilities().numpy()
    assert abs(p[3, 4] - 0.55) < 1e-5
    assert abs(p[5, 6] - 0.55) < 1e-5
    assert p[0, 0] == 0.0
    # random updates with out-of-grid and masked lanes, two calls
    rng = np.random.RandomState(3)
    r = rng.randint(-3, 35, 400).astype(np.int32)
    c = rng.randint(-3, 35, 400).astype(np.int32)
    v = rng.rand(400) > 0.2
    for p_update, (a, b) in ((0.55, (r, c)), (0.3, (c, r)), (0.7, (r, r))):
        g = g.apply_odds(_t(a), _t(b), _t(v), p_update)
        jg = jg._replace(**dict(zip(("log_odds", "known"), jax_apply(
            jg.log_odds, jg.known, jnp.asarray(a), jnp.asarray(b),
            jnp.asarray(v), p_update))))
        np.testing.assert_array_equal(g.log_odds.numpy(),
                                      np.asarray(jg.log_odds))
        np.testing.assert_array_equal(g.known.numpy(), np.asarray(jg.known))


def test_max_pyramid():
    probs = np.zeros((16, 16), np.float32)
    probs[5, 5] = 0.9
    levels = max_pyramid(_t(probs), (1, 2, 4))
    assert abs(float(levels[1][4, 4]) - 0.9) < 1e-6
    assert abs(float(levels[2][2, 2]) - 0.9) < 1e-6
    assert float(levels[2][6, 6]) == 0.0
    rng = np.random.RandomState(5)
    for grid in (probs, rng.rand(37, 37).astype(np.float32)):
        depths = (1, 2, 4, 8, 16)
        for got, want in zip(max_pyramid(_t(grid), depths),
                             jax_max_pyramid(jnp.asarray(grid), depths)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_submap3d_dual_resolution():
    rng = np.random.RandomState(0)
    pts = rng.uniform(-8, 8, (512, 3)).astype(np.float32)
    mask = np.ones(512, np.float32)
    kw = dict(resolution=0.2, low_resolution=0.5, z_min=-10.0, z_max=10.0)
    cfg, jcfg = BEVConfig(**kw), JaxBEVConfig(**kw)
    sm = to.Submap3D.create(cfg, extent_xy=10.0, device="cpu")
    jsm = jo.Submap3D.create(jcfg, extent_xy=10.0)
    assert sm.high.resolution == 0.2 and sm.low.resolution == 0.5

    def jax_insert(hlo, hkn, llo, lkn, p, m):  # Submap3D.insert, jitted
        out = jo.Submap3D(jsm.high._replace(log_odds=hlo, known=hkn),
                          jsm.low._replace(log_odds=llo, known=lkn), 0
                          ).insert(p, m, cfg=jcfg)
        return (out.high.log_odds, out.high.known, out.low.log_odds,
                out.low.known)

    jax_insert = jax.jit(jax_insert)
    for p in (pts, pts + np.float32(0.1)):
        sm = sm.insert(_t(p), _t(mask), cfg=cfg)
        hlo, hkn, llo, lkn = jax_insert(
            jsm.high.log_odds, jsm.high.known, jsm.low.log_odds,
            jsm.low.known, jnp.asarray(p), jnp.asarray(mask))
        jsm = jo.Submap3D(jsm.high._replace(log_odds=hlo, known=hkn),
                          jsm.low._replace(log_odds=llo, known=lkn),
                          jsm.num_range_data + 1)
    assert sm.num_range_data == jsm.num_range_data == 2
    _assert_grid_equal(sm.high, jsm.high)
    _assert_grid_equal(sm.low, jsm.low)
    assert bool(sm.low.known.any())
    for low in (False, True):
        img, origin = sm.project(cfg.replace(image_size=128),
                                 use_low_resolution=low)
        # Submap3D.project is project_to_bev at cfg.occupied_threshold,
        # the function's default
        jimg, jorigin = _jax_project(jsm.low if low else jsm.high,
                                     jcfg.replace(image_size=128))
        np.testing.assert_array_equal(img.numpy(), np.asarray(jimg))
        np.testing.assert_array_equal(origin.numpy(), np.asarray(jorigin))
        assert float((img < 0.5).sum()) > 0


def test_insert_matches_jax_randomized():
    """tests/test_occupancy.py's randomized cloud (duplicates, masked and
    out-of-grid points) and two more sweeps from moved origins: every
    sweep bit-equal to JAX's, which that test holds to a brute-force numpy
    model of the reference."""
    rng = np.random.RandomState(7)
    n = 4096
    pts = rng.uniform(-11, 11, (n, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-2.5, 4.5, n)
    pts[n // 2:] = pts[: n // 2] + rng.choice(
        [0.0, 0.01], (n - n // 2, 3)).astype(np.float32)
    mask = (rng.uniform(size=n) > 0.1).astype(np.float32)
    jg, tg = _grids()
    for i in range(3):
        jg, tg = _insert_both(jg, tg, pts + np.float32(0.23 * i), mask,
                              origin=[0.4 * i, -0.3 * i, 0.2 * i])
        _assert_grid_equal(tg, jg)


def test_insert_is_functional():
    """``insert`` returns a new grid; the grid passed in is unchanged and
    can be inserted into again (tools/bench_submap.py reuses its empty
    submap)."""
    kw = dict(resolution=0.2, low_resolution=0.5, z_min=-2.0, z_max=4.0)
    sm0 = to.Submap3D.create(BEVConfig(**kw), extent_xy=10.0, device="cpu")
    pts, mask = _sweep_300()
    a = sm0.insert(_t(pts), _t(mask), cfg=BEVConfig(**kw))
    assert not bool(sm0.high.known.any()) and not bool(sm0.low.known.any())
    assert float(sm0.high.log_odds.abs().sum()) == 0.0
    b = sm0.insert(_t(pts), _t(mask), cfg=BEVConfig(**kw))
    assert torch.equal(a.high.log_odds, b.high.log_odds)
    assert torch.equal(a.low.known, b.low.known)


def test_grid_to_points():
    rng = np.random.RandomState(2)
    probs = rng.rand(20, 24).astype(np.float32)
    origin = np.float32([1.5, -2.0])
    for max_points in (None, 100):
        pts, m = to.grid_to_points(_t(probs), _t(origin), 0.25,
                                   max_points=max_points)
        jpts, jm = jax.jit(jo.grid_to_points, static_argnums=(2, 3, 4))(
            jnp.asarray(probs), jnp.asarray(origin), 0.25, 0.501, max_points)
        np.testing.assert_array_equal(pts.numpy(), np.asarray(jpts))
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))


def test_factories_run_on_the_card_unless_told(monkeypatch):
    """No device given means the card; without one the factories raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        to.OccupancyGrid3D.create(0.2, 10.0, -2.0, 4.0)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        to.ProbabilityGrid2D.create(32, 0.1)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        to.Submap3D.create(BEVConfig())
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        grid_state_to_port(grid_state_to_numpy(_grids()[1]))


@pytest.mark.parametrize("kind", ["grid3d", "grid2d", "submap"])
def test_grid_state_round_trip(kind):
    """A JAX state → the port (bit for bit) → numpy → a JAX state equal to
    the first; the port then updates it as JAX updates its own."""
    pts, mask = _sweep_300()
    if kind == "grid2d":
        jstate = jo.ProbabilityGrid2D.create(
            32, 0.1, origin_xy=(0.5, -1.5)).apply_odds(
                jnp.arange(32), jnp.arange(32)[::-1], jnp.ones(32, bool), 0.7)
    else:  # a submap's grids after one insert with Submap3D's defaults
        kw = dict(resolution=0.2, low_resolution=0.5, z_min=-2.0, z_max=4.0)
        j0 = jo.Submap3D.create(JaxBEVConfig(**kw), extent_xy=10.0)
        t0 = to.Submap3D.create(BEVConfig(**kw), extent_xy=10.0, device="cpu")
        (high, _), (low, _) = (_insert_both(j0.high, t0.high, pts, mask),
                               _insert_both(j0.low, t0.low, pts, mask))
        jstate = high if kind == "grid3d" else jo.Submap3D(high, low, 1)
    port = grid_state_to_port(jstate, device="cpu")
    back = grid_state_to_numpy(port)
    if kind == "submap":
        assert port.num_range_data == back["num_range_data"] == 1
        pairs = [(port.high, jstate.high, back["high"]),
                 (port.low, jstate.low, back["low"])]
        p2 = pts + np.float32(0.3)
        nxt = port.insert(_t(p2), _t(mask))
        for got, b in ((nxt.high, back["high"]), (nxt.low, back["low"])):
            rebuilt = jo.OccupancyGrid3D(jnp.asarray(b["log_odds"]),
                                         jnp.asarray(b["known"]),
                                         b["resolution"], b["half"])
            _assert_grid_equal(got, _insert_both(rebuilt, got, p2, mask)[0])
    else:
        pairs = [(port, jstate, back)]
    for p, j, b in pairs:
        np.testing.assert_array_equal(p.log_odds.numpy(),
                                      np.asarray(j.log_odds))
        np.testing.assert_array_equal(p.known.numpy(), np.asarray(j.known))
        np.testing.assert_array_equal(b["log_odds"], np.asarray(j.log_odds))
        np.testing.assert_array_equal(b["known"], np.asarray(j.known))
        assert b["resolution"] == j.resolution
        if kind == "grid2d":
            np.testing.assert_array_equal(b["origin_xy"],
                                          np.asarray(j.origin_xy))
            assert p.origin_xy.dtype == torch.float32
        else:
            assert tuple(b["half"]) == tuple(j.half)
