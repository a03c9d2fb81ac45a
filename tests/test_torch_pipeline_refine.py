"""The refinement stage through the port's entry points: keyframe clouds,
the ICP polish in ``locate`` / ``locate_batch``, ``match_keyframe`` (the
SLAM verify step) on the host mirror and on the device store, an aligned
map with JAX's ground draws replayed, and maps with clouds saved by either
package loading in the other. JAX's GlobalLocalizer and the port run the
same bridged weights on the same scans (tests/test_torch_pipeline.py's
world and sizes, 512-point ICP clouds).

Equal: keyframe clouds (unaligned), success, db_index, candidates. Within
tolerance: the polished (dx, dy, yaw), 2e-3 m / 2e-3 rad, since the
registration's own 1e-4 and the ICP's fp32 distance matrices in another
summation order (tests/test_torch_refine.py) are carried through ten
steps; poses 2e-3; aligned keyframe clouds 1e-4 m (the port moves them into
the ground frame in float64, JAX in fp32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gloc3d_tpu.models import build_model as jax_build_model
from gloc3d_tpu.pipeline import GlobalLocalizer as JaxLocalizer
from gloc3d_tpu_torch.convert import flax_to_state_dict
from gloc3d_tpu_torch.models.descriptor import build_model
from gloc3d_tpu_torch.pipeline import GlobalLocalizer
from test_pipeline import scan_at
from test_pipeline_ground import tilted_scan
from test_torch_i2i import _JaxDraws
from test_torch_pipeline import CFG, DB_POSES, N_PTS, QUERIES, _scans
from test_torch_threads import _two_threads  # noqa: F401

RCFG = CFG.replace(match=CFG.match.replace(
    refine_icp=True, refine_icp_points=512, refine_icp_iters=10,
    refine_icp_max_corr=1.0))
XY_TOL = 2e-3


@pytest.fixture(scope="module")
def weights():
    pts, mask = _scans(DB_POSES[:1])
    model = jax_build_model(CFG.model, CFG.voxel)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(pts),
                                 jnp.asarray(mask))
    port_model = build_model(CFG.model, CFG.voxel)
    port_model.load_state_dict(flax_to_state_dict(params))
    return model, params, port_model


@pytest.fixture(scope="module")
def maps(weights):
    """The map of DB_POSES with ICP clouds: JAX's, the port's on the host
    mirror and the port's on the device store without a mirror."""
    model, params, port_model = weights
    pts, mask = _scans(DB_POSES)
    ref = JaxLocalizer(RCFG, model, params, host_stats=True)
    mirror = GlobalLocalizer(RCFG, port_model, host_stats=True,
                             device="cpu")
    store = GlobalLocalizer(RCFG, port_model, host_stats=True, device="cpu",
                            device_keyframes=True, host_mirror=False)
    for loc in (ref, mirror, store):
        loc.add_keyframes(pts, mask)
    return ref, {"mirror": mirror, "store": store}


def _same(got, want, xy_tol=XY_TOL):
    assert got.success == want.success
    assert got.db_index == want.db_index
    np.testing.assert_array_equal(got.candidates, want.candidates)
    assert got.match_score == pytest.approx(want.match_score, abs=1e-3)
    if not want.success:
        assert got.pose is None and got.match_xy_yaw is None
        return
    d = got.match_xy_yaw - np.asarray(want.match_xy_yaw)
    assert np.abs(d[:2]).max() < xy_tol, d
    assert abs(np.angle(np.exp(1j * d[2]))) < xy_tol, d
    np.testing.assert_allclose(got.pose.translation,
                               np.asarray(want.pose.translation),
                               atol=xy_tol)
    np.testing.assert_allclose(got.pose.rotation,
                               np.asarray(want.pose.rotation), atol=xy_tol)


def test_keyframe_clouds_bit_equal_to_jax(maps):
    ref, ports = maps
    for port in ports.values():
        assert len(port.keyframes) == len(ref.keyframes)
        for a, b in zip(port.keyframes, ref.keyframes):
            assert a.cloud.shape == (512, 4) and a.cloud.dtype == np.float32
            np.testing.assert_array_equal(a.cloud, b.cloud)


@pytest.mark.parametrize("q_pose", QUERIES[:3])
def test_locate_with_refine_matches_jax(maps, q_pose):
    """Two queries that register (a polished pose) and one that does not
    (QUERIES[2]: no keyframe registers it)."""
    ref, ports = maps
    pts, mask = scan_at(*q_pose, n=N_PTS)
    _same(ports["mirror"].locate(pts, mask), ref.locate(pts, mask))


def test_refine_tightens_the_match(maps):
    """Against the ground truth of the known poses, the polished (dx, dy)
    errs less than the unrefined match on average (JAX's own check,
    tests/test_pipeline_refine.py). Both come from one registration:
    ``_result`` with and without the query's cloud."""
    loc = maps[1]["mirror"]
    rng = np.random.RandomState(5)
    errs = {"plain": [], "refined": []}
    for dbi in (1, 2, 3, 1):
        x, y, yaw = DB_POSES[dbi]
        dx, dy = rng.uniform(-1, 1, 2)
        c, s = np.cos(yaw), np.sin(yaw)
        wx, wy = x + c * dx - s * dy, y + s * dx + c * dy
        pts, mask = scan_at(wx, wy, yaw + rng.uniform(-0.15, 0.15),
                            n=N_PTS)
        d2, idx, bev, ground = loc.detect(pts[None], mask[None])
        reg = loc._staged(bev.image[0], bev.origin_xy[0], idx[0])
        clouds = loc._query_clouds(pts[None], mask[None], ground)
        res = {"plain": loc._result(reg, idx[0], d2[0], ground),
               "refined": loc._result(reg, idx[0], d2[0], ground,
                                      clouds=clouds)}
        if not res["plain"].success or res["plain"].db_index != dbi:
            continue  # registered elsewhere: no ground truth to hold to
        for name, r in res.items():
            errs[name].append(np.hypot(*(r.match_xy_yaw[:2] - (dx, dy))))
    assert len(errs["refined"]) >= 3, errs
    assert np.mean(errs["refined"]) < np.mean(errs["plain"]), errs


def test_locate_batch_with_refine_matches_locate_and_jax(maps):
    ref, ports = maps
    pts, mask = _scans(QUERIES[1:3])  # one registers, one does not
    want = ref.locate_batch(pts, mask)
    got = {name: port.locate_batch(pts, mask)
           for name, port in ports.items()}
    for q in range(len(pts)):
        _same(got["mirror"][q], want[q])
        _same(got["store"][q], got["mirror"][q], xy_tol=1e-6)
        _same(got["mirror"][q], ports["mirror"].locate(pts[q], mask[q]),
              xy_tol=1e-6)


@pytest.mark.parametrize("where", ["mirror", "store"])
def test_match_keyframe_matches_locate_and_jax(maps, where):
    ref, ports = maps
    port = ports[where]
    pts, mask = scan_at(*QUERIES[1], n=N_PTS)
    located = port.locate(pts, mask)
    assert located.success
    db = located.db_index
    want = ref.match_keyframe(pts, mask, db_index=db)
    got = port.match_keyframe(pts, mask, db_index=db)
    _same(got, want)
    np.testing.assert_array_equal(got.candidates, [db])
    assert np.isnan(got.candidate_dists).all() and got.candidate_dists.shape \
        == (1,)
    np.testing.assert_allclose(got.match_xy_yaw, located.match_xy_yaw,
                               atol=1e-6)
    np.testing.assert_allclose(got.pose.translation,
                               located.pose.translation, atol=1e-6)
    # an earlier extract's bev / ground: the same result, no extraction
    _, bev, ground = port.extract(pts[None], mask[None])
    _same(port.match_keyframe(pts, mask, db_index=db, bev=bev,
                              ground=ground), got, xy_tol=1e-6)
    # bev alone: no scan to polish with, JAX's unpolished result
    _, bev_j, ground_j = ref.extract(pts[None], mask[None])
    _same(port.match_keyframe(db_index=db, bev=bev, ground=ground),
          ref.match_keyframe(db_index=db, bev=bev_j, ground=ground_j),
          xy_tol=1e-4)


@pytest.mark.parametrize("where", ["mirror", "store"])
def test_match_keyframe_failure_and_errors_match_jax(maps, where):
    ref, ports = maps
    port = ports[where]
    pts, mask = scan_at(*QUERIES[0], n=N_PTS)  # at keyframe 1, far from 4
    want = ref.match_keyframe(pts, mask, db_index=4)
    got = port.match_keyframe(pts, mask, db_index=4)
    assert not want.success
    _same(got, want)
    assert got.db_index == -1 and got.candidates.tolist() == [4]
    for bad in (-1, len(DB_POSES)):
        for loc in (ref, port):
            with pytest.raises(IndexError, match="outside"):
                loc.match_keyframe(pts, mask, db_index=bad)
    for loc in (ref, port):
        with pytest.raises(ValueError, match="points or bev"):
            loc.match_keyframe(db_index=0)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_clouds_survive_save_load_across_packages(maps, weights, writer,
                                                  tmp_path):
    ref, ports = maps
    model, params, port_model = weights
    src = ref if writer == "jax" else ports["store"]
    src.save(str(tmp_path))
    if writer == "jax":
        dst = GlobalLocalizer(RCFG, port_model, host_stats=True,
                              device="cpu", device_keyframes=True)
    else:
        dst = JaxLocalizer(RCFG, model, params, host_stats=True)
    dst.load(str(tmp_path))
    for a, b in zip(dst.keyframes, ref.keyframes):
        np.testing.assert_array_equal(a.cloud, b.cloud)
    pts, mask = scan_at(*QUERIES[1], n=N_PTS)
    _same(dst.locate(pts, mask), ref.locate(pts, mask))


def _xyzi(pts, mask):
    """A tilted (N, 3) scan with the zero intensity column the bridged
    model's 4-column weights take."""
    return np.concatenate([pts, np.zeros_like(pts[:, :1])], 1), mask


ALIGNED_DB = [(-30, -30, 0.0), (0, -30, 0.4), (30, 0, 1.5)]
ALIGNED_TILTS = [(0.02, -0.01), (-0.015, 0.02), (0.01, 0.015)]


def test_aligned_refine_matches_jax_with_replayed_draws(weights,
                                                        monkeypatch):
    """align_ground=True, all-device: clouds stored and queried in the
    ground frame; the port replays JAX's ground draws."""
    model, params, port_model = weights
    cfg = RCFG.replace(ground=RCFG.ground.replace(num_candidates=1024,
                                                  ransac_iters=128))
    scans = [_xyzi(*tilted_scan(*p, roll=r, pitch=pi, n=N_PTS, seed=10 + i))
             for i, (p, (r, pi)) in enumerate(zip(ALIGNED_DB,
                                                  ALIGNED_TILTS))]
    pts = np.stack([s[0] for s in scans])
    mask = np.stack([s[1] for s in scans])
    ref = JaxLocalizer(cfg, model, params, align_ground=True, seed=4)
    port = GlobalLocalizer(cfg, port_model, device="cpu", align_ground=True)
    _JaxDraws(4).attach(port, monkeypatch)
    ref.add_keyframes(pts, mask)
    port.add_keyframes(pts, mask)
    for a, b in zip(port.keyframes, ref.keyframes):
        np.testing.assert_allclose(a.cloud, b.cloud, atol=1e-4)
    q = _xyzi(*tilted_scan(2.5, -31.5, 0.7, roll=0.03, pitch=-0.02,
                           height=1.65, n=N_PTS, seed=99))
    want = ref.locate(*q)
    assert want.success and want.db_index == 1
    _same(port.locate(*q), want)


def test_slam_session_example_closes_loops():
    """The port's SLAM example (gloc3d_tpu_torch/examples/slam_session.py)
    at a small size: an 8-pose lap (2 recent frames excluded) of
    2048-point scans; lap 1 rejects every proposal, lap 2 closes within
    the example's gates (run raises otherwise)."""
    from gloc3d_tpu_torch.examples import slam_session

    out = slam_session.run(device="cpu", lap_len=8, n_pts=2048,
                           log=lambda *a: None)
    assert out["lap1_proposals"] > 0
    assert out["closures"] >= 7 and out["max_pos_err_m"] < 1.0
