"""The port's sharded keyframe store (``GlobalLocalizer.shard_keyframes``),
rotation-sharded matcher (``ops/scan_match.py::match_scan_fast_sharded``)
and ``parallel/mesh.py::make_mesh`` over a gloo group of two ranks on the
CPU, against the port's unsharded calls and JAX's sharded ones on a
2-device mesh of the conftest's virtual CPU devices.

One group (two fresh processes running ``tests/_torch_store_worker.py``,
which import neither JAX nor this conftest) runs every case once for the
whole file, while this process computes JAX's side; each rank writes what
it got.

The cases are tests/test_device_keyframes.py's sharded store (its three
keyframes and its query, two more queries, its added keyframe) and
tests/test_scan_match_fast.py's sharded matcher (R = 64; R = 63, not a
multiple of the two ranks, refused).
Held: the sharded store's results bit-equal to the unsharded store's on
``locate``, ``locate_batch`` and ``locate_fused`` (the same bytes reach the
matcher), and to JAX's sharded store within test_torch_pipeline.py's
parity bounds; each rank holding ⌈capacity/2⌉ rows; the matcher's
certified optimum = ``match_scan_fast``'s and JAX's sharded one's (score
within 1e-4, the pose the same or score-tied)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from gloc3d_tpu.config import MeshConfig
from gloc3d_tpu.ops.occupancy import ProbabilityGrid2D
from gloc3d_tpu.ops.scan_match import match_scan_fast_sharded, score_at
from gloc3d_tpu.parallel import make_mesh as jax_make_mesh
from gloc3d_tpu.pipeline import GlobalLocalizer as JaxLocalizer
from gloc3d_tpu_torch.convert import flax_to_state_dict
from gloc3d_tpu_torch.parallel.launch import free_port
from test_device_keyframes import N_PTS, _build_pair, _cfg
from test_pipeline import scan_at
from test_scan_match_fast import _offset_scan, _random_grid_and_scan
from test_torch_threads import _two_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_store_worker.py")
WORLD = 2
KF_POSES = [(-30, -30, 0.0), (30, 0, 1.5), (0, 35, 2.8)]
Q_POSES = [(30.5, 0.4, 1.45), (-29.5, -30.5, 0.1), (0.5, 34.5, 2.75)]
EXTRA_POSE = (29.5, 0.5, 1.4)  # test_device_keyframes.py's added keyframe
N_GROW = 8                     # rows written at 1020-1027: past 1024
FIELDS = ("ok", "db", "cand", "dist", "score", "xy")


def _scans(poses):
    scans = [scan_at(*p, n=N_PTS) for p in poses]
    return np.stack([s[0] for s in scans]), np.stack([s[1] for s in scans])


def _inputs(cfg):
    inp = {}
    inp["kf_pts"], inp["kf_mask"] = _scans(KF_POSES)
    inp["q_pts"], inp["q_mask"] = _scans(Q_POSES)
    inp["extra_pts"], inp["extra_mask"] = scan_at(*EXTRA_POSE, n=N_PTS)
    rng = np.random.RandomState(5)
    inp["grow_images"] = (rng.rand(N_GROW, 128, 128) > 0.1).astype(
        np.float32)
    inp["grow_origins"] = rng.randn(N_GROW, 2).astype(np.float32)
    grid, map_pts = _random_grid_and_scan(3)
    inp["scan"] = _offset_scan(map_pts, np.array([1.2, 0.4, -0.7]))
    inp["grid_log_odds"] = np.asarray(grid.log_odds)
    inp["grid_known"] = np.asarray(grid.known)
    inp["grid_origin"] = np.asarray(grid.origin_xy)
    inp["grid_resolution"] = np.float32(grid.resolution)
    inp["cfg_json"] = np.array(cfg.to_json())
    return inp, grid


def _jax_side(inp, cfg, loc, model, params, grid, mesh, out):
    """JAX's sharded store (its locate before and after the add) and its
    host_mirror=False save of a sharded store; its sharded matcher."""
    want = {}
    loc.add_keyframes(inp["kf_pts"], inp["kf_mask"])
    loc.shard_keyframes(mesh)
    want["loc"] = [loc.locate(p, m) for p, m in zip(inp["q_pts"],
                                                    inp["q_mask"])]
    loc.add_keyframes(inp["extra_pts"][None], inp["extra_mask"][None])
    want["extra"] = loc.locate(inp["extra_pts"], inp["extra_mask"])
    off = JaxLocalizer(cfg, model, params, device_keyframes=True,
                       host_mirror=False)
    off.add_keyframes(inp["kf_pts"], inp["kf_mask"])
    off.shard_keyframes(mesh)
    off.save(str(out / "map_jax"))
    pts, m = jnp.asarray(inp["scan"]), jnp.ones(len(inp["scan"]))
    # jitted: an eager shard_map compiles each of its ops (~25 s here)
    want["match"] = jax.jit(lambda lo, kn, org, p, mk: (
        match_scan_fast_sharded(mesh, ProbabilityGrid2D(
            lo, kn, org, grid.resolution), p, mk, num_rotations=64)))(
        grid.log_odds, grid.known, grid.origin_xy, pts, m)
    with pytest.raises(ValueError):
        match_scan_fast_sharded(mesh, grid, pts, m, num_rotations=63)
    want["mesh_sizes"] = [jax_make_mesh(MeshConfig(num_devices=n)).devices.size
                          for n in (0, 1, 2)]
    return want


@pytest.fixture(scope="module")
def run(tmp_path_factory, devices):
    """Start the two ranks, compute JAX's side meanwhile, and return (both
    ranks' results, JAX's, the run's directory, JAX's grid)."""
    out = tmp_path_factory.mktemp("shard_store")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(WORLD), str(port), str(out)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    try:
        # the ranks import torch and join their group meanwhile
        cfg = _cfg()
        loc, model, params = _build_pair(cfg, device_keyframes=True)
        inp, grid = _inputs(cfg)
        torch.save(flax_to_state_dict(params), out / "params.pt")
        np.savez(out / "inputs.tmp.npz", **inp)
        os.replace(out / "inputs.tmp.npz", out / "inputs.npz")
        mesh = Mesh(np.array(devices[:WORLD]), ("data",))
        want = _jax_side(inp, cfg, loc, model, params, grid, mesh, out)
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    got = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    return got, want, out, grid


def _ranks(run, key):
    """``key`` from both ranks, which must agree bit for bit."""
    got = run[0]
    np.testing.assert_array_equal(got[0][key], got[1][key], err_msg=key)
    return got[0][key]


def _same(run, a, b, n=len(Q_POSES)):
    """The results recorded under ``a`` and ``b``, bit for bit."""
    for i in range(n):
        for f in FIELDS:
            np.testing.assert_array_equal(_ranks(run, f"{a}_{i}_{f}"),
                                          _ranks(run, f"{b}_{i}_{f}"),
                                          err_msg=f"{a} / {b} {i} {f}")


def _like_jax(run, key, want, i=0):
    """test_torch_pipeline.py's parity bounds against a JAX result."""
    got = {f: _ranks(run, f"{key}_{i}_{f}") for f in FIELDS}
    assert bool(got["ok"]) == want.success
    assert int(got["db"]) == want.db_index
    np.testing.assert_array_equal(got["cand"], want.candidates)
    np.testing.assert_allclose(got["dist"], want.candidate_dists,
                               atol=1e-3, rtol=2e-3)
    assert float(got["score"]) == pytest.approx(want.match_score, abs=1e-3)
    if want.success:
        np.testing.assert_allclose(got["xy"][:2],
                                   np.asarray(want.match_xy_yaw)[:2],
                                   atol=1e-3)


@pytest.mark.parametrize("mode", ["", "_batch", "_fused"])
def test_sharded_store_equals_the_unsharded_store(run, mode):
    """locate / locate_batch / locate_fused on the sharded store = the same
    call on the unsharded store, bit for bit, and every query localizes."""
    _same(run, "loc" + mode, "base" + mode)
    assert all(bool(_ranks(run, f"loc{mode}_{i}_ok"))
               for i in range(len(Q_POSES)))


@pytest.mark.parametrize("i", range(len(Q_POSES)))
def test_sharded_store_locate_matches_jax(run, i):
    _like_jax(run, "loc", run[1]["loc"][i], i)


def test_each_rank_holds_its_rows(run):
    """⌈1024/2⌉ rows a rank; rank r holds the rows i ≡ r mod 2: after the
    add, rank 0's local row 1 is global row 2 and rank 1's is row 3."""
    got = run[0]
    assert all(int(g["local_rows"]) == 512 and int(g["cap"]) == 1024
               for g in got)
    rows = _ranks(run, "rows_base")
    np.testing.assert_array_equal(_ranks(run, "rows_loc"), rows)
    for r in range(WORLD):
        np.testing.assert_array_equal(got[r]["local_row1"], rows[2 + r])


def test_add_after_sharding_matches_jax(run):
    """test_device_keyframes.py's added keyframe (row 3, on rank 1)
    localizes its own scan, as on the unsharded store and in JAX."""
    _same(run, "extra", "base_extra", n=1)
    assert int(_ranks(run, "extra_0_db")) == 3
    _like_jax(run, "extra", run[1]["extra"])


def test_growth_keeps_every_row(run):
    """Rows written at 1020-1027 double the capacity; every rank grows its
    own part to 1024 rows and no earlier row moves."""
    got = run[0]
    assert all(int(g["grown_cap"]) == 2048 and int(g["grown_local_rows"])
               == 1024 for g in got)
    np.testing.assert_array_equal(_ranks(run, "grown_loc"),
                                  _ranks(run, "grown_base"))
    np.testing.assert_array_equal(_ranks(run, "grown_loc_org"),
                                  _ranks(run, "grown_base_org"))
    inp = np.load(run[2] / "inputs.npz")
    np.testing.assert_array_equal(_ranks(run, "grown_loc_org")[-N_GROW:],
                                  inp["grow_origins"])
    _same(run, "grown", "grown_base")


def test_save_and_load_without_host_mirror(run):
    """The sharded store's save (rank 0 writes the rows gathered from both
    ranks) = the unsharded store's = JAX's sharded store's; the map loads
    into a sharded localizer and locates as the unsharded store."""
    out = run[2]
    sharded = np.load(out / "map" / "keyframes.npz")
    for other in ("map_flat", "map_jax"):
        ref = np.load(out / other / "keyframes.npz")
        np.testing.assert_array_equal(sharded["images"], ref["images"])
        np.testing.assert_array_equal(sharded["origins"], ref["origins"])
    _same(run, "loaded", "base")


def test_sharded_bank_over_sharded_store(run):
    """shard_bank composes: the located results keep the unsharded
    store's ids and poses."""
    for i in range(len(Q_POSES)):
        for f in ("ok", "db", "cand", "xy"):
            np.testing.assert_array_equal(_ranks(run, f"both_{i}_{f}"),
                                          _ranks(run, f"grown_base_{i}_{f}"))
        np.testing.assert_allclose(_ranks(run, f"both_{i}_dist"),
                                   _ranks(run, f"grown_base_{i}_dist"),
                                   atol=1e-4)


def test_shard_keyframes_needs_a_built_store(run):
    assert "built store" in str(_ranks(run, "no_store"))


def test_sharded_matcher_matches_single_and_jax(run):
    """test_scan_match_fast.py's case: certified, the same optimum as
    match_scan_fast and as JAX's sharded call; R = 63 refused."""
    grid = run[3]
    pts = jnp.asarray(np.load(run[2] / "inputs.npz")["scan"])
    m = jnp.ones(pts.shape[0])
    want, want_cert = run[1]["match"]
    pose, score = _ranks(run, "m_pose"), float(_ranks(run, "m_score"))
    assert bool(_ranks(run, "m_cert")) and bool(_ranks(run, "m1_cert"))
    assert bool(want_cert)
    for other in (float(_ranks(run, "m1_score")), float(want.score)):
        assert abs(score - other) < 1e-4
    for other in (_ranks(run, "m1_pose"), np.asarray(want.pose)):
        if not np.allclose(pose, other, atol=1e-5):  # a score tie only
            tied = float(score_at(grid, pts, m, jnp.asarray(pose)))
            assert abs(tied - float(want.score)) < 1e-4
    assert "must divide" in str(_ranks(run, "m_r63"))


def test_make_mesh(run):
    """num_devices 0 and the world size name the default group (None);
    num_devices 1 makes a group of rank 0 alone, which runs the sharded
    matcher by itself, as JAX's one-device mesh does."""
    got = run[0]
    assert all(bool(g["mesh_0_default"]) and bool(g["mesh_2_default"])
               for g in got)
    assert bool(got[0]["mesh_1_member"]) and not bool(got[1]["mesh_1_member"])
    assert int(got[0]["mesh_1_size"]) == 1 and "mesh_1_size" not in got[1]
    assert bool(got[0]["mesh_1_cert"])
    np.testing.assert_array_equal(got[0]["mesh_1_pose"], got[0]["m1_pose"])
    assert run[1]["mesh_sizes"] == [8, 1, 2]


def test_ranks_load_no_jax(run):
    """The ranks ran the port alone: no module of JAX, flax or the JAX
    package was loaded in them."""
    for got in run[0]:
        assert got["jax_modules"].size == 0, got["jax_modules"]
