"""``evaluate_split`` in the port against the JAX package's on the same
world, split and bridged weights: tests/test_evaluator.py's world (six db
sites, queries near three of them) at tests/test_torch_pipeline.py's small
config (2048 points, 128² BEV, fp32, top_k=3).

Cases: the default matcher on the host-stats and the all-device
extraction, the ``fast_match(fm=True)`` preset, the failure dumps (a far
query outside every db view and a query whose label lies 30 m from where
it was scanned), and an aligned all-device map with JAX's ground draws
replayed.

Equal: recall@N, failed detect and registration indices, successes,
totals, banded success, the latency keys, the dumped file names, the npz
arrays (bit for bit) and the failed-index files. Within 1e-3: the mean and
std errors (m and degrees)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gloc3d_tpu.data.dataset import TripletDataset as JaxDataset
from gloc3d_tpu.eval import evaluator as jax_evaluator
from gloc3d_tpu.eval.registration import registration_stats as jax_stats
from gloc3d_tpu.models import build_model as jax_build_model
from gloc3d_tpu.pipeline import GlobalLocalizer as JaxLocalizer
from gloc3d_tpu_torch.convert import flax_to_state_dict
from gloc3d_tpu_torch.data.dataset import TripletDataset
from gloc3d_tpu_torch.eval import evaluator
from gloc3d_tpu_torch.eval.registration import registration_stats
from gloc3d_tpu_torch.models.descriptor import build_model
from gloc3d_tpu_torch.pipeline import GlobalLocalizer
from test_pipeline import scan_at
from test_pipeline_ground import tilted_scan
from test_torch_i2i import _JaxDraws
from test_torch_pipeline import CFG, N_PTS
from test_torch_threads import _two_threads  # noqa: F401

DB_POSES = [(x, y, np.deg2rad(th)) for x, y, th in [
    (-30, -30, 0), (0, -30, 20), (30, -30, -10), (30, 30, 170),
    (0, 30, 180), (-30, 30, 200)]]
Q_POSES = [(DB_POSES[i][0] + dx, DB_POSES[i][1] + dy, DB_POSES[i][2] + dyaw)
           for i, (dx, dy, dyaw) in zip(
               (0, 2, 4), [(2.0, -1.0, 0.2), (-1.5, 2.0, -0.3),
                           (8.0, 1.0, 0.1)])]
FAR = (120.0, 120.0, 0.4)  # outside every db site's 35 m view
ERR_TOL = 1e-3


def _pose(x, y, yaw, roll=0.0, pitch=0.0, z=0.0):
    """4x4 pose: Rz(yaw)·Ry(pitch)·Rx(roll), translation (x, y, z)."""
    cr, sr, cp, sp = np.cos(roll), np.sin(roll), np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    t = np.eye(4)
    t[:3, :3] = [[cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
                 [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
                 [-sp, cp * sr, cp * cr]]
    t[:3, 3] = x, y, z
    return t


def _datasets(db, q, db_poses, q_poses, q_labels=None):
    """The same split as the port's and JAX's TripletDataset: scans
    ((pts, mask) pairs), their 4x4 poses, and the queries' planar labels
    (their poses' by default)."""
    q_labels = (np.array([p[:2, 3] for p in q_poses]) if q_labels is None
                else np.asarray(q_labels, float))
    kw = dict(db_inputs=np.stack([s[0] for s in db]),
              q_inputs=np.stack([s[0] for s in q]),
              utm_db=np.array([p[:2, 3] for p in db_poses]), utm_q=q_labels,
              db_masks=np.stack([s[1] for s in db]),
              q_masks=np.stack([s[1] for s in q]),
              db_poses=np.stack(db_poses), q_poses=np.stack(q_poses))
    return TripletDataset(**kw), JaxDataset(**kw)


@pytest.fixture(scope="module")
def world():
    db = [scan_at(*p, n=N_PTS) for p in DB_POSES]
    q = [scan_at(*p, n=N_PTS) for p in Q_POSES]
    model = jax_build_model(CFG.model, CFG.voxel)
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.asarray(db[0][0][None]),
        jnp.asarray(db[0][1][None]))
    port_model = build_model(CFG.model, CFG.voxel)
    port_model.load_state_dict(flax_to_state_dict(params))
    return db, q, model, params, port_model


def _run(world, cfg, ds_pair, out_dir=None, batch=3, n_values=(1, 3),
         host_stats=True):
    db, q, model, params, port_model = world
    port = GlobalLocalizer(cfg, port_model, host_stats=host_stats,
                           device="cpu")
    ref = JaxLocalizer(cfg, model, params, host_stats=host_stats)
    got = evaluator.evaluate_split(
        port, ds_pair[0], out_dir=out_dir and os.path.join(out_dir, "port"),
        batch=batch, n_values=n_values)
    want = jax_evaluator.evaluate_split(
        ref, ds_pair[1], out_dir=out_dir and os.path.join(out_dir, "jax"),
        batch=batch, n_values=n_values)
    return got, want


def _same_report(got, want):
    assert got.recognition_recall == want.recognition_recall
    assert got.failed_detect_indices == want.failed_detect_indices
    assert got.failed_registration_indices == \
        want.failed_registration_indices
    for key in ("num_success", "num_total", "success_rate"):
        assert got.registration[key] == want.registration[key], key
    for key in ("mean_rot_err_deg", "std_rot_err_deg", "mean_pos_err_m",
                "std_pos_err_m"):
        assert got.registration[key] == pytest.approx(
            want.registration[key], abs=ERR_TOL), key
    assert got.banded_success == want.banded_success
    assert set(got.latency_ms) == set(want.latency_ms)
    assert all(v > 0 for v in got.latency_ms.values())


@pytest.mark.parametrize("host_stats", [True, False],
                         ids=["host-stats", "all-device"])
def test_evaluate_split_matches_jax(world, host_stats):
    db, q = world[:2]
    cfg = CFG.replace(index=CFG.index.replace(top_k=3))
    got, want = _run(world, cfg, _datasets(
        db, q, [_pose(*p) for p in DB_POSES], [_pose(*p) for p in Q_POSES]),
        host_stats=host_stats)
    _same_report(got, want)
    # tests/test_evaluator.py's gates hold in the port too
    assert got.registration["num_total"] == 3
    assert got.registration["success_rate"] >= 2 / 3
    assert got.registration["mean_pos_err_m"] < 1.0
    assert got.recognition_recall[3] >= 2 / 3
    assert set(got.banded_success) == {"easy", "medium", "hard"}


def test_evaluate_split_fast_match_preset_matches_jax(world):
    """At this 128² size the fm preset's coarse grid registers one query of
    three in both packages (tests/test_evaluator.py holds JAX's at 256²):
    the report must still be JAX's."""
    db, q = world[:2]
    cfg = CFG.replace(index=CFG.index.replace(top_k=3)).fast_match(fm=True)
    got, want = _run(world, cfg, _datasets(
        db, q, [_pose(*p) for p in DB_POSES], [_pose(*p) for p in Q_POSES]))
    _same_report(got, want)
    assert got.registration["num_success"] >= 1
    assert got.recognition_recall[3] >= 2 / 3


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_failure_dumps_match_jax(world, tmp_path):
    """A query far from every site fails registration (its overlay is
    rendered); a query labelled 30 m from where it was scanned fails
    detection (its npz is written). Both packages write the same files; the
    npz arrays are bit-equal."""
    db, q = world[:2]
    far = scan_at(*FAR, n=N_PTS)
    q_poses = [_pose(*Q_POSES[0]), _pose(*FAR), _pose(*Q_POSES[1])]
    labels = [Q_POSES[0][:2], FAR[:2], (Q_POSES[1][0] - 30.0,
                                        Q_POSES[1][1])]
    cfg = CFG.replace(index=CFG.index.replace(top_k=3))
    got, want = _run(world, cfg, _datasets(
        db, [q[0], far, q[1]], [_pose(*p) for p in DB_POSES], q_poses,
        q_labels=labels), out_dir=str(tmp_path), batch=2)
    _same_report(got, want)
    assert 1 in got.failed_registration_indices
    assert 2 in got.failed_detect_indices
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    assert _files(port) == _files(ref)
    assert "failure_cases/query_2.npz" in _files(port)
    for name in _files(port):
        a, b = os.path.join(port, name), os.path.join(ref, name)
        if name.endswith(".npz"):
            with np.load(a) as x, np.load(b) as y:
                assert sorted(x.files) == sorted(y.files)
                for k in x.files:
                    assert x[k].dtype == y[k].dtype
                    np.testing.assert_array_equal(x[k], y[k], err_msg=k)
        elif name.endswith(".txt"):
            assert open(a).read() == open(b).read()
    parsed = json.loads(open(os.path.join(port, "eval_report.json")).read())
    assert parsed["failed_registration_indices"] == \
        got.failed_registration_indices
    assert set(parsed["recognition_recall"]) == {"1", "3"}


def test_aligned_evaluate_split_matches_jax(world, monkeypatch):
    """align_ground=True on the all-device path, tilted scans of the world
    with a ground plane, JAX's ground draws replayed into the port."""
    model, params, port_model = world[2:]
    cfg = CFG.replace(index=CFG.index.replace(top_k=3),
                      ground=CFG.ground.replace(num_candidates=1024,
                                                ransac_iters=128))
    sites = [((-30, -30, 0.0), (0.02, -0.01, 1.7)),
             ((0, -30, 0.4), (-0.015, 0.02, 1.7)),
             ((30, 0, 1.5), (0.01, 0.015, 1.7))]
    queries = [((2.5, -31.5, 0.7), (0.03, -0.02, 1.65)),
               ((-28.0, -29.0, 0.2), (-0.01, 0.01, 1.75))]

    def scans(items, seed):
        out = []
        for i, ((x, y, yaw), (r, p, h)) in enumerate(items):
            pts, mask = tilted_scan(x, y, yaw, roll=r, pitch=p, height=h,
                                    n=N_PTS, seed=seed + i)
            out.append((np.concatenate(
                [pts, np.zeros_like(pts[:, :1])], 1), mask))
        return out

    def poses(items):
        return [_pose(x, y, yaw, r, p, h) for (x, y, yaw), (r, p, h) in items]

    port_ds, jax_ds = _datasets(scans(sites, 10), scans(queries, 90),
                                poses(sites), poses(queries))
    port = GlobalLocalizer(cfg, port_model, device="cpu", align_ground=True)
    _JaxDraws(4).attach(port, monkeypatch)
    ref = JaxLocalizer(cfg, model, params, align_ground=True, seed=4)
    got = evaluator.evaluate_split(port, port_ds, batch=3, n_values=(1, 3))
    want = jax_evaluator.evaluate_split(ref, jax_ds, batch=3,
                                        n_values=(1, 3))
    _same_report(got, want)
    assert got.registration["num_success"] == 2


@pytest.mark.parametrize("case", ["random", "empty", "all-failed",
                                  "none-attempted"])
def test_registration_stats_matches_jax(case):
    rng = np.random.RandomState(3)
    n = {"empty": 0}.get(case, 40)
    err_pos = rng.uniform(0, 2, n)
    err_rot = rng.uniform(0, 10, n)
    attempted = rng.rand(n) > 0.2
    if case == "all-failed":
        err_pos += 5.0
    if case == "none-attempted":
        attempted[:] = False
    got = registration_stats(err_pos, err_rot, attempted)
    want = jax_stats(err_pos, err_rot, attempted)
    assert tuple(got) == tuple(want)
    assert got._fields == want._fields
    assert got.num_total == n
    if case != "random":
        assert got.num_success == 0 and got.success_rate == 0.0


def test_eval_report_json_matches_jax():
    fields = dict(
        recognition_recall={1: 0.5, 5: 0.75, 10: 1.0},
        registration={"success_rate": 2 / 3, "mean_pos_err_m": 0.123456789,
                      "num_success": 2, "num_total": 3},
        banded_success={"easy": 1.0, "medium": 0.0, "hard": 0.0},
        latency_ms={"locate_per_query": 12.5},
        failed_detect_indices=[2], failed_registration_indices=[1, 2])
    got = evaluator.EvalReport(**fields).to_json()
    assert got == jax_evaluator.EvalReport(**fields).to_json()
    assert json.loads(got)["recognition_recall"] == {"1": 0.5, "5": 0.75,
                                                     "10": 1.0}
