"""The port's valset text export and visual-debugging utilities against the
JAX package's: ``write_valset`` writes byte-identical files for every band
and for ``max_pairs`` sampling, ``read_valset`` round-trips them,
``banded_positives`` and the quaternion conversion are equal, and
``match_overlay`` renders bit-equal images. The cases follow
tests/test_valset.py (its CLI case waits for the port's CLI) and
tests/test_viz.py."""

import os
import sys

import numpy as np
import pytest

from gloc3d_tpu.data import valset as jax_valset
from gloc3d_tpu.data import viz as jax_viz
from gloc3d_tpu_torch.data import valset, viz
from test_torch_threads import _two_threads  # noqa: F401


class _Split:
    """A SplitIndex-like split with random planar poses."""

    def __init__(self, n_db=5, n_q=3, seed=0, spread=50.0):
        rng = np.random.RandomState(seed)
        self.db_files = [f"/data/db_{i:06d}.bin" for i in range(n_db)]
        self.q_files = [f"/data/q_{i:06d}.bin" for i in range(n_q)]

        def poses(n):
            out = np.tile(np.eye(4), (n, 1, 1))
            for i in range(n):
                a = rng.uniform(0, 2 * np.pi)
                c, s = np.cos(a), np.sin(a)
                out[i, :3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
                out[i, :3, 3] = rng.uniform(-spread, spread, 3)
            return out

        self.db_poses = poses(n_db)
        self.q_poses = poses(n_q)
        self.utm_db = self.db_poses[:, :2, 3]
        self.utm_q = self.q_poses[:, :2, 3]


def _axis_angle(rng):
    v = rng.randn(3)
    a = np.linalg.norm(v)
    k = v / a
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(a) * kx + (1 - np.cos(a)) * kx @ kx


def test_quat_from_matrix_matches_jax():
    rng = np.random.RandomState(1)
    rots = [_axis_angle(rng) for _ in range(20)]
    # each Shepperd branch: the trace and each diagonal term largest
    rots += [np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]),
             np.diag([-1.0, -1.0, 1.0]), np.eye(3)]
    for rot in rots:
        got = valset._quat_xyzw_from_matrix(rot)
        np.testing.assert_array_equal(
            got, jax_valset._quat_xyzw_from_matrix(rot))
        x, y, z, w = got
        rec = np.array([
            [1 - 2 * (y**2 + z**2), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x**2 + z**2), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x**2 + y**2)],
        ])
        np.testing.assert_allclose(rec, rot, atol=1e-9)


@pytest.mark.parametrize("band", sorted(valset.BANDS))
def test_banded_positives_match_jax(band):
    split = _Split(n_db=30, n_q=8, seed=2, spread=12.0)
    got = valset.banded_positives(split.utm_db, split.utm_q, band)
    want = jax_valset.banded_positives(split.utm_db, split.utm_q, band)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    utm_db = np.array([[0.0, 0], [4, 0], [7, 0], [12, 0], [30, 0]])
    idx, dist = valset.banded_positives(utm_db, np.array([[0.0, 0]]), band)
    assert idx[0].tolist() == {"easy": [0, 1], "medium": [2],
                               "hard": [3]}[band]


def _write_both(tmp_path, split, **kw):
    """Write with both packages; return the two (index, pose) path pairs."""
    out = []
    for who, mod in (("port", valset), ("jax", jax_valset)):
        idx = str(tmp_path / f"{who}_index.txt")
        pose = str(tmp_path / f"{who}_pose.txt")
        mod.write_valset(split, idx, pose, **kw)
        out.append((idx, pose))
    return out


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("band", sorted(valset.BANDS))
def test_write_valset_byte_identical_and_round_trips(tmp_path, band):
    split = _Split(n_db=30, n_q=8, seed=3, spread=12.0)
    (idx, pose), (j_idx, j_pose) = _write_both(tmp_path, split, band=band)
    _same_bytes(idx, j_idx)
    _same_bytes(pose, j_pose)
    db_files, q_files, positives, poses = valset.read_valset(idx, pose)
    assert db_files == split.db_files and q_files == split.q_files
    want, _ = valset.banded_positives(split.utm_db, split.utm_q, band)
    assert [p.tolist() for p in positives] == [w.tolist() for w in want]
    np.testing.assert_allclose(
        poses, np.concatenate([split.db_poses, split.q_poses]), atol=1e-9)
    j_read = jax_valset.read_valset(j_idx, j_pose)
    assert j_read[:2] == (db_files, q_files)
    np.testing.assert_array_equal(j_read[3], poses)


@pytest.mark.parametrize("cap,seed", [(8, 1), (8, 2), (1000, 0)])
def test_sampled_pairs_byte_identical(tmp_path, cap, seed):
    rng = np.random.RandomState(5)
    split = _Split(n_db=40, n_q=10, seed=4)
    split.utm_db = rng.uniform(0, 30, (40, 2))
    split.utm_q = rng.uniform(0, 30, (10, 2))
    (idx, pose), (j_idx, j_pose) = _write_both(
        tmp_path, split, band="easy", max_pairs=cap, seed=seed)
    _same_bytes(idx, j_idx)
    _same_bytes(pose, j_pose)
    sampled = valset.read_valset(idx, pose)[2]
    full, _ = valset.banded_positives(split.utm_db, split.utm_q, "easy")
    n_full = sum(len(p) for p in full)
    assert sum(len(p) for p in sampled) == min(cap, n_full)


def test_write_valset_rejects_an_unknown_band(tmp_path):
    with pytest.raises(ValueError, match="band must be one of"):
        valset.write_valset(_Split(), str(tmp_path / "i.txt"),
                            str(tmp_path / "p.txt"), band="extreme")


# --------------------------------------------------------------------- viz
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_match_overlay_matches_jax(dtype):
    rng = np.random.RandomState(6)
    s, res = 96, 0.4
    imgs = []
    for _ in range(2):
        img = (rng.rand(s, s) > 0.93).astype(np.float32)
        img = 1.0 - img  # free = 1, occupied = 0
        imgs.append((img * 255).astype(np.uint8) if dtype == np.uint8
                    else img)
    q_origin = rng.uniform(-20, -15, 2).astype(np.float32)
    db_origin = rng.uniform(-20, -15, 2).astype(np.float32)
    xy_yaw = np.array([rng.uniform(-3, 3), rng.uniform(-3, 3),
                       rng.uniform(-np.pi, np.pi)])
    got = viz.match_overlay(imgs[0], q_origin, imgs[1], db_origin, xy_yaw,
                            res)
    want = jax_viz.match_overlay(imgs[0], q_origin, imgs[1], db_origin,
                                 xy_yaw, res)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert (got == (230, 210, 60)).all(-1).any()  # some agreement drawn


def test_match_overlay_alignment():
    """A perfectly registered pair renders overlapping pixels yellow."""
    s, res = 64, 0.5
    db = np.ones((s, s), np.float32)
    db[30, 20:40] = 0.0
    origin = np.array([-16.0, -16.0], np.float32)
    q = np.ones((s, s), np.float32)
    q[28, 16:36] = 0.0
    img = viz.match_overlay(q, origin.copy(), db, origin,
                            np.array([4 * res, 2 * res, 0.0]), res)
    assert (img == (230, 210, 60)).all(-1).sum() == 20
    assert (img == (80, 200, 80)).all(-1).sum() == 0


def test_pngs_written_like_jax(tmp_path, monkeypatch):
    """Both write the PNGs where matplotlib is installed and return False,
    writing nothing, where it is not (as on the card's machine)."""
    rng = np.random.RandomState(0)
    paths = {who: str(tmp_path / f"{who}_traj.png") for who in ("p", "j")}
    ok = viz.plot_split_trajectory(rng.randn(50, 2) * 100,
                                   rng.randn(10, 2) * 100, paths["p"])
    assert ok == jax_viz.plot_split_trajectory(
        rng.randn(50, 2) * 100, rng.randn(10, 2) * 100, paths["j"])
    rgb = rng.randint(0, 255, (16, 16, 3)).astype(np.uint8)
    png = str(tmp_path / "overlay.png")
    assert viz.save_png(png, rgb) == ok
    if ok:
        assert os.path.getsize(paths["p"]) > 1000 and os.path.exists(png)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    for mod in (viz, jax_viz):
        none = str(tmp_path / "none.png")
        assert mod.save_png(none, rgb) is False
        assert mod.plot_split_trajectory(rng.randn(5, 2), rng.randn(2, 2),
                                         none) is False
        assert not os.path.exists(none)
