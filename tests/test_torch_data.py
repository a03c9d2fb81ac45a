"""The port's data readers, dataset bindings and native file loaders
against the JAX package's on the same files, written into ``tmp_path``
from a numpy seed.

Equal, bit for bit: decoded scans, counts, pillar-sorted rows, ids and
starts, masks, split file lists, pillar statistics and per-point rows.
Poses from a KITTI layout with a non-identity calib: within 1e-12. A
missing file raises in both; a truncated one decodes its whole records.
The cases follow tests/test_data.py and tests/test_hoststats_path.py."""

import os
import sys

import numpy as np
import pytest

from gloc3d_tpu.data import kitti as jax_kitti
from gloc3d_tpu.data import native as jax_native
from gloc3d_tpu.data import nclt as jax_nclt
from gloc3d_tpu.data import nuscenes as jax_nuscenes
from gloc3d_tpu.data import readers as jax_readers
from gloc3d_tpu_torch.data import kitti, native, nclt, nuscenes, readers
from test_torch_threads import _two_threads  # noqa: F401

XB, YB, ZB = (-10.0, 10.0, 0.5), (-6.0, 6.0, 0.5), (-10.0, 10.0, 20.0)


def _equal(a, b):
    """Tuples of arrays equal element by element, dtypes included."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _write_scans(tmp_path, sizes, seed, cols=4, scale=1.0):
    rng = np.random.RandomState(seed)
    paths = []
    for i, n in enumerate(sizes):
        p = str(tmp_path / f"{i:06d}.bin")
        (rng.randn(n, cols) * scale).astype(np.float32).tofile(p)
        paths.append(p)
    return paths


def _write_nclt(path, n, seed):
    rng = np.random.RandomState(seed)
    rng.randint(0, 255, (n, 8)).astype(np.uint8).tofile(path)


# ------------------------------------------------------------------ readers
@pytest.mark.parametrize("fmt", ["kitti", "nuscenes", "nclt"])
def test_bin_readers_match_jax(tmp_path, fmt):
    p = str(tmp_path / "scan.bin")
    if fmt == "nclt":
        _write_nclt(p, 97, seed=3)
        with open(p, "ab") as f:
            f.write(b"\x07\x08\x09")  # a trailing partial record
    else:
        np.random.RandomState(1).randn(50, 4 if fmt == "kitti" else 5
                                       ).astype(np.float32).tofile(p)
    name = f"read_{fmt}_bin"
    got, want = getattr(readers, name)(p), getattr(jax_readers, name)(p)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_nclt_known_record(tmp_path):
    rec = np.zeros(8, np.uint8)
    rec[:2] = np.array([20200], "<u2").view(np.uint8)   # x = 1.0 m
    rec[2:4] = np.array([20000], "<u2").view(np.uint8)  # y = 0.0
    rec[4:6] = np.array([20400], "<u2").view(np.uint8)  # z = 2.0
    rec[6] = 77
    p = str(tmp_path / "scan.bin")
    rec.tofile(p)
    np.testing.assert_allclose(readers.read_nclt_bin(p)[0],
                               [1.0, 0.0, 2.0, 77.0], atol=1e-5)


def _calib_tr(seed=0):
    """A non-identity T_cam0_velo: KITTI's axis swap, a small rotation and
    an offset."""
    rng = np.random.RandomState(seed)
    swap = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], np.float64)
    a = rng.uniform(-0.02, 0.02, 3)
    rx = np.array([[1, 0, 0], [0, np.cos(a[0]), -np.sin(a[0])],
                   [0, np.sin(a[0]), np.cos(a[0])]])
    rz = np.array([[np.cos(a[2]), -np.sin(a[2]), 0],
                   [np.sin(a[2]), np.cos(a[2]), 0], [0, 0, 1]])
    t = np.eye(4)
    t[:3, :3] = swap @ rx @ rz
    t[:3, 3] = [-0.004, -0.076, -0.272]
    return t


def _kitti_layout(root, seqs=("08",), n=12, pts=64, seed=0):
    """A KITTI odometry layout: velodyne scans, cam0 poses through a
    non-identity Tr, calib.txt with P0 and Tr lines. Returns the velodyne
    poses written, per sequence."""
    rng = np.random.RandomState(seed)
    tr = _calib_tr(seed)
    out = {}
    for s, seq in enumerate(seqs):
        velo = root / "sequences" / seq / "velodyne"
        velo.mkdir(parents=True)
        (root / "poses").mkdir(exist_ok=True)
        cam, vel = [], []
        for i in range(n):
            rng.uniform(-10, 10, (pts + i, 4)).astype(np.float32).tofile(
                str(velo / f"{i:06d}.bin"))
            yaw = 0.1 * i + s
            tv = np.eye(4)
            tv[:2, :2] = [[np.cos(yaw), -np.sin(yaw)],
                          [np.sin(yaw), np.cos(yaw)]]
            tv[:3, 3] = [2.0 * i + 100 * s, 0.3 * i, 0.01 * i]
            vel.append(tv)
            cam.append((tv @ np.linalg.inv(tr))[:3].reshape(-1))
        np.savetxt(str(root / "poses" / f"{seq}.txt"), np.stack(cam))
        (root / "sequences" / seq / "calib.txt").write_text(
            "P0: " + " ".join(["1.0"] * 12) + "\n"
            "Tr: " + " ".join(repr(float(v)) for v in tr[:3].reshape(-1))
            + "\n")
        out[seq] = np.stack(vel)
    return out


def test_kitti_poses_calib_match_jax(tmp_path):
    _kitti_layout(tmp_path)
    poses = str(tmp_path / "poses" / "08.txt")
    calib = str(tmp_path / "sequences" / "08" / "calib.txt")
    got = readers.read_kitti_poses(poses), readers.read_kitti_calib(calib)
    want = jax_readers.read_kitti_poses(poses), \
        jax_readers.read_kitti_calib(calib)
    _equal(got, want)
    _equal((readers.kitti_velo_poses(*got),),
           (jax_readers.kitti_velo_poses(*want),))
    bad = tmp_path / "bad_calib.txt"
    bad.write_text("P0: 1 2 3\n")
    with pytest.raises(ValueError, match="no 'Tr' line"):
        readers.read_kitti_calib(str(bad))


def test_nclt_enu_and_interpolation_match_jax():
    rng = np.random.RandomState(4)
    lat = 0.7405 + np.cumsum(rng.uniform(0, 1e-7, 30))
    lng = -1.4605 + np.cumsum(rng.uniform(0, 1e-7, 30))
    alt = rng.uniform(260, 280, 30)
    _equal((readers.nclt_rtk_to_enu(lat, lng, alt),
            readers.nclt_rtk_to_enu(lat, lng, alt, lat0=0.74, lng0=-1.46)),
           (jax_readers.nclt_rtk_to_enu(lat, lng, alt),
            jax_readers.nclt_rtk_to_enu(lat, lng, alt, lat0=0.74,
                                        lng0=-1.46)))
    ts = np.sort(rng.uniform(0, 100, 40))
    vals = rng.randn(40, 3)
    tq = np.concatenate([rng.uniform(-5, 105, 25), ts[:3],
                         (ts[:-1] + ts[1:])[:3] / 2])  # ties go left
    _equal((readers.interpolate_nearest(ts, vals, tq),),
           (jax_readers.interpolate_nearest(ts, vals, tq),))


# ---------------------------------------------------------- native loader
def test_native_library_built():
    assert native.load_library() is not None
    assert os.path.dirname(native.library_path()) == native.BUILD_DIR


@pytest.mark.parametrize("fmt", ["kitti", "nuscenes", "nclt"])
def test_load_scan_batch_matches_jax(tmp_path, fmt):
    sizes = [200, 250, 0, 350, 400]
    if fmt == "nclt":
        paths = [str(tmp_path / f"{i}.bin") for i in range(len(sizes))]
        for i, (p, n) in enumerate(zip(paths, sizes)):
            _write_nclt(p, n, seed=i)
    else:
        paths = _write_scans(tmp_path, sizes, seed=2,
                             cols=4 if fmt == "kitti" else 5)
    got = native.load_scan_batch(paths, fmt, max_points=384, num_threads=3)
    want = jax_native.load_scan_batch(paths, fmt, max_points=384)
    _equal(got, want)
    assert got[1].tolist() == [min(n, 384) for n in sizes]
    read = getattr(readers, f"read_{fmt}_bin")
    # NCLT's scale and offset: the library may fuse them (one rounding),
    # numpy rounds twice, 1.5e-5 apart at the 200 m range
    atol = 3e-5 if fmt == "nclt" else 0.0
    for i, p in enumerate(paths):
        n = int(got[1][i])
        np.testing.assert_allclose(got[0][i, :n], read(p)[:n], rtol=0,
                                   atol=atol)
        assert (got[0][i, n:] == 0).all()
    masks = native.masks_from_counts(got[1], 384)
    _equal((masks,), (jax_native.masks_from_counts(want[1], 384),))
    assert masks.sum() == got[1].sum()


def test_load_scan_batch_trims(tmp_path):
    p = str(tmp_path / "big.bin")
    np.arange(4000, dtype=np.float32).reshape(1000, 4).tofile(p)
    got = native.load_scan_batch([p], "kitti", max_points=128)
    _equal(got, jax_native.load_scan_batch([p], "kitti", max_points=128))
    assert got[1][0] == 128
    np.testing.assert_array_equal(got[0][0, -1], [508, 509, 510, 511])


def test_truncated_and_missing_files(tmp_path):
    good = tmp_path / "good.bin"
    np.random.RandomState(0).randn(100, 4).astype(np.float32).tofile(
        str(good))
    short = tmp_path / "short.bin"
    short.write_bytes(b"\x01\x02\x03" * 7)  # 21 bytes: 1 whole record + tail
    paths = [str(good), str(short)]
    got = native.load_scan_batch(paths, "kitti", max_points=256)
    _equal(got, jax_native.load_scan_batch(paths, "kitti", max_points=256))
    assert got[1].tolist() == [100, 1]
    missing = str(tmp_path / "nope.bin")
    with pytest.raises(Exception):
        jax_native.load_scan_batch([missing], "kitti", max_points=64)
    for load, args in (
            (native.load_scan_batch, ("kitti", 64)),
            (native.load_scan_batch_pillar_sorted, ("kitti", XB, YB, ZB, 64)),
            (native.load_scan_batch_voxel_stats, ("kitti", XB, YB, ZB, 64))):
        with pytest.raises(OSError, match="nope.bin") as e:
            load([str(good), missing], *args)
        assert "good.bin" not in str(e.value)


def _grid_scans(tmp_path, seed, sizes=(420, 300, 512, 0)):
    """Scans with points inside, around and outside the small grid."""
    rng = np.random.RandomState(seed)
    paths = []
    for i, n in enumerate(sizes):
        pts = np.stack([rng.uniform(-12, 12, n), rng.uniform(-7, 7, n),
                        rng.uniform(0, 3, n), rng.uniform(0, 1, n)],
                       1).astype(np.float32)
        p = str(tmp_path / f"g{i}.bin")
        pts.tofile(p)
        paths.append(p)
    return paths


def test_pillar_sorted_loader_matches_jax_and_reference(tmp_path):
    paths = _grid_scans(tmp_path, seed=5)
    got = native.load_scan_batch_pillar_sorted(paths, "kitti", XB, YB, ZB,
                                               max_points=512, num_threads=2)
    want = jax_native.load_scan_batch_pillar_sorted(paths, "kitti", XB, YB,
                                                    ZB, max_points=512)
    _equal(got, want)
    raw, counts = native.load_scan_batch(paths, "kitti", 512)
    _equal(got, native.sort_points_by_pillar(raw, counts, XB, YB, ZB))
    _equal(got, jax_native.sort_points_by_pillar(raw, counts, XB, YB, ZB))
    assert (got[3][:, -1] == 512).all()


# ------------------------------------------------------- the rest of the
# host pass: statistics of unsorted rows, per-point rows, the stats loader
def _padded(seed=0, b=2, n=512, n_real=420):
    rng = np.random.RandomState(seed)
    pts = np.zeros((b, n, 4), np.float32)
    pts[:, :n_real, 0] = rng.uniform(-12, 12, (b, n_real))  # some OOB
    pts[:, :n_real, 1] = rng.uniform(-7, 7, (b, n_real))
    pts[:, :n_real, 2] = rng.uniform(0, 3, (b, n_real))
    pts[:, :n_real, 3] = rng.uniform(0, 1, (b, n_real))
    return pts, np.full(b, n_real, np.int64)


@pytest.mark.parametrize("crop,budget", [(False, None), (True, None),
                                         (True, 300)])
def test_voxel_stats_host_matches_jax(crop, budget):
    pts, counts = _padded(seed=1)
    got = native.compute_voxel_stats_host(pts, counts, XB, YB, ZB, crop=crop,
                                          max_points=budget, num_threads=2)
    # one scan per JAX call: JAX's library reads scan i at row i * M of the
    # input, so with a budget M below the pad N it reads scan 1 from the
    # wrong rows (the port's passes the input's own row count)
    want = tuple(np.concatenate(parts) for parts in zip(*(
        jax_native.compute_voxel_stats_host(
            pts[i:i + 1], counts[i:i + 1], XB, YB, ZB, crop=crop,
            max_points=budget) for i in range(len(pts)))))
    _equal(got, want)
    if not crop:
        np.testing.assert_array_equal(got[0], pts)
    np.testing.assert_allclose(got[3].sum(axis=1), budget or pts.shape[1])


@pytest.mark.parametrize("crop", [False, True])
def test_per_point_stats_table_matches_jax(crop):
    pts, counts = _padded(seed=2)
    s = native.compute_voxel_stats_host_sorted(pts, counts, XB, YB, ZB,
                                               crop=crop, per_point=True)
    got = native.per_point_stats_table(*s[:5], XB, YB, ZB)
    want = jax_native.per_point_stats_table(*s[:5], XB, YB, ZB)
    _equal((got,), (want,))
    _equal((got,), (s[6],))  # the library's own per-point rows


@pytest.mark.parametrize("crop", [False, True])
def test_voxel_stats_loader_matches_jax(tmp_path, crop):
    paths = _grid_scans(tmp_path, seed=6, sizes=(420, 1000, 0))
    got = native.load_scan_batch_voxel_stats(paths, "kitti", XB, YB, ZB,
                                             max_points=512, crop=crop)
    want = jax_native.load_scan_batch_voxel_stats(paths, "kitti", XB, YB, ZB,
                                                  max_points=512, crop=crop)
    _equal(got, want)
    raw, counts = native.load_scan_batch(paths, "kitti", 2048)
    _equal(got, native.compute_voxel_stats_host(raw, counts, XB, YB, ZB,
                                                crop=crop, max_points=512))


# ------------------------------------------------------------------ KITTI
def test_kitti_split_matches_jax(tmp_path):
    written = _kitti_layout(tmp_path, seqs=("08", "09"), n=12)
    for kw in (dict(which="val", skip_frames=1),
               dict(sequences=("09",), skip_frames=2, query_fraction=0.3,
                    seed=3)):
        got = kitti.generate_split(str(tmp_path), **kw)
        want = jax_kitti.generate_split(str(tmp_path), **kw)
        assert got.db_files == want.db_files and got.q_files == want.q_files
        for name in ("db_poses", "q_poses", "utm_db", "utm_q"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))
        assert (got.pos_dist_thr, got.nontriv_pos_dist) == (
            want.pos_dist_thr, want.nontriv_pos_dist)
    # the velodyne poses come back through Tr within 1e-12
    got = kitti.generate_split(str(tmp_path), which="val", skip_frames=1)
    frame = {f: int(os.path.basename(f)[:6]) for f in got.db_files}
    seq = {f: f.split(os.sep)[-3] for f in got.db_files}
    for f, pose in zip(got.db_files, got.db_poses):
        np.testing.assert_allclose(pose, written[seq[f]][frame[f]],
                                   atol=1e-12)
    assert len(got.db_files) + len(got.q_files) == 24
    assert len(got.q_files) == int(24 * 0.2)


def test_kitti_load_split_scans_matches_jax(tmp_path):
    _kitti_layout(tmp_path, n=10)
    split = kitti.generate_split(str(tmp_path), sequences=("08",),
                                 skip_frames=1, query_fraction=0.2, seed=0)
    got = kitti.load_split_scans(split, max_points=96, num_threads=2)
    want = jax_kitti.load_split_scans(split, max_points=96)
    for name in ("db_inputs", "q_inputs", "db_masks", "q_masks", "utm_db",
                 "utm_q", "db_poses", "q_poses"):
        _equal((getattr(got, name),), (getattr(want, name),))
    assert got.num_db == 8 and got.num_q == 2
    np.testing.assert_array_equal(
        got.q_inputs[0, :64], readers.read_kitti_bin(split.q_files[0])[:64])


def test_split_index_save_load_across_packages(tmp_path):
    _kitti_layout(tmp_path)
    split = kitti.generate_split(str(tmp_path), sequences=("08",),
                                 skip_frames=1)
    for save, load in ((split.save, jax_kitti.SplitIndex.load),
                       (jax_kitti.generate_split(
                           str(tmp_path), sequences=("08",),
                           skip_frames=1).save, kitti.SplitIndex.load)):
        path = str(tmp_path / "split.npz")
        save(path)
        back = load(path)
        assert back.db_files == split.db_files
        assert back.q_files == split.q_files
        for name in ("db_poses", "q_poses", "utm_db", "utm_q"):
            np.testing.assert_array_equal(getattr(back, name),
                                          getattr(split, name))
        assert back.pos_dist_thr == 20.0 and back.nontriv_pos_dist == 10.0


def test_audit_sequence_overlap_matches_jax():
    r = np.random.RandomState(0)
    seqs = {"00": r.rand(50, 2) * 100.0,
            "01": r.rand(50, 2) * 100.0 + [500.0, 0.0],
            "07": r.rand(50, 2) * 100.0 + [0.0, 500.0],
            "08": r.rand(50, 2) * 100.0 + [60.0, 560.0]}
    touch = {"a": np.array([[0.0, 0.0], [1.0, 1.0]]),
             "b": np.array([[1.0, 1.0], [2.0, 2.0]])}
    for s in (seqs, touch):
        assert kitti.audit_sequence_overlap(s) == \
            jax_kitti.audit_sequence_overlap(s)
    assert kitti.audit_sequence_overlap(seqs) == [("07", "08")]
    with pytest.raises(ValueError):
        kitti.audit_sequence_overlap({"empty": np.zeros((0, 2))})


# ------------------------------------------------------- NCLT, nuScenes
def test_nclt_split_matches_jax(tmp_path):
    root = tmp_path / "nclt"
    sess = "2013-04-05"
    vel = root / sess / "velodyne_sync"
    vel.mkdir(parents=True)
    n, ts0 = 20, 1365177000000000
    for i in range(n):
        _write_nclt(str(vel / f"{ts0 + i * 100000}.bin"), 64, seed=i)
    gps = np.zeros((200, 6))
    gps[:, 0] = np.linspace(ts0 - 1e6, ts0 + n * 1e5 + 1e6, 200)
    gps[:, 3] = 0.7405 + np.linspace(0, 1e-5, 200)
    gps[:, 4] = -1.4605 + np.linspace(0, 1e-5, 200)
    gps[:, 5] = 270.0
    gps[5, 3] = np.nan  # a bad fix: its nearest scan drops out
    gps = gps[np.random.RandomState(0).permutation(200)]  # unsorted rows
    np.savetxt(str(root / sess / f"groundtruth_{sess}.csv"), gps,
               delimiter=",")
    got = nclt.generate_split(str(root), "val", skip_frames=2,
                              query_fraction=0.25)
    want = jax_nclt.generate_split(str(root), "val", skip_frames=2,
                                   query_fraction=0.25)
    assert got.db_files == want.db_files and got.q_files == want.q_files
    for name in ("db_poses", "q_poses", "utm_db", "utm_q"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    assert len(got.db_files) + len(got.q_files) == 10
    assert np.isfinite(got.utm_db).all()
    scans = native.load_scan_batch(got.db_files, "nclt", 64)
    _equal(scans, jax_native.load_scan_batch(want.db_files, "nclt", 64))


def test_nuscenes_manifest_split_matches_jax(tmp_path):
    files = np.array([f"/data/lidar_{i}.bin" for i in range(10)])
    poses = np.tile(np.eye(4), (10, 1, 1))
    poses[:, 0, 3] = np.arange(10) * 5.0
    poses[:, 1, 3] = np.arange(10) ** 1.5
    m = str(tmp_path / "manifest.npz")
    np.savez(m, files=files, poses=poses)
    for kw in (dict(query_fraction=0.3), dict(skip_frames=2, seed=4)):
        got = nuscenes.generate_split(m, **kw)
        want = jax_nuscenes.generate_split(m, **kw)
        assert got.db_files == want.db_files and got.q_files == want.q_files
        for name in ("db_poses", "q_poses", "utm_db", "utm_q"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))
    got = nuscenes.generate_split(m, query_fraction=0.3)
    assert len(got.q_files) == 3 and got.utm_db.shape == (7, 2)


def test_nuscenes_aggregate_sweeps_matches_jax(tmp_path):
    rng = np.random.RandomState(7)
    paths = []
    for i in range(3):
        s = rng.uniform(-3, 3, (40 + 10 * i, 5)).astype(np.float32)
        p = str(tmp_path / f"sweep{i}.bin")
        s.tofile(p)
        paths.append(p)
    tf = np.tile(np.eye(4), (3, 1, 1))
    for i in range(3):
        a = rng.uniform(-0.2, 0.2)
        tf[i, :2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        tf[i, :3, 3] = rng.uniform(-2, 2, 3)
    dt = np.array([0.0, 0.05, 0.1])
    for valid, max_points, min_d in (([True, True, True], 256, 1.0),
                                     ([True, False, True], 64, 0.5),
                                     ([False, False, False], 8, 1.0)):
        args = (np.array(paths), tf, dt, np.array(valid), max_points, min_d)
        _equal(nuscenes.aggregate_sweeps(*args),
               jax_nuscenes.aggregate_sweeps(*args))
    # the known case of tests/test_data.py: the close-point filter, the
    # transform, dt tagging and trimming
    s0 = np.array([[5.0, 0.0, 1.0, 0.7], [0.5, 0.5, 0.0, 0.2],
                   [0.0, 8.0, -1.0, 0.9]], np.float32)
    s1 = np.array([[1.0, 2.0, 0.0, 0.4], [0.9, -0.5, 0.0, 0.1]], np.float32)
    known = []
    for i, s in enumerate((s0, s1)):
        p = str(tmp_path / f"known{i}.bin")
        np.concatenate([s, np.zeros((len(s), 1), np.float32)], 1).tofile(p)
        known.append(p)
    tf2 = np.stack([np.eye(4), np.eye(4)])
    tf2[1, 0, 3] = 2.0
    pts, mask = nuscenes.aggregate_sweeps(
        np.array(known), tf2, np.array([0.0, 0.05]), np.array([True, True]),
        max_points=8)
    assert mask.sum() == 3
    np.testing.assert_allclose(pts[2], [3.0, 2.0, 0.0, 0.4, 0.05], atol=1e-6)


def test_nuscenes_sweep_fields_feed_aggregate_sweeps(tmp_path):
    n, nsweeps = 4, 3
    m = str(tmp_path / "manifest_ms.npz")
    np.savez(m, files=np.array([f"/data/lidar_{i}.bin" for i in range(n)]),
             poses=np.tile(np.eye(4), (n, 1, 1)),
             sweep_files=np.array([[f"/data/sw_{i}_{s}.bin"
                                    for s in range(nsweeps)]
                                   for i in range(n)]),
             sweep_tf=np.tile(np.eye(4), (n, nsweeps, 1, 1)),
             sweep_dt=np.tile(np.arange(nsweeps) * 0.05, (n, 1)),
             sweep_valid=np.ones((n, nsweeps), bool))
    d = np.load(m, allow_pickle=False)
    calls = {"port": [], "jax": []}

    def reader(who):
        def read(path):
            calls[who].append(path)
            return np.array([[3.0, 3.0, 0.0, 0.5, 0.0]], np.float32)
        return read

    args = (d["sweep_files"][1], d["sweep_tf"][1], d["sweep_dt"][1],
            d["sweep_valid"][1], 8)
    got = nuscenes.aggregate_sweeps(*args, read_fn=reader("port"))
    want = jax_nuscenes.aggregate_sweeps(*args, read_fn=reader("jax"))
    _equal(got, want)
    assert calls["port"] == calls["jax"] == [f"/data/sw_1_{s}.bin"
                                             for s in range(nsweeps)]
    np.testing.assert_allclose(got[0][:3, 4], [0.0, 0.05, 0.10], atol=1e-6)


def test_nuscenes_build_manifest_needs_the_devkit(tmp_path, monkeypatch):
    """Without the devkit both packages raise the same ImportError."""
    monkeypatch.setitem(sys.modules, "nuscenes", None)
    for mod in (nuscenes, jax_nuscenes):
        with pytest.raises(ImportError, match="nuscenes-devkit"):
            mod.build_manifest(str(tmp_path), str(tmp_path / "m.npz"))
