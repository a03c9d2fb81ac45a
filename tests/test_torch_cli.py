"""The port's command line (``gloc3d_tpu_torch/cli.py``) against the JAX
package's (``gloc3d_tpu/cli.py``) on tests/test_cli.py's synthetic KITTI
odometry tree and small config.

Both CLIs run in-process; the port's with ``--device cpu``. Weights are
shared through one checkpoint file that both read: the JAX model's
``model.init`` (PRNGKey(1), NetVLAD centroids drawn small so that the
descriptors are not all nearly equal) written as the path-encoded
``.npz`` (``params/...``, ``batch_stats/...``), and for the i2i model the
VGGVLAD ``.npz``. Held equal: split arrays and valset files
(byte-identical text), ``stats`` JSON, preprocessed images and origins,
``bank.npz`` rows (fp32, atol 1e-5: sums in another order), query, serve
and eval JSON (success equal, keyframe and candidates at the same places,
see ``same_result``; translations and errors within 1e-3),
``match-submap`` poses within one cell and one angular step. ``cluster`` and ``train`` draw from the port's generator,
which cannot replay JAX's keys: they are held to the port's own API called
with the same generator, and to JAX only on the files, keys and shapes.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gloc3d_tpu.cli import main as jax_main
from gloc3d_tpu.config import PipelineConfig as JaxConfig
from gloc3d_tpu.models import build_model as jax_build_model
from gloc3d_tpu_torch import cli
from gloc3d_tpu_torch.config import (
    BEVConfig, IndexConfig, MatchConfig, ModelConfig, PipelineConfig,
    VoxelConfig,
)
from test_cli import N_PTS, kitti_root, small_config  # noqa: F401
from test_torch_threads import _two_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XY_TOL = 1e-3       # metres / radians between the two CLIs' results
BANK_TOL = 1e-5     # descriptor rows, fp32 sums in another order


def run(main, *argv):
    """Run one CLI call in-process → its stdout lines (asserting rc 0)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main([str(a) for a in argv])
    assert rc == 0, (argv, buf.getvalue())
    return buf.getvalue().strip().splitlines()


def port(*argv):
    return run(cli.main, *argv)


def last_json(lines):
    return json.loads(lines[-1])


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def _small_centroids(flat, key, seed):
    rng = np.random.RandomState(seed)
    flat[key] = (0.1 * rng.randn(*flat[key].shape)).astype(np.float32)


@pytest.fixture(scope="module")
def ckpt(small_config, tmp_path_factory):  # noqa: F811
    """JAX's model.init as the path-encoded .npz both CLIs read."""
    cfg = JaxConfig.from_json(open(small_config).read())
    model = jax_build_model(cfg.model, cfg.voxel)
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, N_PTS, 4)),
        jnp.zeros((1, N_PTS)))
    flat = _flatten(jax.tree.map(np.asarray, dict(variables)))
    _small_centroids(flat, "params/pool/centroids", 1)
    path = str(tmp_path_factory.mktemp("ckpt") / "pointpillar.npz")
    np.savez(path, **flat)
    return path


@pytest.fixture(scope="module")
def maps(kitti_root, small_config, ckpt, tmp_path_factory):  # noqa: F811
    """The val split (from each CLI) and an index built by each CLI from
    the shared checkpoint."""
    d = tmp_path_factory.mktemp("maps")
    out = {}
    for name, main in (("jax", jax_main), ("port", cli.main)):
        split = str(d / f"split_{name}.npz")
        run(main, "gen-split", "--root", kitti_root, "--which", "val",
            "--skip-frames", "1", "--query-fraction", "0.34",
            "--out", split, "--valset-txt", str(d / f"valset_{name}"))
        idx = str(d / f"index_{name}")
        dev = ("--device", "cpu") if name == "port" else ()
        run(main, "build-index", "--split", split, "--out", idx,
            "--config", small_config, "--batch", "4", "--checkpoint", ckpt,
            *dev)
        out[name] = {"split": split, "index": idx,
                     "valset": str(d / f"valset_{name}")}
    from gloc3d_tpu_torch.data.kitti import SplitIndex

    out["split"] = SplitIndex.load(out["port"]["split"])
    out["dir"] = d
    return out


def same_result(got, want, places=None):
    """Two results agree: success, keyframe and candidates, and the pose
    within XY_TOL. With ``places`` (each keyframe's position), keyframes
    are compared by place: the tree's sequences 08 and 09 scan the same
    world from the same poses, so keyframe pairs of one place differ only
    in their random intensities and sit at near-equal descriptor
    distances, which fp32 sums in another order may swap."""
    assert got["success"] == want["success"], (got, want)

    def where(i):
        return i if places is None or i < 0 else tuple(places[i])

    assert where(got["db_index"]) == where(want["db_index"]), (got, want)
    assert [where(c) for c in got["candidates"]] == [
        where(c) for c in want["candidates"]], (got, want)
    if "translation" in want:
        np.testing.assert_allclose(got["translation"], want["translation"],
                                   atol=XY_TOL)
        np.testing.assert_allclose(got["rotation_wxyz"],
                                   want["rotation_wxyz"], atol=XY_TOL)
    assert ("translation" in got) == ("translation" in want)


# ------------------------------------------------------------ gen-split


def test_gen_split_matches_jax(maps):
    j = np.load(maps["jax"]["split"])
    p = np.load(maps["port"]["split"])
    assert sorted(j.files) == sorted(p.files)
    for k in j.files:
        np.testing.assert_array_equal(p[k], j[k], err_msg=k)
    assert len(maps["split"].db_files) + len(maps["split"].q_files) == 12
    assert maps["split"].db_poses.shape[1:] == (4, 4)


@pytest.mark.parametrize("suffix", ["_index.txt", "_pose.txt"])
def test_cli_gen_split_valset_byte_identical(maps, suffix):
    with open(maps["port"]["valset"] + suffix, "rb") as f:
        got = f.read()
    with open(maps["jax"]["valset"] + suffix, "rb") as f:
        want = f.read()
    assert got and got == want


# ------------------------------------------------- preprocess and stats


@pytest.fixture(scope="module")
def preprocessed(kitti_root, small_config, tmp_path_factory):  # noqa: F811
    scans = os.path.join(kitti_root, "sequences", "00", "velodyne")
    d = tmp_path_factory.mktemp("prob_img")
    out = {"jax": str(d / "jax"), "port": str(d / "port")}
    run(jax_main, "preprocess", "--scans", scans, "--out", out["jax"],
        "--config", small_config, "--batch", "4")
    port("preprocess", "--scans", scans, "--out", out["port"],
         "--config", small_config, "--batch", "4", "--device", "cpu")
    out["scans"] = scans
    return out


def test_preprocess_and_stats_match_jax(preprocessed, small_config):  # noqa: F811
    files = sorted(f for f in os.listdir(preprocessed["port"])
                   if f.endswith(".npz"))
    assert files == sorted(f for f in os.listdir(preprocessed["jax"])
                           if f.endswith(".npz"))
    assert len(files) == 6
    for f in files:
        got = np.load(os.path.join(preprocessed["port"], f))
        want = np.load(os.path.join(preprocessed["jax"], f))
        assert got["image"].dtype == np.uint8
        assert got["image"].shape == (128, 128)
        np.testing.assert_array_equal(got["image"], want["image"])
        np.testing.assert_allclose(got["origin_xy"], want["origin_xy"],
                                   atol=1e-6)
        assert float(got["resolution"]) == float(want["resolution"])
    got = last_json(port("stats", "--images", preprocessed["port"]))
    want = last_json(run(jax_main, "stats", "--images", preprocessed["jax"]))
    assert got == want
    assert 0.5 < got["mean"] <= 1.0  # mostly free space


def test_preprocess_equals_batch_scan_to_bev(preprocessed, small_config):  # noqa: F811
    from gloc3d_tpu_torch.data.native import load_scan_batch, masks_from_counts
    from gloc3d_tpu_torch.ops.bev import batch_scan_to_bev

    cfg = PipelineConfig.from_json(open(small_config).read())
    files = sorted(os.path.join(preprocessed["scans"], f)
                   for f in os.listdir(preprocessed["scans"]))
    pts, counts = load_scan_batch(files, "kitti", cfg.bev.max_points)
    masks = masks_from_counts(counts, cfg.bev.max_points)
    bev = batch_scan_to_bev(torch.from_numpy(pts[..., :3].copy()),
                            torch.from_numpy(masks), cfg.bev)
    for i, f in enumerate(files):
        stem = os.path.splitext(os.path.basename(f))[0]
        got = np.load(os.path.join(preprocessed["port"], stem + ".npz"))
        np.testing.assert_array_equal(
            got["image"], (bev.image[i] * 255.0).numpy().astype(np.uint8))
        np.testing.assert_array_equal(got["origin_xy"],
                                      bev.origin_xy[i].numpy())


def test_preprocess_nclt_format_matches_jax(tmp_path, small_config):  # noqa: F811
    """The --fmt nclt dispatch: packed uint16 scans."""
    scans = tmp_path / "nclt_scans"
    scans.mkdir()
    rng = np.random.RandomState(0)
    for i in range(2):
        n = 1500
        xyz = rng.uniform(-20, 20, (n, 3))
        xyz[:, 2] = rng.uniform(0, 3, n)
        rec = np.zeros((n, 8), np.uint8)
        u16 = ((xyz + 100.0) / 0.005).astype("<u2")
        rec[:, :6] = u16.view(np.uint8).reshape(n, 6)
        rec[:, 6] = rng.randint(0, 255, n)
        rec.tofile(str(scans / f"{i:06d}.bin"))
    out = {k: str(tmp_path / k) for k in ("jax", "port")}
    run(jax_main, "preprocess", "--scans", scans, "--out", out["jax"],
        "--config", small_config, "--fmt", "nclt", "--batch", "2")
    port("preprocess", "--scans", scans, "--out", out["port"],
         "--config", small_config, "--fmt", "nclt", "--batch", "2",
         "--device", "cpu")
    for f in ("000000.npz", "000001.npz"):
        got = np.load(os.path.join(out["port"], f))["image"]
        np.testing.assert_array_equal(
            got, np.load(os.path.join(out["jax"], f))["image"])
        assert (got == 0).sum() > 0  # some occupied pixels decoded


# --------------------------------------------------------- match-submap


@pytest.mark.parametrize("query", ["npz", "raw scan"])
def test_match_submap_matches_jax(preprocessed, small_config, query):  # noqa: F811
    """Scan i sits at world x = 10·i, so placing scan 0 in scan 1's grid is
    (−10, 0, 0): both CLIs recover it, within one cell and one angular
    step of each other."""
    q = (os.path.join(preprocessed["port"], "000000.npz") if query == "npz"
         else os.path.join(preprocessed["scans"], "000000.bin"))
    args = ("match-submap", "--grid",
            os.path.join(preprocessed["port"], "000001.npz"), "--scan", q,
            "--config", small_config, "--rotations", "64",
            "--budget", "1024")
    got = last_json(port(*args, "--device", "cpu"))
    want = last_json(run(jax_main, *args))
    cell = PipelineConfig.from_json(open(small_config).read()).bev.resolution
    step = 2 * np.pi / 64
    x, y, yaw = got["pose_xy_yaw"]
    assert abs(x + 10.0) < 0.5 and abs(y) < 0.5, got
    assert abs(yaw) < 2 * step, got
    assert got["score"] > 0.3
    assert abs(x - want["pose_xy_yaw"][0]) <= cell + 1e-6
    assert abs(y - want["pose_xy_yaw"][1]) <= cell + 1e-6
    assert abs(yaw - want["pose_xy_yaw"][2]) <= step + 1e-6
    assert set(got) == set(want)
    assert got["fallback_policy"] == "full"


# ------------------------------------------------ build-index and query


def test_build_index_matches_jax(maps):
    for f in ("bank.npz", "keyframes.npz", "config.json"):
        assert os.path.exists(os.path.join(maps["port"]["index"], f))
    got = np.load(os.path.join(maps["port"]["index"], "bank.npz"))
    want = np.load(os.path.join(maps["jax"]["index"], "bank.npz"))
    n = len(maps["split"].db_files)
    g_rows, w_rows = got["bank"], want["bank"]
    assert g_rows.shape == w_rows.shape == (n, 128)
    np.testing.assert_allclose(g_rows, w_rows, atol=BANK_TOL)
    gk = np.load(os.path.join(maps["port"]["index"], "keyframes.npz"))
    wk = np.load(os.path.join(maps["jax"]["index"], "keyframes.npz"))
    np.testing.assert_array_equal(gk["images"], wk["images"])


@pytest.fixture(scope="module")
def queries(maps, small_config, ckpt):  # noqa: F811
    """The JAX CLI's query JSON for two db scans and a query scan."""
    scans = maps["split"].db_files[:2] + maps["split"].q_files[:1]
    return scans, [last_json(run(
        jax_main, "query", "--index", maps["jax"]["index"], "--scan", s,
        "--config", small_config, "--checkpoint", ckpt)) for s in scans]


@pytest.mark.parametrize("which", ["port index", "jax index"])
def test_query_matches_jax(maps, queries, small_config, ckpt, which):  # noqa: F811
    """The port's query on its own index and on the index the JAX CLI
    built = JAX's query."""
    idx = maps["port" if which == "port index" else "jax"]["index"]
    scans, want = queries
    for s, w in zip(scans, want):
        got = last_json(port("query", "--index", idx, "--scan", s,
                             "--config", small_config, "--checkpoint", ckpt,
                             "--device", "cpu"))
        same_result(got, w, maps["split"].utm_db)
    assert want[0]["success"] and want[0]["db_index"] == 0


def test_query_from_export_and_dump_match(maps, queries, small_config,  # noqa: F811
                                          ckpt, tmp_path):
    """The serving hand-off: export the model (same checkpoint) with
    torch.export, then locate a query THROUGH the program (no model build)
    and dump the registration overlay."""
    blob = str(tmp_path / "model.pt2")
    line = port("export", "--out", blob, "--config", small_config,
                "--checkpoint", ckpt, "--device", "cpu")[-1]
    assert line.startswith(f"wrote {blob}")
    png = str(tmp_path / "match.png")
    scans, want = queries
    got = last_json(port("query", "--index", maps["port"]["index"],
                         "--scan", scans[0], "--config", small_config,
                         "--from-export", blob, "--dump-match", png,
                         "--device", "cpu"))
    same_result(got, want[0], maps["split"].utm_db)
    assert got["success"] and got["db_index"] == 0
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        return
    assert plt.imread(png).shape[:2] == (128, 128)


def test_from_export_refuses_host_stats(maps, small_config, ckpt,  # noqa: F811
                                        tmp_path):
    blob = str(tmp_path / "model.pt2")
    port("export", "--out", blob, "--config", small_config, "--device",
         "cpu")
    with pytest.raises(SystemExit, match="host-stats"):
        port("query", "--index", maps["port"]["index"], "--scan",
             maps["split"].q_files[0], "--from-export", blob,
             "--host-stats", "--device", "cpu")


def test_build_index_no_host_mirror(maps, queries, small_config, ckpt,  # noqa: F811
                                    tmp_path):
    """--no-host-mirror --host-stats: the index keeps its images only in
    the device store; the written map is loadable and its query equals
    JAX's on the mirrored index."""
    idx = str(tmp_path / "index_nm")
    port("build-index", "--split", maps["port"]["split"], "--out", idx,
         "--config", small_config, "--batch", "4", "--no-host-mirror",
         "--host-stats", "--checkpoint", ckpt, "--device", "cpu")
    assert os.path.exists(os.path.join(idx, "keyframes.npz"))
    scans, want = queries
    got = last_json(port("query", "--index", idx, "--scan", scans[0],
                         "--config", small_config, "--device-keyframes",
                         "--checkpoint", ckpt, "--device", "cpu"))
    same_result(got, want[0], maps["split"].utm_db)


def test_serve_streams_results_match_jax(maps, queries, small_config,  # noqa: F811
                                         ckpt, monkeypatch):
    """serve: the index loads once, scan paths stream on stdin, one JSON
    result per line = each scan's query JSON; a missing file gives an
    error line and the stream goes on."""
    scans, want = queries
    stdin = "\n".join([scans[1], "", "/nonexistent/scan.bin", scans[2]])
    lines = {}
    for name, main, dev in (("jax", jax_main, ()),
                            ("port", cli.main, ("--device", "cpu"))):
        monkeypatch.setattr("sys.stdin", io.StringIO(stdin + "\n"))
        lines[name] = [json.loads(ln) for ln in run(
            main, "serve", "--index", maps[name]["index"], "--config",
            small_config, "--device-keyframes", "--checkpoint", ckpt, *dev)]
    got, ref = lines["port"], lines["jax"]
    assert got[0] == ref[0]
    assert got[0]["ready"] is True and got[0]["fused"] is True
    assert len(got) == 4
    for g, w, r in ((got[1], want[1], ref[1]), (got[3], want[2], ref[3])):
        same_result(g, w, maps["split"].utm_db)
        same_result(g, r, maps["split"].utm_db)
    assert got[1]["scan"] == scans[1]
    assert got[2]["success"] is False and "error" in got[2]
    assert got[2]["scan"] == "/nonexistent/scan.bin"
    assert ref[2]["success"] is False and "error" in ref[2]


# ---------------------------------------------------------------- eval


def test_eval_registration_matches_jax(maps, small_config, ckpt, tmp_path):  # noqa: F811
    """eval --registration (the global_localization binary flow): the
    port's report = JAX's on the same checkpoint."""
    reps = {}
    for name, main, dev in (("jax", jax_main, ()),
                            ("port", cli.main, ("--device", "cpu"))):
        wd = str(tmp_path / name)
        reps[name] = json.loads("\n".join(run(
            main, "eval", "--split", maps[name]["split"], "--config",
            small_config, "--registration", "--workdir", wd, "--batch", "4",
            "--checkpoint", ckpt, *dev)))
        assert os.path.exists(os.path.join(wd, "eval_report.json"))
        assert os.path.exists(os.path.join(wd, "failed_detect_indices.txt"))
    got, want = reps["port"], reps["jax"]
    assert set(got) == set(want)
    assert got["recognition_recall"] == want["recognition_recall"]
    assert got["registration"]["num_total"] == 4
    for key, value in want["registration"].items():
        assert got["registration"][key] == pytest.approx(value, abs=XY_TOL)
    for key in ("failed_detect_indices", "failed_registration_indices",
                "banded_success"):
        assert got[key] == want[key], key


def test_eval_registration_takes_host_stats(maps, small_config, ckpt,  # noqa: F811
                                            monkeypatch):
    """eval --registration --host-stats evaluates a host-stats localizer
    on the card's default or the given device, with the checkpoint's
    weights (the card smoke's [cli] step 11 runs it end to end)."""
    from gloc3d_tpu_torch.convert import restore_params
    from gloc3d_tpu_torch.eval import evaluator
    from gloc3d_tpu_torch.models.descriptor import build_model, init_params

    seen = {}

    class Report:
        def to_json(self):
            return "{}"

    def fake(loc, ds, out_dir=None, batch=8):
        seen.update(loc=loc, ds=ds, batch=batch)
        return Report()

    monkeypatch.setattr(evaluator, "evaluate_split", fake)
    port("eval", "--split", maps["port"]["split"], "--config", small_config,
         "--registration", "--host-stats", "--batch", "4", "--checkpoint",
         ckpt, "--device", "cpu")
    loc = seen["loc"]
    assert loc.host_stats and not loc.align_ground
    assert loc.device == torch.device("cpu") and seen["batch"] == 4
    assert seen["ds"].num_db == len(maps["split"].db_files)
    cfg = PipelineConfig.from_json(open(small_config).read())
    want = restore_params(init_params(build_model(cfg.model, cfg.voxel)),
                          ckpt).state_dict()
    for k, v in loc.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_eval_recall_matches_jax(maps, small_config, ckpt):  # noqa: F811
    """eval without --registration: recall@N of the trainer's cache."""
    got = last_json(port("eval", "--split", maps["port"]["split"],
                         "--config", small_config, "--checkpoint", ckpt,
                         "--device", "cpu"))
    want = last_json(run(jax_main, "eval", "--split", maps["jax"]["split"],
                         "--config", small_config, "--checkpoint", ckpt))
    assert got == want


# ----------------------------------------------------- cluster and train


@pytest.fixture(scope="module")
def train_cfgs(small_config, tmp_path_factory):  # noqa: F811
    d = tmp_path_factory.mktemp("traincfg")
    c = json.loads(open(small_config).read())
    c["voxel"].update({"xbound": [-10.0, 10.0, 0.5],
                       "ybound": [-6.0, 6.0, 0.5]})
    grid = str(d / "smallgrid.json")
    open(grid, "w").write(json.dumps(c))
    c["train"].update({"batch_size": 2, "n_neg": 2, "n_neg_sample": 8,
                       "epochs": 1, "cache_refresh_rate": 4})
    train = str(d / "traincfg.json")
    open(train, "w").write(json.dumps(c))
    return grid, train


def test_cluster_equals_the_port_api(maps, train_cfgs, tmp_path):
    """cluster = init_vlad_from_data on the seeded model with the
    generator of cfg.train.seed; the file holds what JAX's holds."""
    from gloc3d_tpu_torch.data.kitti import load_split_scans
    from gloc3d_tpu_torch.models.descriptor import build_model, init_params
    from gloc3d_tpu_torch.train.cluster import init_vlad_from_data

    out = str(tmp_path / "centroids.npz")
    port("cluster", "--split", maps["port"]["split"], "--out", out,
         "--config", train_cfgs[0], "--num-images", "8", "--per-image",
         "40", "--device", "cpu")
    got = np.load(out)
    assert sorted(got.files) == ["centroids", "descriptors"]
    assert got["centroids"].shape == (64, 128)
    assert got["descriptors"].shape == (8 * 40, 128)
    cfg = PipelineConfig.from_json(open(train_cfgs[0]).read())
    ds = load_split_scans(maps["split"], cfg.voxel.max_points)
    cents, descs = init_vlad_from_data(
        cfg, init_params(build_model(cfg.model, cfg.voxel)), ds.db_inputs,
        ds.db_masks, torch.Generator().manual_seed(cfg.train.seed),
        num_images=8, per_image=40)
    np.testing.assert_array_equal(got["centroids"], cents.numpy())
    np.testing.assert_array_equal(got["descriptors"], descs.numpy())


@pytest.fixture(scope="module")
def trained(maps, train_cfgs, tmp_path_factory):
    d = tmp_path_factory.mktemp("train")
    cents = str(d / "centroids.npz")
    port("cluster", "--split", maps["port"]["split"], "--out", cents,
         "--config", train_cfgs[0], "--num-images", "8", "--per-image",
         "40", "--device", "cpu")
    wd = str(d / "run")
    out = last_json(port("train", "--split", maps["port"]["split"],
                         "--workdir", wd, "--config", train_cfgs[1],
                         "--init-centroids", cents, "--device", "cpu"))
    return wd, out, cents


def test_train_with_init_centroids(trained):
    """cluster → train --init-centroids: the JSON, the checkpoints and
    history.json in JAX's layout."""
    wd, out, _ = trained
    assert set(out) == {"best_recall5", "epochs"}
    assert out["epochs"] == 1
    for tag in ("latest", "best"):
        assert os.path.exists(os.path.join(wd, f"ckpt_{tag}.pt"))
    hist = json.load(open(os.path.join(wd, "history.json")))
    assert set(hist) == {"history", "best_recall5"}
    assert hist["best_recall5"] == out["best_recall5"]
    # both trainers write history.json before appending the epoch's entry
    assert hist["history"] == []
    assert JaxConfig.from_json(open(os.path.join(wd, "config.json")).read())


def test_train_equals_the_port_api(maps, train_cfgs, trained):
    """The CLI's epoch = Trainer.fit on the same model, centroids and
    generator: the same weights in ckpt_latest.pt."""
    from gloc3d_tpu_torch.data.kitti import load_split_scans
    from gloc3d_tpu_torch.models.descriptor import build_model, init_params
    from gloc3d_tpu_torch.models.netvlad import init_netvlad_params
    from gloc3d_tpu_torch.train.trainer import Trainer

    wd, out, cents = trained
    cfg = PipelineConfig.from_json(open(train_cfgs[1]).read())
    model = init_params(build_model(cfg.model, cfg.voxel), cfg.train.seed)
    cc = np.load(cents)
    init_netvlad_params(model.pool, cc["centroids"], cc["descriptors"])
    tr = Trainer(cfg, model, load_split_scans(maps["split"],
                                              cfg.voxel.max_points),
                 str(maps["dir"] / "api_run"), device="cpu")
    tr.fit(log=lambda s: None)
    assert tr.best_recall5 == out["best_recall5"]
    got = torch.load(os.path.join(wd, "ckpt_latest.pt"))["model"]
    for k, v in model.state_dict().items():
        assert torch.equal(got[k], v), k


def test_train_resume_on_the_host_stats_path(maps, train_cfgs, trained):
    """train --resume latest --host-stats: the step count carries on from
    the checkpoint and the host-stats step trains."""
    wd, _, cents = trained
    before = torch.load(os.path.join(wd, "ckpt_latest.pt"))
    out = last_json(port("train", "--split", maps["port"]["split"],
                         "--workdir", wd, "--config", train_cfgs[1],
                         "--init-centroids", cents, "--resume", "latest",
                         "--host-stats", "--fromscratch", "--device",
                         "cpu"))
    assert out["epochs"] == 1
    after = torch.load(os.path.join(wd, "ckpt_latest.pt"))
    assert after["step"] > before["step"]
    moved = [k for k, v in after["model"].items()
             if v.is_floating_point() and not torch.equal(
                 v, before["model"][k])]
    assert moved


# ------------------------------------------------------------------ i2i


def _i2i_config(tmp_path):
    cfg = PipelineConfig(
        bev=BEVConfig(image_size=128, max_points=N_PTS),
        voxel=VoxelConfig(max_points=N_PTS),
        model=ModelConfig(encoder="vgg16", encoder_dim=512,
                          compute_dtype="float32"),
        index=IndexConfig(dim=512, top_k=3, capacity=16),
        match=MatchConfig(image_size=128, min_score=0.1,
                          min_overlap_pixels=16),
    )
    path = str(tmp_path / "i2i.json")
    open(path, "w").write(cfg.to_json())
    return path


@pytest.fixture(scope="module")
def i2i(kitti_root, maps, tmp_path_factory):  # noqa: F811
    """The i2i config, a VGGVLAD .npz from JAX's init, and both CLIs'
    preprocessed images of the val sequences."""
    d = tmp_path_factory.mktemp("i2i")
    cfg_p = _i2i_config(d)
    cfg = JaxConfig.from_json(open(cfg_p).read())
    model = jax_build_model(cfg.model, cfg.voxel)
    params = jax.jit(model.init)(jax.random.PRNGKey(2),
                                 jnp.zeros((1, 128, 128, 3)))["params"]
    flat = {f"conv{i}_{k}": np.asarray(params["encoder"][f"conv{i}"][k])
            for i in range(13) for k in ("kernel", "bias")}
    for k in ("conv_weight", "centroids", "hidden1_weights"):
        flat[f"pool_{k}"] = np.asarray(params["pool"][k])
    _small_centroids(flat, "pool_centroids", 2)
    ck = str(d / "vggvlad.npz")
    np.savez(ck, **flat)
    imgs = {}
    for name, main, dev in (("jax", jax_main, ()),
                            ("port", cli.main, ("--device", "cpu"))):
        imgs[name] = str(d / f"prob_img_{name}")
        for seq in ("08", "09"):
            run(main, "preprocess", "--scans",
                os.path.join(kitti_root, "sequences", seq, "velodyne"),
                "--out", imgs[name], "--config", cfg_p, "--batch", "4", *dev)
    return cfg_p, ck, imgs, d


def test_eval_registration_i2i_matches_jax(maps, i2i):
    """eval --registration on the i2i (vgg16, image-input) path from
    preprocessed BEV images, on a shared VGGVLAD checkpoint."""
    cfg_p, ck, imgs, d = i2i
    reps = {}
    for name, main, dev in (("jax", jax_main, ()),
                            ("port", cli.main, ("--device", "cpu"))):
        wd = str(d / f"evalout_{name}")
        reps[name] = json.loads("\n".join(run(
            main, "eval", "--split", maps[name]["split"], "--config", cfg_p,
            "--images", imgs[name], "--registration", "--workdir", wd,
            "--batch", "4", "--checkpoint", ck, *dev)))
        assert os.path.exists(os.path.join(wd, "eval_report.json"))
    got, want = reps["port"], reps["jax"]
    assert got["registration"]["num_total"] == 4
    assert got["recognition_recall"] == want["recognition_recall"]
    assert got["failed_detect_indices"] == want["failed_detect_indices"]
    for key, value in want["registration"].items():
        assert got["registration"][key] == pytest.approx(value, abs=XY_TOL)


def test_serve_i2i_image_stream(maps, i2i, monkeypatch):
    """serve on an i2i index reads BEV prob images (npz) per line, through
    the fused image path."""
    cfg_p, ck, imgs, d = i2i
    idx = str(d / "index_i2i")
    port("build-index", "--split", maps["port"]["split"], "--out", idx,
         "--config", cfg_p, "--batch", "4", "--checkpoint", ck, "--device",
         "cpu")
    stem = os.path.splitext(os.path.basename(maps["split"].db_files[0]))[0]
    img = os.path.join(imgs["port"], stem + ".npz")
    monkeypatch.setattr("sys.stdin", io.StringIO(img + "\n"))
    lines = [json.loads(ln) for ln in port(
        "serve", "--index", idx, "--config", cfg_p, "--device-keyframes",
        "--checkpoint", ck, "--device", "cpu")]
    assert lines[0]["i2i"] is True and lines[0]["fused"] is True
    assert lines[1]["success"] is True
    assert lines[1]["db_index"] in lines[1]["candidates"]


# ------------------------------------------------------------ the rest


def test_dp_devices_raises_naming_item_16(maps, small_config, tmp_path):  # noqa: F811
    """--dp-devices beyond one rank per CPU core (or below 1) exits with a
    message naming the limit, before any rank starts; two ranks run in
    tests/test_torch_dp.py."""
    from gloc3d_tpu_torch.parallel.launch import max_ranks

    for n in (max_ranks() + 1, 0):
        with pytest.raises(SystemExit, match=f"--dp-devices {n}: .*between "
                           f"1 and {max_ranks()}"):
            port("build-index", "--config", small_config, "--split",
                 maps["port"]["split"], "--out", str(tmp_path / "dp"),
                 "--batch", "8", "--dp-devices", str(n), "--device", "cpu")
    assert not (tmp_path / "dp").exists()


def test_no_card_and_no_device_exits_nonzero(maps, small_config, monkeypatch,  # noqa: F811
                                             capsys):
    """Without a card a device-touching subcommand needs --device cpu:
    there is no quiet CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as err:
        cli.main(["query", "--index", maps["port"]["index"], "--scan",
                  maps["split"].q_files[0], "--config", small_config])
    assert err.value.code not in (0, None)
    assert "no CUDA device" in str(err.value.code)


def test_encoder_flag_selects_backbone():
    """--encoder maps to the right ModelConfig/IndexConfig (main.py --arch)."""
    import argparse

    for enc, dim in (("alexnet", 256), ("mobilenet", 320),
                     ("resnet18", 512), ("vgg16", 512)):
        cfg = cli._load_cfg(argparse.Namespace(config=None, i2i=False,
                                               encoder=enc))
        assert cfg.model.encoder == enc
        assert cfg.model.encoder_dim == dim and cfg.index.dim == dim
    for i2i_flag, enc, want in ((True, None, "vgg16"),
                                (False, "pointpillar", "pointpillar"),
                                (False, None, "pointpillar")):
        ns = argparse.Namespace(config=None, i2i=i2i_flag, encoder=enc)
        assert cli._load_cfg(ns).model.encoder == want


def test_fast_match_flag_applies_preset():
    import argparse

    base = dict(config=None, i2i=False, encoder=None)
    m = cli._load_cfg(argparse.Namespace(**base, fast_match=None)).match
    assert m.fine_downsample == 1 and m.coarse_mode == "stack"
    m = cli._load_cfg(argparse.Namespace(**base, fast_match="preset")).match
    assert (m.fine_downsample, m.coarse_rot_downsample, m.fine_top_f,
            m.fine_argmax_downsample, m.coarse_mode) == (2, 8, 4, 2, "stack")
    m = cli._load_cfg(argparse.Namespace(**base, fast_match="fm")).match
    assert m.coarse_mode == "fm"


def test_cli_subprocess_without_jax(maps, queries, small_config, ckpt):  # noqa: F811
    """`python -m gloc3d_tpu_torch.cli query` in a fresh process with jax,
    flax and the JAX package blocked gives JAX's answer."""
    script = textwrap.dedent("""
        import runpy, sys
        sys.modules["jax"] = None
        sys.modules["flax"] = None
        sys.modules["gloc3d_tpu"] = None
        sys.argv = ["gloc"] + sys.argv[1:]
        runpy.run_module("gloc3d_tpu_torch.cli", run_name="__main__")
    """)
    scans, want = queries
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-c", script, "query", "--index",
         maps["port"]["index"], "--scan", scans[2], "--config",
         small_config, "--checkpoint", ckpt, "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    same_result(json.loads(r.stdout.strip().splitlines()[-1]), want[2],
                maps["split"].utm_db)
