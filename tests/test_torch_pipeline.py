"""The located-query slice as a whole: the JAX GlobalLocalizer and the port,
built from the same bridged weights, with the same keyframes and queries,
on the host-stats path and on the all-device path (host_stats=False).

Equal: top-k ids, success, db_index and BEV images. Within tolerance:
descriptors (atol 2e-4 / rtol 2e-3, the bound tests/test_pipeline_hoststats
.py holds between two JAX paths) and the pose (1e-3 m, 1e-3 rad)."""

import inspect
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gloc3d_tpu.config import (
    BEVConfig, IndexConfig, MatchConfig, ModelConfig, PipelineConfig,
    VoxelConfig,
)
from gloc3d_tpu.eval.registration import compose_6dof as jax_compose
from gloc3d_tpu.models import build_model as jax_build_model
from gloc3d_tpu.pipeline import GlobalLocalizer as JaxLocalizer
from gloc3d_tpu_torch import config as port_config
from gloc3d_tpu_torch.convert import flax_to_state_dict
from gloc3d_tpu_torch.eval.registration import compose_6dof
from gloc3d_tpu_torch.models.descriptor import build_model
from gloc3d_tpu_torch.pipeline import GlobalLocalizer
from test_pipeline import scan_at
from test_torch_threads import _two_threads  # noqa: F401


N_PTS = 2048
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = PipelineConfig(
    bev=BEVConfig(image_size=128, max_points=N_PTS),
    voxel=VoxelConfig(max_points=N_PTS),
    model=ModelConfig(encoder="pointpillar", encoder_dim=128,
                      compute_dtype="float32"),
    index=IndexConfig(dim=128, top_k=3, capacity=4),
    match=MatchConfig(image_size=128, min_score=0.1, min_overlap_pixels=16),
)
DB_POSES = [(-30, -30, 0.0), (25, 5, 1.2), (0, 0, 0.0), (5, 0, -0.3),
            (-10, 10, -1.5), (30, 30, 2.9)]
QUERIES = [(25, 5, 1.2), (3, -2, 0.35), (-12, 8, -2.0), (27, 4, 1.4),
           (60, -60, 0.0)]


def _scans(poses):
    scans = [scan_at(*p, n=N_PTS) for p in poses]
    return np.stack([s[0] for s in scans]), np.stack([s[1] for s in scans])


@pytest.fixture(scope="module")
def localizers():
    pts, mask = _scans(DB_POSES)
    model = jax_build_model(CFG.model, CFG.voxel)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.asarray(pts[:1]), jnp.asarray(mask[:1]))
    ref = JaxLocalizer(CFG, model, params, host_stats=True)
    port = GlobalLocalizer(CFG, build_model(CFG.model, CFG.voxel),
                           flax_to_state_dict(params), host_stats=True,
                           device="cpu")
    # two batches: the port's bank grows past its capacity of 4
    for sl in (slice(0, 4), slice(4, None)):
        ref.add_keyframes(pts[sl], mask[sl])
        port.add_keyframes(pts[sl], mask[sl])
    return ref, port


def test_keyframes_and_descriptors_match(localizers):
    ref, port = localizers
    assert len(port.keyframes) == len(ref.keyframes) == len(DB_POSES)
    for a, b in zip(port.keyframes, ref.keyframes):
        np.testing.assert_array_equal(a.image, b.image)
        np.testing.assert_array_equal(a.origin_xy, b.origin_xy)
    np.testing.assert_allclose(port.bank.data.numpy(),
                               np.asarray(ref.bank.data), atol=2e-4,
                               rtol=2e-3)


def test_detect_topk_ids_match(localizers):
    ref, port = localizers
    pts, mask = _scans(QUERIES)
    d_t, i_t, bev_t, _ = port.detect(pts, mask)
    d_j, i_j, bev_j, _ = ref.detect(pts, mask)
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_allclose(d_t, d_j, atol=1e-3, rtol=2e-3)
    np.testing.assert_array_equal(bev_t.image, np.asarray(bev_j.image))


@pytest.mark.parametrize("q_pose", QUERIES)
def test_locate_matches_jax(localizers, q_pose):
    ref, port = localizers
    pts, mask = scan_at(*q_pose, n=N_PTS)
    got = port.locate(pts, mask)
    want = ref.locate(pts, mask)
    assert got.success == want.success
    assert got.db_index == want.db_index
    np.testing.assert_array_equal(got.candidates, want.candidates)
    assert got.match_score == pytest.approx(want.match_score, abs=1e-3)
    if want.success:
        np.testing.assert_allclose(got.pose.translation,
                                   np.asarray(want.pose.translation),
                                   atol=1e-3)
        dyaw = np.angle(np.exp(1j * (got.match_xy_yaw[2]
                                     - np.asarray(want.match_xy_yaw)[2])))
        assert abs(dyaw) < 1e-3
        np.testing.assert_allclose(got.pose.rotation,
                                   np.asarray(want.pose.rotation), atol=1e-3)


def test_compose_6dof_matches_jax():
    for xy_yaw in ([1.0, -2.0, 0.3], [0.0, 0.0, -3.1], [5.5, 2.0, 1.7]):
        got = compose_6dof(torch.tensor(xy_yaw))
        want = jax_compose(jnp.asarray(xy_yaw, jnp.float32))
        np.testing.assert_allclose(got.rotation.numpy(),
                                   np.asarray(want.rotation), atol=1e-6)
        np.testing.assert_allclose(got.translation.numpy(),
                                   np.asarray(want.translation), atol=1e-6)


@pytest.mark.parametrize("kwargs,cfg_change,item", [
    (dict(device_sort=True), None, "TPU workarounds"),
    ({}, dict(index=IndexConfig(dim=128, backend="ivf")), "item 16"),
])
def test_unported_options_raise(kwargs, cfg_change, item):
    model = build_model(CFG.model, CFG.voxel)
    cfg = CFG.replace(**cfg_change) if cfg_change else CFG
    with pytest.raises(NotImplementedError, match=item):
        loc = GlobalLocalizer(cfg, model, device="cpu", **kwargs)
        loc.bank.shard(None)  # the IVF bank builds; its sharding waits


def test_host_stats_default_matches_jax():
    def default(cls):
        return inspect.signature(cls.__init__).parameters["host_stats"].default
    assert default(GlobalLocalizer) is default(JaxLocalizer) is False
    loc = GlobalLocalizer(CFG, build_model(CFG.model, CFG.voxel),
                          device="cpu")
    assert loc.host_stats is False


@pytest.fixture(scope="module")
def device_localizers(localizers):
    """The JAX default (all-device) extraction and the port's
    host_stats=False, from the same weights."""
    ref, port = localizers
    jax_dev = JaxLocalizer(CFG, ref.model, ref.params)
    port_dev = GlobalLocalizer(CFG, port.model, host_stats=False,
                               device="cpu")
    return jax_dev, port_dev


def test_all_device_extract_matches_jax(device_localizers):
    jax_dev, port_dev = device_localizers
    pts, mask = _scans(QUERIES[:3] + DB_POSES[:1])
    d_j, bev_j, g_j = jax_dev.extract(pts, mask)
    d_t, bev_t, g_t = port_dev.extract(pts, mask)
    assert g_j is None and g_t is None
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=2e-4,
                               rtol=2e-3)
    np.testing.assert_array_equal(bev_t.image.numpy(), np.asarray(bev_j.image))
    np.testing.assert_array_equal(bev_t.origin_xy.numpy(),
                                  np.asarray(bev_j.origin_xy))
    np.testing.assert_array_equal(bev_t.num_occupied.numpy(),
                                  np.asarray(bev_j.num_occupied))


def test_all_device_locate_matches_jax(device_localizers):
    jax_dev, port_dev = device_localizers
    pts, mask = _scans(DB_POSES)
    for loc in (jax_dev, port_dev):
        if not loc.keyframes:
            loc.add_keyframes(pts, mask)
    for a, b in zip(port_dev.keyframes, jax_dev.keyframes):
        np.testing.assert_array_equal(a.image, b.image)
    q_pts, q_mask = scan_at(*QUERIES[1], n=N_PTS)
    got = port_dev.locate(q_pts, q_mask)
    want = jax_dev.locate(q_pts, q_mask)
    assert got.success == want.success and got.db_index == want.db_index
    np.testing.assert_array_equal(got.candidates, want.candidates)
    np.testing.assert_allclose(got.pose.translation,
                               np.asarray(want.pose.translation), atol=1e-3)


def test_shared_config_round_trips_through_json():
    """The port's config resolves its string annotations (the bank loader
    depends on it) and reads the JAX package's JSON."""
    cfg = port_config.PipelineConfig.from_json(CFG.to_json())
    assert cfg.to_json() == CFG.to_json()
    assert isinstance(cfg.match, port_config.MatchConfig)
    assert cfg.voxel.grid_size == (140, 80, 1)


def test_port_runs_without_jax():
    """Import the port and run CPU located queries (host stats, all-device
    binning, evaluate_split over a KITTI layout read from disk, a fused
    query from the device keyframe store with the fm
    matcher preset, located and fused queries on the int8 flat bank and
    the IVF index with int8 cells, ``locate`` with the ICP polish and
    ``match_keyframe``, an i2i fused query on a 64² BEV image, and a
    sweep's BEV matched into a two-sweep submap), a training epoch on
    each path, an i2i train step under the freeze mask and a pose train
    step with jax, flax and the JAX package blocked: the port never
    needs JAX, and no module it loads and no shared library it maps lies
    under gloc3d_tpu/ or native/."""
    script = textwrap.dedent("""
        import os
        import sys
        sys.modules["jax"] = None
        sys.modules["flax"] = None
        sys.modules["gloc3d_tpu"] = None
        import numpy as np
        import torch
        import gloc3d_tpu_torch as g

        cfg = g.PipelineConfig(
            bev=g.BEVConfig(image_size=128, max_points=2048),
            voxel=g.VoxelConfig(max_points=2048),
            model=g.ModelConfig(compute_dtype="float32"),
            index=g.IndexConfig(top_k=2, capacity=4),
            match=g.MatchConfig(image_size=128, min_score=0.1,
                                min_overlap_pixels=16))
        rng = np.random.RandomState(0)
        walls = []
        for _ in range(40):
            x0, y0 = rng.uniform(-40, 40, 2)
            ang, ts = rng.uniform(0, np.pi), rng.uniform(0, 10, 200)
            walls.append(np.stack([x0 + np.cos(ang) * ts,
                                   y0 + np.sin(ang) * ts,
                                   rng.uniform(0, 3, 200)], 1))
        world = np.concatenate(walls).astype(np.float32)

        def scan(x, y):
            p = world[np.linalg.norm(world[:, :2] - [x, y], axis=1) < 35]
            out = np.zeros((2048, 4), np.float32)
            m = min(len(p), 2048)
            out[:m, :3] = p[:m] - [x, y, 0]
            mask = np.zeros(2048, np.float32)
            mask[:m] = 1
            return out, mask

        model = g.init_params(g.build_model(cfg.model, cfg.voxel), seed=0)
        kf = [scan(0, 0), scan(20, 5)]
        for host_stats in (True, False):
            loc = g.GlobalLocalizer(cfg, model, host_stats=host_stats,
                                    device="cpu")
            loc.add_keyframes(np.stack([k[0] for k in kf]),
                              np.stack([k[1] for k in kf]))
            res = loc.locate(*scan(20, 5))
            assert res.success and res.db_index == 1, res
            assert np.abs(res.pose.translation).max() < 1e-3, res.pose

        # the evaluation surface from disk: a KITTI odometry layout, its
        # split, the native loader and evaluate_split (with its dumps)
        import tempfile
        from gloc3d_tpu_torch import eval as port_eval  # noqa: F401
        from gloc3d_tpu_torch.data import (  # noqa: F401
            kitti, nclt, nuscenes, valset, viz)
        from gloc3d_tpu_torch.eval import evaluator
        with tempfile.TemporaryDirectory() as root:
            velo = os.path.join(root, "sequences", "08", "velodyne")
            os.makedirs(velo)
            os.makedirs(os.path.join(root, "poses"))
            rows = []
            for i, (x, y) in enumerate([(0, 0), (20, 5), (0, 1), (20, 6),
                                        (10, 0)]):
                p, m = scan(x, y)
                p[m > 0].tofile(os.path.join(velo, f"{i:06d}.bin"))
                t = np.eye(4)
                t[:2, 3] = x, y
                rows.append(t[:3].reshape(-1))
            np.savetxt(os.path.join(root, "poses", "08.txt"), np.stack(rows))
            with open(os.path.join(root, "sequences", "08", "calib.txt"),
                      "w") as f:
                f.write("Tr: " + " ".join(["1 0 0 0 0 1 0 0 0 0 1 0"]))
            split = kitti.generate_split(root, sequences=("08",),
                                         skip_frames=1, query_fraction=0.4)
            ds = kitti.load_split_scans(split, max_points=2048)
            eloc = g.GlobalLocalizer(cfg, model, host_stats=True,
                                     device="cpu")
            rep = evaluator.evaluate_split(
                eloc, ds, out_dir=os.path.join(root, "eval"), batch=2,
                n_values=(1,))
            assert rep.registration["num_total"] == 2, rep
            assert os.path.exists(os.path.join(root, "eval",
                                               "eval_report.json"))

        # the serving path: the device store without a host mirror
        loc = g.GlobalLocalizer(cfg.fast_match(fm=True), model,
                                device="cpu", device_keyframes=True,
                                host_mirror=False)
        loc.add_keyframes(np.stack([k[0] for k in kf]),
                          np.stack([k[1] for k in kf]))
        res = loc.locate_fused(*scan(20, 5))
        assert res.success and res.db_index == 1, res

        # the map-scale banks: the int8 flat bank, IVF with int8 cells
        for index in (cfg.index.replace(quantize="int8"),
                      cfg.index.replace(backend="ivf", quantize="int8",
                                        ivf_num_cells=2, ivf_nprobe=2,
                                        ivf_cell_capacity=4,
                                        ivf_train_sample=16)):
            mloc = g.GlobalLocalizer(cfg.replace(index=index), model,
                                     device="cpu", device_keyframes=True,
                                     host_mirror=False)
            mloc.add_keyframes(np.stack([k[0] for k in kf]),
                               np.stack([k[1] for k in kf]))
            for call in (mloc.locate, mloc.locate_fused):
                res = call(*scan(20, 5))
                assert res.success and res.db_index == 1, res

        # the refinement stage: the ICP polish in locate, and
        # match_keyframe (the SLAM verify step) on the device store
        rcfg = cfg.replace(match=cfg.match.replace(
            refine_icp=True, refine_icp_points=256, refine_icp_iters=3))
        rloc = g.GlobalLocalizer(rcfg, model, device="cpu",
                                 device_keyframes=True)
        rloc.add_keyframes(np.stack([k[0] for k in kf]),
                           np.stack([k[1] for k in kf]))
        assert rloc.keyframes[1].cloud.shape == (256, 4)
        res = rloc.locate(*scan(20, 5))
        assert res.success and res.db_index == 1, res
        res = rloc.match_keyframe(*scan(20, 5), db_index=1)
        assert res.success and res.candidates.tolist() == [1], res
        assert np.abs(res.pose.translation).max() < 0.05, res.pose

        # the i2i serving path: VGG16 + NetVLAD-FC on 64² BEV images
        icfg = g.PipelineConfig.i2i().replace(
            bev=g.BEVConfig(image_size=64, max_points=2048, resolution=0.5),
            match=g.MatchConfig(image_size=64, min_score=0.1,
                                min_overlap_pixels=16))
        icfg = icfg.replace(
            model=icfg.model.replace(compute_dtype="float32"),
            index=icfg.index.replace(top_k=2, capacity=4))
        iloc = g.GlobalLocalizer(
            icfg, g.init_params(g.build_model(icfg.model, icfg.voxel)),
            device="cpu", device_keyframes=True, host_mirror=False)
        _, bev, _ = iloc.extract(np.stack([k[0] for k in kf]),
                                 np.stack([k[1] for k in kf]))
        images = bev.image[..., None].repeat(1, 1, 1, 3).numpy()
        iloc.add_keyframes(images, origins=bev.origin_xy.numpy())
        res = iloc.locate_fused(images[1], origin=bev.origin_xy[1].numpy())
        assert res.success and res.db_index == 1, res

        # the submap matcher: two sweeps into a dual-grid submap, its BEV
        # as a probability grid, the first sweep's own BEV matched into it
        from gloc3d_tpu_torch.ops import occupancy, scan_match
        scfg = g.BEVConfig(image_size=128, z_min=-2.0, z_max=4.0)
        sub = occupancy.Submap3D.create(scfg, extent_xy=20.0, device="cpu")
        for x, y in ((0, 0), (1, 0)):
            p, m = scan(x, y)
            p[:, 0] += x
            sub = sub.insert(torch.from_numpy(p[:, :3]),
                             torch.from_numpy(m), cfg=scfg)
        img, org = sub.project(scfg)
        grid = occupancy.ProbabilityGrid2D.from_bev_image(img, org, 0.2)
        one = occupancy.Submap3D.create(scfg, extent_xy=20.0, device="cpu")
        qimg, qorg = one.insert(torch.from_numpy(scan(0, 0)[0][:, :3]),
                                torch.from_numpy(scan(0, 0)[1]),
                                cfg=scfg).project(scfg)
        pts, valid = occupancy.grid_to_points(
            (qimg < 0.5).float(), qorg, 0.2, max_points=512)
        sres = scan_match.match_full_submap(grid, pts, valid,
                                            num_rotations=16)
        assert sres.certified and float(sres.score) > 0.5, sres
        assert float(sres.pose.abs().max()) < 1e-6, sres

        # one training epoch on each path (small grid, 3 clouds per step)
        import tempfile
        from gloc3d_tpu_torch import config
        from gloc3d_tpu_torch.data import dataset
        from gloc3d_tpu_torch.train import Trainer, init_vlad_from_data
        tcfg = cfg.replace(
            voxel=g.VoxelConfig(max_points=2048, xbound=(-10.0, 10.0, 0.5),
                                ybound=(-6.0, 6.0, 0.5)),
            train=config.TrainConfig(batch_size=1, n_neg=1, n_neg_sample=4,
                                     margin=100.0))
        sites = [(0, 0), (30, 0), (60, 0), (0, 30)]
        db = [scan(x, y) for x, y in sites]
        ds = dataset.TripletDataset(
            db_inputs=np.stack([d[0] for d in db]),
            q_inputs=np.stack([scan(1, 0)[0], scan(31, 0)[0]]),
            utm_db=np.array(sites, float), utm_q=np.array([(1, 0), (31, 0)],
                                                          float),
            db_masks=np.stack([d[1] for d in db]),
            q_masks=np.stack([scan(1, 0)[1], scan(31, 0)[1]]))
        for host_stats in (False, True):
            c = tcfg.replace(train=tcfg.train.replace(host_stats=host_stats))
            tmodel = g.init_params(g.build_model(c.model, c.voxel), seed=0)
            init_vlad_from_data(c, tmodel, ds.db_inputs, ds.db_masks,
                                num_images=2, per_image=20)
            with tempfile.TemporaryDirectory() as workdir:
                tr = Trainer(c, tmodel, ds, workdir, device="cpu")
                assert np.isfinite(tr.train_epoch(1)) and tr.step == 2

        # one i2i train step (VGG16 on 64² images, the reference's freeze
        # mask) and one pose step (the pose model on the small grid)
        from gloc3d_tpu_torch.models.encoders import train_mask
        from gloc3d_tpu_torch.train import pose
        rng = np.random.RandomState(1)
        ids = dataset.TripletDataset(
            db_inputs=rng.rand(4, 64, 64, 3).astype(np.float32),
            q_inputs=rng.rand(2, 64, 64, 3).astype(np.float32),
            utm_db=np.array(sites, float),
            utm_q=np.array([(1, 0), (31, 0)], float))
        itcfg = icfg.replace(train=tcfg.train)
        imodel = g.init_params(g.build_model(itcfg.model, itcfg.voxel))
        with tempfile.TemporaryDirectory() as workdir:
            tr = Trainer(itcfg, imodel, ids, workdir, device="cpu",
                         trainable_mask=train_mask(imodel, "vgg16"))
            frozen = imodel.encoder[0].weight.detach().clone()
            loss = tr.train_step(ids.q_inputs[:1], None, ids.db_inputs[:1],
                                 None, ids.db_inputs[2:3], None,
                                 np.ones((1, 1), np.float32),
                                 np.ones(1, np.float32))
            assert np.isfinite(float(loss)) and tr.step == 1
            assert torch.equal(imodel.encoder[0].weight, frozen)
        st = pose.init_pose_state(pose.make_pose_model(tcfg), device="cpu")
        pb = [torch.from_numpy(np.stack([d[i] for d in db[:2]]))
              for i in (0, 1)]
        loss = pose.pose_train_step(st, (pb[0], pb[1], pb[0], pb[1]),
                                    np.zeros((2, 6), np.float32))
        assert np.isfinite(float(loss))
        assert "jax" not in {m.split(".")[0] for m in sys.modules
                             if sys.modules[m] is not None}
        repo = os.getcwd()
        banned = tuple(os.path.join(repo, d) + os.sep
                       for d in ("gloc3d_tpu", "native"))
        files = [getattr(m, "__file__", None) for m in list(
            sys.modules.values()) if m is not None]
        bad = [f for f in files if f and os.path.abspath(f).startswith(
            banned)]
        assert not bad, bad
        with open("/proc/self/maps") as f:
            maps = [ln.split()[-1] for ln in f if "/" in ln]
        assert any("libscanloader" in m for m in maps), "no host-pass library"
        bad = [m for m in maps if m.startswith(banned)]
        assert not bad, bad
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")
