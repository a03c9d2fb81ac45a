"""The device-sorted extraction, ``GlobalLocalizer(device_sort=True)``, in
the port against the JAX package's, on the CPU (K1 runs its plain version;
JAX its cumsum segment sums), fp32 with TF32 off.

``ops/voxelize.py::device_pillar_sort_stats`` against ``jax.vmap`` of
JAX's: the order, ids, starts and raw counts bit-equal; centroids within
``CENTROID_TOL`` m (JAX takes its segment sums as differences of one fp32
cumsum over the scan, the port per segment). The localizer: descriptors
against JAX's sorted extraction within the bound tests/test_torch_pipeline
.py holds the port's two paths to JAX (atol 2e-4 / rtol 2e-3), and against
the port's own scatter path within 2e-5, the bound JAX holds its two paths
to (tests/test_pipeline.py::test_device_sort_extraction_matches_scatter).
Every entry point that extracts takes the sorted branch, and K2 does not
run on it."""

import inspect
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from gloc3d_tpu.config import VoxelConfig
from gloc3d_tpu.models import build_model as jax_build_model
from gloc3d_tpu.ops.voxelize import device_pillar_sort_stats as jax_sort
from gloc3d_tpu.ops.voxelize import segment_sum_sorted as jax_segment_sum
from gloc3d_tpu.pipeline import GlobalLocalizer as JaxLocalizer
from gloc3d_tpu_torch import pipeline as port_pipeline
from gloc3d_tpu_torch.convert import flax_to_state_dict
from gloc3d_tpu_torch.data.dataset import TripletDataset
from gloc3d_tpu_torch.eval import evaluator
from gloc3d_tpu_torch.kernels import bin_sums, segment_sum
from gloc3d_tpu_torch.models.descriptor import build_model
from gloc3d_tpu_torch.ops.voxelize import (
    device_pillar_sort_stats, segment_sum_sorted,
)
from gloc3d_tpu_torch.pipeline import GlobalLocalizer
from test_pipeline import scan_at
from test_pipeline_ground import tilted_scan
from test_torch_i2i import _JaxDraws
from test_torch_pipeline import CFG, DB_POSES, N_PTS, QUERIES, _scans
from test_torch_threads import _two_threads  # noqa: F401

VC = VoxelConfig(max_points=N_PTS)
BOUNDS = (VC.xbound, VC.ybound, VC.zbound)
CENTROID_TOL = 1e-4  # m; JAX's cumsum walk, ~σ√N·eps (the port: 1e-6)
DESC_TOL = dict(atol=2e-4, rtol=2e-3)
SCATTER_TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _fp32():
    b = torch.backends
    tf32 = b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    yield
    b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = tf32


# ------------------------------------------------------------ sort + stats
def _scan(x, y, yaw, keep=None, n=N_PTS, seed=0):
    """A (N, 4) scan of tests/test_pipeline.py's world with intensities,
    its rows past ``keep`` turned into padding."""
    pts, mask = scan_at(x, y, yaw, n=n)
    pts[:, 3] = np.random.RandomState(seed).uniform(0, 1, n)
    if keep is not None:
        mask[keep:] = 0.0
    return pts, mask


def _padding():
    pts, mask = _scan(3, -5, 0.7, keep=700)
    return pts[None], mask[None], BOUNDS


def _batch_of_three():
    scans = [_scan(3, -5, 0.7, keep=1900, seed=1),
             _scan(-20, 10, 2.0, keep=1200, seed=2),
             _scan(25, 5, 1.2, keep=300, seed=3)]
    return (np.stack([s[0] for s in scans]), np.stack([s[1] for s in scans]),
            BOUNDS)


def _all_in_pillar_zero():
    """Every real row in the first cell, the rest padding (which aliases
    there too)."""
    rng = np.random.RandomState(3)
    pts = np.zeros((1, N_PTS, 4), np.float32)
    pts[0, :, 0] = rng.uniform(-35.0, -34.51, N_PTS)
    pts[0, :, 1] = rng.uniform(-20.0, -19.51, N_PTS)
    pts[0, :, 2] = rng.uniform(-3.0, 3.0, N_PTS)
    mask = (rng.rand(1, N_PTS) < 0.8).astype(np.float32)
    return pts, mask, BOUNDS


def _out_of_grid():
    """Rows beyond each face of the grid (id 0), and rows just below the
    low faces, which truncate toward zero into the first cells."""
    pts, mask = _scan(-20, 10, 2.0)
    rng = np.random.RandomState(4)
    far = rng.choice(N_PTS, 600, replace=False)
    pts[far[:100], 0] = 60.0
    pts[far[100:200], 1] = -25.0
    pts[far[200:300], 2] = 12.0
    pts[far[300:400], 2] = -11.0
    pts[far[400:500], 0] = -35.3   # (x + 35) / 0.5 = -0.6 → 0
    pts[far[500:], 1] = -20.2
    mask[far] = 1.0
    return pts[None], mask[None], BOUNDS


def _fallback():
    """N = 65 536 on a 0.25 m x/y grid: V << 16 = 2.9e9 does not fit the
    packed key, so both sides take the stable argsort of the ids."""
    rng = np.random.RandomState(5)
    n = 65536
    pts = np.concatenate([rng.uniform(-36, 36, (1, n, 1)),
                          rng.uniform(-21, 21, (1, n, 1)),
                          rng.uniform(-3, 3, (1, n, 1)),
                          rng.uniform(0, 1, (1, n, 1))], -1).astype(np.float32)
    mask = (rng.rand(1, n) < 0.9).astype(np.float32)
    bounds = ((-35.0, 35.0, 0.25), (-20.0, 20.0, 0.25), VC.zbound)
    v = 280 * 160
    assert v << (n - 1).bit_length() >= 2**31
    return pts, mask, bounds


@pytest.mark.parametrize("case", [_padding, _batch_of_three,
                                  _all_in_pillar_zero, _out_of_grid,
                                  _fallback])
def test_sort_stats_match_jax(case):
    pts, mask, bounds = case()
    want = jax.jit(jax.vmap(lambda p, m: jax_sort(p, m, *bounds)))(
        jnp.asarray(pts), jnp.asarray(mask))
    got = device_pillar_sort_stats(torch.from_numpy(pts),
                                   torch.from_numpy(mask), *bounds)
    names = ("points", "valid", "ids", "starts", "raw_counts")
    for name, g, w in zip(names, got[:5], want[:5]):
        assert g.dtype == getattr(torch, str(w.dtype)), name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_allclose(got[5].numpy(), np.asarray(want[5]), rtol=0,
                               atol=CENTROID_TOL)
    # the centroids against float64 sums of the sorted rows
    ps, counts = got[0].double(), got[4].double()
    exact = torch.zeros(got[5].shape, dtype=torch.float64)
    exact.scatter_add_(1, got[2].long()[..., None].expand(-1, -1, 3),
                       ps[..., :3])
    exact /= counts.clamp_min(1.0)[..., None]
    np.testing.assert_allclose(got[5].numpy(), exact.numpy(), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("c", [3, 64])
def test_segment_sum_sorted_matches_jax(c):
    """The port's ``segment_sum_sorted`` (K1's op; an odd C is padded for
    the launch) against JAX's cumsum form, and against float64 sums."""
    rng = np.random.RandomState(c)
    n, v = 3000, 500
    ids = np.sort(rng.randint(0, v, n)).astype(np.int32)
    starts = np.searchsorted(ids, np.arange(v + 1), "left").astype(np.int32)
    x = rng.randn(n, c).astype(np.float32)
    got = segment_sum_sorted(torch.from_numpy(x), torch.from_numpy(starts))
    want = jax.jit(jax_segment_sum)(jnp.asarray(x), jnp.asarray(starts))
    exact = np.zeros((v, c))
    np.add.at(exact, ids, x.astype(np.float64))
    assert got.shape == (v, c)
    np.testing.assert_allclose(got.numpy(), exact, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


# ------------------------------------------------------------ localizers
@pytest.fixture(scope="module")
def weights():
    pts, mask = _scans(DB_POSES[:1])
    model = jax_build_model(CFG.model, CFG.voxel)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(pts),
                                 jnp.asarray(mask))
    port = build_model(CFG.model, CFG.voxel)
    port.load_state_dict(flax_to_state_dict(params))
    return model, params, port.eval()


def test_extract_matches_jax_and_the_scatter_path(weights):
    model, params, port_model = weights
    pts, mask = _scans(QUERIES[:3] + DB_POSES[:1])
    ref = JaxLocalizer(CFG, model, params, device_sort=True)
    port = GlobalLocalizer(CFG, port_model, device="cpu", device_sort=True)
    scatter = GlobalLocalizer(CFG, port_model, device="cpu")
    assert ref.device_sort and port.device_sort and not scatter.device_sort
    d_j, bev_j, _ = ref.extract(pts, mask)
    d_t, bev_t, g_t = port.extract(pts, mask)
    d_s, bev_s, _ = scatter.extract(pts, mask)
    assert g_t is None
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), **DESC_TOL)
    np.testing.assert_allclose(d_t.numpy(), d_s.numpy(), **SCATTER_TOL)
    np.testing.assert_array_equal(bev_t.image.numpy(), np.asarray(bev_j.image))
    np.testing.assert_array_equal(bev_t.image.numpy(), bev_s.image.numpy())


ALIGNED_DB = [(-30, -30, 0.0), (0, -30, 0.4), (30, 0, 1.5)]
ALIGNED_TILTS = [(0.02, -0.01), (-0.015, 0.02), (0.01, 0.015)]


def _xyzi(pts, mask):
    return np.concatenate([pts, np.zeros_like(pts[:, :1])], 1), mask


def test_aligned_matches_jax_with_replayed_draws(weights, monkeypatch):
    """align_ground=True: the sort runs on the aligned rows, the BEV on the
    unsorted ones; the port replays JAX's ground draws. Keyframes: ground
    frames, BEV images and descriptors."""
    model, params, port_model = weights
    cfg = CFG.replace(ground=CFG.ground.replace(num_candidates=1024,
                                                ransac_iters=128))
    scans = [_xyzi(*tilted_scan(*p, roll=r, pitch=pi, n=N_PTS, seed=10 + i))
             for i, (p, (r, pi)) in enumerate(zip(ALIGNED_DB,
                                                  ALIGNED_TILTS))]
    pts = np.stack([s[0] for s in scans])
    mask = np.stack([s[1] for s in scans])
    ref = JaxLocalizer(cfg, model, params, align_ground=True, seed=4,
                       device_sort=True)
    port = GlobalLocalizer(cfg, port_model, device="cpu", align_ground=True,
                           device_sort=True)
    _JaxDraws(4).attach(port, monkeypatch)
    ref.add_keyframes(pts, mask)
    port.add_keyframes(pts, mask)
    for a, b in zip(port.keyframes, ref.keyframes):
        np.testing.assert_allclose(a.ground.rotation,
                                   np.asarray(b.ground.rotation), atol=1e-4)
        np.testing.assert_array_equal(a.image, b.image)
    np.testing.assert_allclose(port.bank.data.numpy(),
                               np.asarray(ref.bank.data), **DESC_TOL)


# ------------------------------------------------------------ entry points
@pytest.fixture()
def counted(monkeypatch):
    """Calls of the sorted branch, of K1 and of K2 (their plain versions,
    which the ops run on the CPU) during a test."""
    calls = {"sort": 0, "K1": 0, "K2": 0}

    def counting(key, fn):
        def wrapped(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(port_pipeline, "device_pillar_sort_stats", counting(
        "sort", port_pipeline.device_pillar_sort_stats))
    monkeypatch.setattr(segment_sum, "segment_sum_sorted_plain", counting(
        "K1", segment_sum.segment_sum_sorted_plain))
    monkeypatch.setattr(bin_sums, "pillar_bin_sums_plain", counting(
        "K2", bin_sums.pillar_bin_sums_plain))
    return calls


@pytest.fixture(scope="module")
def sorted_map(weights):
    """A device_sort map of DB_POSES with the device keyframe store."""
    _, _, port_model = weights
    loc = GlobalLocalizer(CFG, port_model, device="cpu", device_sort=True,
                          device_keyframes=True)
    loc.add_keyframes(*_scans(DB_POSES))
    return loc


def _evaluate(loc):
    db, q = _scans(DB_POSES[:3]), _scans(QUERIES[:2])
    ds = TripletDataset(db_inputs=db[0], q_inputs=q[0],
                        utm_db=np.array(DB_POSES[:3], float)[:, :2],
                        utm_q=np.array(QUERIES[:2], float)[:, :2],
                        db_masks=db[1], q_masks=q[1])
    fresh = GlobalLocalizer(CFG, loc.model, device="cpu", device_sort=True)
    report = evaluator.evaluate_split(fresh, ds, batch=2)
    assert set(report.recognition_recall) >= {1}


def _shard_extraction(loc):
    fresh = GlobalLocalizer(CFG, loc.model, device="cpu", device_sort=True)
    dist.init_process_group("gloo", world_size=1, rank=0,
                            init_method=f"file://{tempfile.mkdtemp()}/store")
    try:
        fresh.shard_extraction()
        fresh.add_keyframes(*_scans(DB_POSES[:2]))
    finally:
        dist.destroy_process_group()
    assert len(fresh.keyframes) == 2


ENTRY_POINTS = {
    "extract": lambda loc: loc.extract(*_scans(QUERIES[:2])),
    "add_keyframes": lambda loc: GlobalLocalizer(
        CFG, loc.model, device="cpu", device_sort=True).add_keyframes(
            *_scans(DB_POSES[:2])),
    "detect": lambda loc: loc.detect(*_scans(QUERIES[:2])),
    "locate": lambda loc: loc.locate(*scan_at(*QUERIES[1], n=N_PTS)),
    "locate_batch": lambda loc: loc.locate_batch(*_scans(QUERIES[:2])),
    "locate_fused": lambda loc: loc.locate_fused(
        *scan_at(*QUERIES[1], n=N_PTS)),
    "evaluate_split": _evaluate,
    "shard_extraction": _shard_extraction,
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_take_the_sorted_branch(sorted_map, counted, entry):
    ENTRY_POINTS[entry](sorted_map)
    assert counted["sort"] >= 1 and counted["K2"] == 0, counted
    # two K1 sums an extraction: the statistics and the feature mean
    assert counted["K1"] == 2 * counted["sort"], counted


def test_located_query_matches_the_scatter_map(sorted_map, weights):
    scatter = GlobalLocalizer(CFG, weights[2], device="cpu")
    scatter.add_keyframes(*_scans(DB_POSES))
    np.testing.assert_allclose(sorted_map.bank.data.numpy(),
                               scatter.bank.data.numpy(), **SCATTER_TOL)
    for q in QUERIES[1:3]:
        got, want = sorted_map.locate(*scan_at(*q, n=N_PTS)), \
            scatter.locate(*scan_at(*q, n=N_PTS))
        assert got.success == want.success and got.db_index == want.db_index
        np.testing.assert_array_equal(got.candidates, want.candidates)


# ------------------------------------------------------------ guards
def test_host_stats_wins(weights, counted):
    _, _, port_model = weights
    both = GlobalLocalizer(CFG, port_model, device="cpu", host_stats=True,
                           device_sort=True)
    host = GlobalLocalizer(CFG, port_model, device="cpu", host_stats=True)
    pts, mask = _scans(QUERIES[:2])
    d_both, _, _ = both.extract(pts, mask)
    d_host, _, _ = host.extract(pts, mask)
    assert counted["sort"] == 0 and counted["K2"] == 0
    assert torch.equal(d_both, d_host)


def _image_encoder():
    from gloc3d_tpu_torch.config import PipelineConfig
    cfg = PipelineConfig.i2i()
    cfg = cfg.replace(model=cfg.model.replace(encoder="alexnet"))
    return cfg, build_model(cfg.model, cfg.voxel)


def _exported(weights):
    from gloc3d_tpu_torch.export import (
        ExportedDescriptorModel, export_descriptor_model,
    )
    pts, mask = _scans(DB_POSES[:1])
    blob = export_descriptor_model(weights[2], torch.from_numpy(pts),
                                   torch.from_numpy(mask))
    return CFG, ExportedDescriptorModel(blob, "cpu")


@pytest.mark.parametrize("kind", ["image encoder", "exported model"])
def test_device_sort_dropped_where_jax_drops_it(weights, kind):
    cfg, model = (_image_encoder() if kind == "image encoder"
                  else _exported(weights))
    loc = GlobalLocalizer(cfg, model, device="cpu", device_sort=True)
    assert loc.device_sort is False


def test_every_jax_option_constructs():
    """Every keyword of JAX's GlobalLocalizer is one of the port's, and
    none is refused (host_mirror=False needs device_keyframes, in both)."""
    jax_kw = [k for k in inspect.signature(JaxLocalizer.__init__).parameters
              if k not in ("self", "cfg", "model", "params")]
    port_kw = inspect.signature(GlobalLocalizer.__init__).parameters
    assert set(jax_kw) <= set(port_kw)
    model = build_model(CFG.model, CFG.voxel)
    flags = {k: True for k in jax_kw
             if isinstance(port_kw[k].default, bool)}
    flags["host_mirror"] = False
    loc = GlobalLocalizer(CFG, model, device="cpu", **flags)
    assert loc.device_sort and loc.host_stats and loc.align_ground
