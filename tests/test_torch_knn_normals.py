"""The k-NN PCA normals of the ground estimate (``kernels/knn_normals.py``,
the op ``gloc3d::knn_normals``): the plain version against the lines it
replaced in ``ops/ground.py::estimate_ground_batch`` and against a numpy
selection by (distance, index); the op's fake implementation, opcheck and
``torch.export``; on a card, the CUDA kernel against the plain version.

Tolerances: the plain version equals the replaced lines bit for bit where
no two distances tie (they then select and order the same neighbours); the
kernel's normals lie within 1e-12 of the plain version's (the same
neighbours, their sums in another order: butterflies over a warp where the
plain version reduces along the axis); ground transforms are bit-equal
(a normal's 10° bin decides, not its last bits). This file imports no JAX,
so that its card tests run where JAX is not installed (``pytest
--noconftest -m cuda``)."""

import importlib.util
import math
import os

import numpy as np
import pytest
import torch

from gloc3d_tpu_torch.config import GroundConfig
from gloc3d_tpu_torch.kernels import knn_normals as kn
from gloc3d_tpu_torch.ops import ground
from test_torch_threads import _two_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = GroundConfig().knn


def _replaced_lines(pts, ok, k):
    """The k-NN PCA normals as ``estimate_ground_batch`` computed them
    before the op: ``torch.topk`` over the (B, M, M) matrix."""
    rows = torch.arange(pts.shape[0])[:, None]
    sq = torch.sum(pts * pts, -1)
    d2 = (sq[:, :, None] - 2.0 * torch.bmm(pts, pts.transpose(1, 2))
          + sq[:, None, :])
    d2 = torch.where(ok[:, None, :], d2, math.inf)
    nn = torch.topk(d2, k, dim=-1, largest=False).indices
    nbr = pts[rows[:, :, None], nn]
    c = nbr - nbr.mean(dim=2, keepdim=True)
    cov = torch.einsum("bmki,bmkj->bmij", c, c) / k
    return kn._smallest_eigvec_3x3(cov)


def _cloud(b, m, seed, valid=0.9):
    """Scan-like float64 clouds: a tilted ground disc, walls and clutter,
    from fp32 coordinates as the estimator's subsample has them, with a
    share ``valid`` of the rows valid."""
    rng = np.random.RandomState(seed)
    out = np.empty((b, m, 3))
    for i in range(b):
        n_g, n_w = m // 2, m // 3
        r, th = rng.uniform(3, 20, n_g), rng.uniform(0, 2 * np.pi, n_g)
        g = np.stack([r * np.cos(th), r * np.sin(th),
                      -1.7 + 0.02 * r * np.cos(th)], 1)
        t = rng.uniform(-10, 10, n_w)
        w = np.stack([t, np.full(n_w, 6.0) + rng.normal(0, 0.01, n_w),
                      rng.uniform(-1.7, 1.3, n_w)], 1)
        rest = rng.uniform(-20, 20, (m - n_g - n_w, 3))
        out[i] = rng.permutation(np.concatenate([g, w, rest]))
    pts = torch.from_numpy(out.astype(np.float32).astype(np.float64))
    ok = torch.from_numpy(rng.uniform(size=(b, m)) < valid)
    return pts, ok


def _d2(pts):
    sq = torch.sum(pts * pts, -1)
    return (sq[:, :, None] - 2.0 * torch.bmm(pts, pts.transpose(1, 2))
            + sq[:, None, :])


def _lexsort_knn(pts, ok, k):
    """The k nearest of every row by (distance, index), from the plain
    version's float64 distances, with numpy's stable sort."""
    d2 = torch.where(ok[:, None, :], _d2(pts), math.inf).numpy()
    return torch.from_numpy(np.argsort(d2, -1, kind="stable")[..., :k])


def _normals_of(pts, nn, k):
    rows = torch.arange(pts.shape[0])[:, None, None]
    nbr = pts[rows, nn]
    c = nbr - nbr.mean(dim=2, keepdim=True)
    return kn._smallest_eigvec_3x3(
        torch.einsum("bmki,bmkj->bmij", c, c) / k)


@pytest.mark.parametrize("b", [1, 3])
def test_plain_equals_the_replaced_lines(b):
    pts, ok = _cloud(b, 4096, seed=b)
    got = torch.ops.gloc3d.knn_normals(pts, ok, K)
    assert got.shape == (b, 4096, 3) and got.dtype == torch.float64
    assert torch.equal(got, _replaced_lines(pts, ok, K))


def _lattice():
    """A 9 x 9 grid at unit spacing, each point twice (rows 81-161 repeat
    rows 0-80), in integer coordinates: every distance is exact, so ties
    are real on every device."""
    x = torch.arange(9, dtype=torch.float64)
    grid = torch.stack(torch.meshgrid(x, x, indexing="ij"), -1).reshape(-1, 2)
    grid = torch.cat([grid, (grid[:, :1] + grid[:, 1:]) % 2], -1)
    return torch.cat([grid, grid])[None]


def _latest_first_knn(pts, ok, k):
    """The k nearest with the opposite tie rule: the latest index first."""
    d2 = torch.where(ok[:, None, :], _d2(pts), math.inf).numpy()[..., ::-1]
    return torch.from_numpy(d2.shape[-1] - 1 - np.argsort(
        d2, -1, kind="stable")[..., :k])


@pytest.mark.parametrize("k", [1, 5, 10, 32])
def test_ties_take_the_earliest_index(k):
    pts = _lattice()
    ok = torch.ones(pts.shape[:2], dtype=torch.bool)
    want = _lexsort_knn(pts, ok, k)
    assert torch.equal(kn._smallest_k(_d2(pts), k), want)
    got = torch.ops.gloc3d.knn_normals(pts, ok, k)
    np.testing.assert_array_equal(got.numpy(),
                                  _normals_of(pts, want, k).numpy())
    # the rule shows in the normals: the latest-first sets move them by
    # more than 1e-3 (the card test's lattice bound is 1e-6)
    other = _normals_of(pts, _latest_first_knn(pts, ok, k), k)
    assert float((got - other).abs().max()) > (1e-3 if k > 1 else -1.0)


def test_rows_with_fewer_than_k_valid_columns():
    """Three valid columns and k = 10: each row takes the three, then the
    earliest invalid columns."""
    pts, _ = _cloud(2, 300, seed=7)
    ok = torch.zeros(2, 300, dtype=torch.bool)
    ok[0, [5, 100, 250]] = True
    ok[1, [0, 1, 299]] = True
    want = _lexsort_knn(pts, ok, K)
    for i, valid in enumerate(([5, 100, 250], [0, 1, 299])):
        rest = [j for j in range(300) if j not in valid][:K - 3]
        assert sorted(want[i, 17, :3].tolist()) == valid
        assert want[i, 17, 3:].tolist() == rest
    np.testing.assert_array_equal(
        torch.ops.gloc3d.knn_normals(pts, ok, K).numpy(),
        _normals_of(pts, want, K).numpy())


def test_plain_selects_by_distance_then_index_on_clouds():
    pts, ok = _cloud(2, 700, seed=3, valid=0.5)
    d2 = torch.where(ok[:, None, :], _d2(pts), math.inf)
    assert torch.equal(kn._smallest_k(d2, K), _lexsort_knn(pts, ok, K))


def test_fake_shapes_and_opcheck():
    from torch._subclasses.fake_tensor import FakeTensorMode

    pts, ok = _cloud(2, 64, seed=4)
    with FakeTensorMode() as mode:
        out = torch.ops.gloc3d.knn_normals(mode.from_tensor(pts),
                                           mode.from_tensor(ok), K)
        assert out.shape == (2, 64, 3) and out.dtype == torch.float64
    torch.library.opcheck(torch.ops.gloc3d.knn_normals.default, (pts, ok, K))


def test_op_in_an_exported_graph():
    from gloc3d_tpu_torch.export import export_program

    pts, ok = _cloud(1, 200, seed=5)
    program = export_program(lambda p, o: kn.knn_normals(p, o, K), pts, ok)
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets == ["gloc3d.knn_normals.default"], targets
    assert torch.equal(program.module()(pts, ok),
                       kn.knn_normals_plain(pts, ok, K))


@pytest.mark.parametrize("change,error", [
    (lambda p, o, k: (p.float(), o, k), TypeError),
    (lambda p, o, k: (p, o.int(), k), TypeError),
    (lambda p, o, k: (p[..., :2].contiguous(), o, k), ValueError),
    (lambda p, o, k: (p, o[:, :-1], k), ValueError),
    (lambda p, o, k: (p, o, 33), ValueError),
    (lambda p, o, k: (p, o, 0), ValueError),
    (lambda p, o, k: (p[:, :8].contiguous(), o[:, :8].contiguous(), 9),
     ValueError),
    (lambda p, o, k: (p.transpose(0, 1), o.transpose(0, 1), k), ValueError),
])
def test_wrapper_check_raises_on_what_the_kernel_does_not_take(change,
                                                               error):
    pts, ok = _cloud(2, 64, seed=6)
    with pytest.raises(error):
        kn._check(*change(pts, ok, K))
    kn._check(pts, ok, 32)


def test_estimator_calls_the_op(monkeypatch):
    calls = []
    real = ground.knn_normals

    def counted(points, ok, k):
        calls.append((tuple(points.shape), k))
        return real(points, ok, k)

    monkeypatch.setattr(ground, "knn_normals", counted)
    pts, _ = _cloud(2, 5000, seed=8)
    cfg = GroundConfig(num_candidates=1024, ransac_iters=64)
    ground.estimate_ground_batch(pts.float(), torch.ones(2, 5000), cfg,
                                 torch.Generator().manual_seed(0))
    assert calls == [((2, 1024, 3), K)]


# --------------------------------------------------------------- card


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")


def _world():
    spec = importlib.util.spec_from_file_location(
        "bench_world", os.path.join(REPO, "benchmark", "lbench", "world.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _held_to_plain(pts, ok, k=K):
    got = kn.knn_normals(pts, ok, k)
    want = kn.knn_normals_plain(pts, ok, k)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert err < 1e-12, (tuple(pts.shape), k, err)
    return got


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    _cuda_or_skip()
    # (1, 4096) and (8, 4096) as the estimator runs them; a ragged M past
    # one column tile and not a multiple of a block's rows; k at its cap
    for b, m, k, seed in ((1, 4096, K, 0), (8, 4096, K, 1),
                          (3, 2500, K, 2), (2, 1031, 32, 3), (1, 40, 1, 4)):
        pts, ok = _cloud(b, m, seed)
        _held_to_plain(pts.cuda(), ok.cuda(), k)
    # the tie lattice: the same neighbours as the earliest-first rule. Its
    # duplicated points make neighbourhoods whose two smallest eigenvalues
    # nearly coincide, where the sums' order moves a normal by up to 3e-8
    # (H100); the latest-first rule moves them by more than 1e-3
    pts = _lattice().cuda()
    ok = torch.ones(pts.shape[:2], dtype=torch.bool, device="cuda")
    for k in (1, 5, 10, 32):
        got = kn.knn_normals(pts, ok, k)
        want = _normals_of(pts.cpu(), _lexsort_knn(pts.cpu(), ok.cpu(), k),
                           k)
        assert float((got.cpu() - want).abs().max()) < 1e-6, k
    pts, _ = _cloud(2, 300, seed=7)
    ok = torch.zeros(2, 300, dtype=torch.bool)
    ok[0, [5, 100, 250]] = True
    _held_to_plain(pts.cuda(), ok.cuda())


@pytest.mark.cuda
def test_cuda_kernel_same_bits_every_launch_and_in_a_graph():
    _cuda_or_skip()
    pts, ok = _cloud(8, 4096, seed=9)
    pts, ok = pts.cuda(), ok.cuda()
    first = kn.knn_normals(pts, ok, K)
    assert torch.equal(first, kn.knn_normals(pts, ok, K))
    assert torch.equal(first, kn._launch(pts, ok, K))
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kn.knn_normals(pts, ok, K)
    torch.cuda.current_stream().wait_stream(side)
    before = (kn.knn_normals.launches, kn.knn_normals.captured)
    with torch.cuda.graph(graph):
        out = kn.knn_normals(pts, ok, K)
    assert (kn.knn_normals.launches, kn.knn_normals.captured) == (
        before[0], before[1] + 1)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, first)
    assert kn.knn_normals.launches == before[0]
    kn.knn_normals(pts, ok, K)
    assert kn.knn_normals.launches == before[0] + 1


@pytest.mark.cuda
def test_cuda_ground_transforms_equal_plain():
    """``estimate_ground_batch`` on the benchmark world's tilted scans and
    on tie scans (2048 of a scan's points, each twice, so that every
    distance ties with its twin's): the kernel's transforms bit-equal to
    the plain version's, on the same draws."""
    _cuda_or_skip()
    w = _world()
    world = w.make_world(5, 300, 100.0)
    scans = [w.tilted_scan(world, (x, y, 0.3), (roll, pitch, h), 122480,
                           seed, 70.0, 40000)
             for x, y, roll, pitch, h, seed in (
                 (0.0, 0.0, 0.03, -0.02, 1.7, 1),
                 (10.0, -5.0, -0.05, 0.01, 1.9, 2),
                 (-20.0, 30.0, 0.0, 0.0, 1.6, 3))]
    pts = torch.from_numpy(np.stack([s[0][:, :3] for s in scans])).cuda()
    mask = torch.from_numpy(np.stack([s[1] for s in scans])).cuda()
    near = torch.sum(pts * pts, -1) < 20.0 ** 2
    twice = torch.zeros_like(pts)
    twice_mask = torch.zeros_like(mask)
    for i in range(pts.shape[0]):
        rows = torch.nonzero(near[i] & (mask[i] > 0))[:2048, 0]
        twice[i, :4096] = pts[i, rows].repeat(2, 1)
        twice_mask[i, :4096] = 1.0
    for p, m in ((pts, mask), (twice, twice_mask)):
        cfg = GroundConfig()
        gen = torch.Generator().manual_seed(11)
        prio, uni = ground.batch_ground_draws(p.shape[0], p.shape[1], cfg,
                                              gen)

        def run():
            return ground.estimate_ground_batch(
                p, m, cfg, priority=prio.cuda(),
                sample_triplets=ground.triplets_from(uni.cuda()))

        before = kn.knn_normals.launches
        got = run()
        assert kn.knn_normals.launches == before + 1
        real = ground.knn_normals
        ground.knn_normals = kn.knn_normals_plain
        try:
            want = run()
        finally:
            ground.knn_normals = real
        assert bool(got.valid.all())
        for g, v in zip((got.transform.rotation, got.transform.translation,
                         got.plane, got.valid, got.inlier_fraction),
                        (want.transform.rotation,
                         want.transform.translation, want.plane, want.valid,
                         want.inlier_fraction)):
            assert torch.equal(g, v)
