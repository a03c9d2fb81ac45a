"""The port's serving path against the JAX package, at S = 128 and 2048
points: the bit-packed device keyframe store (``device_keyframes``,
``host_mirror=False``), ``save`` / ``load`` across the two packages,
``locate_batch`` and ``locate_fused``, and the calls that ``locate_batch``
and an aligned ``add_keyframes`` make to the matcher and the ground
estimator (one per stage, whatever the batch).

Within one package the store, the batch and the fused query must give what
``locate`` on the host mirror gives: same success, keyframe and candidates,
and the same registration (xy_yaw within 1e-5: the same matcher on the
same images). Against the JAX package the tolerances are those of
tests/test_torch_pipeline.py::test_locate_matches_jax (pose 1e-3 m /
1e-3 rad, score 1e-3)."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gloc3d_tpu.pipeline import GlobalLocalizer as JaxLocalizer
from gloc3d_tpu.pipeline import _pack_bits as jax_pack_bits
from gloc3d_tpu_torch import pipeline
from gloc3d_tpu_torch.models.descriptor import build_model, init_params
from gloc3d_tpu_torch.pipeline import (
    GlobalLocalizer, _pack_bits, _unpack_bits,
)
from test_pipeline import scan_at
from test_pipeline_ground import CFG as ALIGNED_CFG
from test_pipeline_ground import tilted_scan
from test_torch_pipeline import (  # noqa: F401  (module fixture reuse)
    CFG, DB_POSES, N_PTS, QUERIES, _scans, localizers,
)
from test_torch_threads import _two_threads  # noqa: F401


# (25, 5, 1.2) and (3, -2, 0.35) register at their top candidate,
# (-12, 8, -2.0) at none, (60, -60, 0.0) only at its second
QUERY_SCANS = [scan_at(*p, n=N_PTS) for p in QUERIES]


def _same(got, want, xy_tol=1e-5):
    """Same success, keyframe and candidates; registration within xy_tol
    (metres and radians)."""
    assert got.success == want.success
    assert got.db_index == want.db_index
    np.testing.assert_array_equal(got.candidates, want.candidates)
    assert got.match_score == pytest.approx(want.match_score, abs=1e-3)
    if want.success:
        np.testing.assert_allclose(got.match_xy_yaw,
                                   np.asarray(want.match_xy_yaw),
                                   atol=xy_tol)
        np.testing.assert_allclose(got.pose.translation,
                                   np.asarray(want.pose.translation),
                                   atol=max(xy_tol, 1e-5))


def _built(port, **kw):
    """A port localizer with the fixture's model and keyframes, added in
    the fixture's two batches."""
    loc = GlobalLocalizer(CFG, port.model, device="cpu",
                          host_stats=kw.pop("host_stats", True), **kw)
    pts, mask = _scans(DB_POSES)
    for sl in (slice(0, 4), slice(4, None)):
        loc.add_keyframes(pts[sl], mask[sl])
    return loc


@pytest.fixture(scope="module")
def port_results(localizers):
    """The port's host-mirror ``locate`` of every query scan, the result
    the store, the batch and the fused query must reproduce."""
    return [localizers[1].locate(*q) for q in QUERY_SCANS]


@pytest.fixture(scope="module")
def stored(localizers):
    """The fixture's map in the device store, with no host mirror."""
    return _built(localizers[1], device_keyframes=True, host_mirror=False)


# ---------------------------------------------------------------- store
def _grey_images(n, s, seed=0):
    """Images with values on both sides of 0.5 and exactly at it."""
    levels = np.float32([0.0, 0.25, 0.4999, 0.5, 0.75, 1.0])
    return levels[np.random.RandomState(seed).randint(0, 6, (n, s, s))]


def test_pack_bits_match_jax():
    img = _grey_images(3, 64)
    got = _pack_bits(torch.from_numpy(img)).numpy()
    want = np.asarray(jax_pack_bits(jnp.asarray(img)))
    assert got.shape == (3, 64, 8) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_unpack_bits_gives_the_image_binarized_at_half():
    img = _grey_images(2, 32, seed=1)
    back = _unpack_bits(_pack_bits(torch.from_numpy(img))).numpy()
    np.testing.assert_array_equal(back, (img >= 0.5).astype(np.float32))
    binary = (img >= 0.5).astype(np.float32)
    np.testing.assert_array_equal(
        _unpack_bits(_pack_bits(torch.from_numpy(binary))).numpy(), binary)


def test_store_grows_past_1024_rows():
    loc = GlobalLocalizer(CFG, build_model(CFG.model, CFG.voxel),
                          device="cpu", device_keyframes=True)
    first, second = _grey_images(1000, 16, 2), _grey_images(300, 16, 3)
    loc._store_keyframes(first, np.ones((1000, 2), np.float32), offset=0)
    assert loc._kf_cap == 1024 and loc._kf_store.shape == (1024, 16, 2)
    loc._store_keyframes(second, np.full((300, 2), 2.0, np.float32),
                         offset=1000)
    assert loc._kf_cap == 2048 and loc._kf_store.shape == (2048, 16, 2)
    images = np.concatenate([first, second]) >= 0.5
    np.testing.assert_array_equal(
        _unpack_bits(loc._kf_store[:1300]).numpy(), images)
    np.testing.assert_array_equal(loc._kf_origins[:1300, 0].numpy(),
                                  [1.0] * 1000 + [2.0] * 300)


@pytest.mark.parametrize("host_mirror", [True, False])
def test_store_locate_matches_host_mirror(localizers, stored, port_results,
                                          host_mirror):
    loc = (stored if not host_mirror
           else _built(localizers[1], device_keyframes=True))
    assert loc._kf_store is not None and loc._kf_cap == 1024
    assert all((k.image is None) != host_mirror for k in loc.keyframes)
    for q, want in zip(QUERY_SCANS, port_results):
        _same(loc.locate(*q), want)


def test_host_mirror_off_needs_device_keyframes(localizers):
    ref, port = localizers
    for cls, model, kw in ((GlobalLocalizer, port.model, {"device": "cpu"}),
                           (JaxLocalizer, ref.model, {})):
        with pytest.raises(ValueError, match="device_keyframes"):
            cls(CFG, model, None, host_mirror=False, **kw)


# ---------------------------------------------------------------- persistence
def test_load_is_an_instance_method_as_in_jax():
    for cls in (GlobalLocalizer, JaxLocalizer):
        assert not isinstance(inspect.getattr_static(cls, "load"),
                              (classmethod, staticmethod))
    assert (list(inspect.signature(GlobalLocalizer.load).parameters)
            == list(inspect.signature(JaxLocalizer.load).parameters))


@pytest.mark.parametrize("host_mirror", [True, False])
def test_save_load_round_trip(localizers, stored, port_results, tmp_path,
                              host_mirror):
    port = localizers[1]
    src = port if host_mirror else stored
    src.save(str(tmp_path))
    loc = GlobalLocalizer(CFG, port.model, device="cpu", host_stats=True,
                          device_keyframes=not host_mirror,
                          host_mirror=host_mirror)
    loc.load(str(tmp_path))
    assert len(loc.keyframes) == len(src.keyframes) == len(loc.bank)
    np.testing.assert_array_equal(loc.bank.data.numpy(),
                                  src.bank.data.numpy())
    # the store reproduces the host mirror's locate (test above)
    for q, want in zip(QUERY_SCANS[:3], port_results):
        _same(loc.locate(*q), want)


def test_jax_map_loads_in_the_port(localizers, tmp_path):
    ref, port = localizers
    ref.save(str(tmp_path))
    loc = GlobalLocalizer(CFG, port.model, device="cpu", host_stats=True,
                          device_keyframes=True, host_mirror=False)
    loc.load(str(tmp_path))
    for a, b in zip(loc.keyframes, ref.keyframes):
        assert a.image is None
        np.testing.assert_array_equal(a.origin_xy, b.origin_xy)
    for q in QUERY_SCANS[:3]:
        _same(loc.locate(*q), ref.locate(*q), xy_tol=1e-3)


def test_port_map_loads_in_jax(localizers, stored, tmp_path):
    ref, port = localizers
    stored.save(str(tmp_path))
    loc = JaxLocalizer(CFG, ref.model, ref.params, host_stats=True)
    loc.load(str(tmp_path))
    for a, b in zip(loc.keyframes, port.keyframes):
        np.testing.assert_array_equal(a.image, b.image)
    for q in QUERY_SCANS[:3]:
        _same(port.locate(*q), loc.locate(*q), xy_tol=1e-3)


# ---------------------------------------------------------------- batch
def test_locate_batch_matches_locate(localizers, port_results):
    pts = np.stack([q[0] for q in QUERY_SCANS])
    masks = np.stack([q[1] for q in QUERY_SCANS])
    batch = localizers[1].locate_batch(pts, masks)
    assert len(batch) == len(QUERY_SCANS)
    for got, want in zip(batch, port_results):
        _same(got, want)


def test_locate_batch_mixed_splice_matches_jax(localizers, stored):
    """Queries whose top candidate succeeds, fails, or that fail at every
    candidate: the staged splice equals JAX's locate_batch."""
    ref, _ = localizers
    pts = np.stack([q[0] for q in QUERY_SCANS])
    masks = np.stack([q[1] for q in QUERY_SCANS])
    got = stored.locate_batch(pts, masks)
    want = ref.locate_batch(pts, masks)
    assert 0 < sum(r.success for r in want) < len(want)
    assert any(r.success and r.db_index != r.candidates[0] for r in want)
    for a, b in zip(got, want):
        _same(a, b, xy_tol=1e-3)


# ---------------------------------------------------------------- fused
@pytest.mark.parametrize("variant", [
    "host stats", "all-device", "unstaged", "aligned"])
def test_locate_fused_matches_locate(localizers, stored, variant):
    if variant == "host stats":
        loc, queries = stored, QUERY_SCANS
    elif variant == "aligned":
        loc = GlobalLocalizer(ALIGNED_CFG, init_params(build_model(
            ALIGNED_CFG.model, ALIGNED_CFG.voxel), seed=0), device="cpu",
            align_ground=True, device_keyframes=True, host_mirror=False)
        scans = [tilted_scan(x, y, yaw, roll=0.02, pitch=-0.01, seed=i)
                 for i, (x, y, yaw) in enumerate(
                     [(-30, -30, 0.0), (0, -30, 0.4), (30, 0, 1.5)])]
        loc.add_keyframes(np.stack([s[0] for s in scans]),
                          np.stack([s[1] for s in scans]))
        queries = [tilted_scan(2.5, -31.5, 0.7, roll=0.03, pitch=-0.02,
                               height=1.65, seed=99)]
    else:
        cfg = CFG.replace(match=CFG.match.replace(
            staged_first=variant != "unstaged"))
        loc = GlobalLocalizer(cfg, localizers[1].model, device="cpu",
                              device_keyframes=True, host_mirror=False)
        pts, mask = _scans(DB_POSES)
        loc.add_keyframes(pts, mask)
        queries = QUERY_SCANS
    n_success = 0
    for q in queries:
        loc._gen.manual_seed(5)  # the aligned variant: the same draws
        want = loc.locate(*q)
        loc._gen.manual_seed(5)
        got = loc.locate_fused(*q)
        _same(got, want)
        n_success += want.success
    assert n_success > 0


def test_locate_fused_matches_jax(localizers, stored):
    ref, port = localizers
    jax_loc = JaxLocalizer(CFG, ref.model, ref.params, host_stats=True,
                           device_keyframes=True, host_mirror=False)
    pts, mask = _scans(DB_POSES)
    for sl in (slice(0, 4), slice(4, None)):
        jax_loc.add_keyframes(pts[sl], mask[sl])
    for q in QUERY_SCANS[1:3] + QUERY_SCANS[-1:]:
        _same(stored.locate_fused(*q), jax_loc.locate_fused(*q),
              xy_tol=1e-3)


@pytest.mark.parametrize("case", ["no store", "refine_icp"])
def test_locate_fused_guards(localizers, stored, case):
    port = localizers[1]
    pts, mask = QUERY_SCANS[0]
    if case == "no store":
        loc, err, match = port, RuntimeError, "device_keyframes"
    else:
        loc = _built(port, device_keyframes=True)
        loc.cfg = CFG.replace(match=CFG.match.replace(refine_icp=True))
        err, match = RuntimeError, "refine_icp"
    with pytest.raises(err, match=match):
        loc.locate_fused(pts, mask)



# ---------------------------------------------------------------- calls
def _counted(monkeypatch, name):
    """Wrap the pipeline's ``name`` so each call logs its batch shape."""
    calls, fn = [], getattr(pipeline, name)

    def counted(*args, **kw):
        out = fn(*args, **kw)
        calls.append(tuple(out[0].shape[:-1]) if name == "match_bev_topk"
                     else tuple(out.valid.shape))
        return out

    monkeypatch.setattr(pipeline, name, counted)
    return calls


@pytest.mark.parametrize("case", [
    "every top candidate succeeds", "mixed splice", "unstaged"])
def test_locate_batch_makes_one_matcher_call_per_stage(
        localizers, stored, port_results, monkeypatch, case):
    """``locate_batch`` registers each stage in ONE call: stage 1 at (B, 1),
    stage 2 at (F, K) over exactly the F queries whose top candidate
    failed, or one (B, K) call unstaged; each result equals ``locate``'s,
    and the mixed splice (on the device store) JAX's ``locate_batch``."""
    ref, port = localizers
    rows = ([0, 1, 0, 1] if case == "every top candidate succeeds"
            else list(range(len(QUERY_SCANS))))
    loc = stored if case == "mixed splice" else port
    if case == "unstaged":
        monkeypatch.setattr(loc, "cfg", CFG.replace(
            match=CFG.match.replace(staged_first=False)))
    want = [port_results[i] for i in rows]
    k = CFG.index.top_k
    # no filler candidates (6 keyframes, top 3): a query failed stage 1
    # exactly when its top candidate is not its answer
    failed = sum(not (r.success and r.db_index == r.candidates[0])
                 for r in want)
    expected = {"every top candidate succeeds": [(4, 1)],
                "mixed splice": [(5, 1), (failed, k)],
                "unstaged": [(5, k)]}[case]
    assert (failed == 0) == (case == "every top candidate succeeds")
    pts = np.stack([QUERY_SCANS[i][0] for i in rows])
    masks = np.stack([QUERY_SCANS[i][1] for i in rows])
    calls = _counted(monkeypatch, "match_bev_topk")
    got = loc.locate_batch(pts, masks)
    assert calls == expected
    for a, b in zip(got, want):
        _same(a, b)
    if case == "mixed splice":
        for a, b in zip(got, ref.locate_batch(pts, masks)):
            _same(a, b, xy_tol=1e-3)


def test_aligned_add_keyframes_makes_one_estimator_call(monkeypatch):
    """An aligned ``add_keyframes`` of 4 scans estimates the ground in ONE
    call, and each keyframe gets the ground frame that one-scan
    ``estimate_ground`` calls give on the same seed, bit for bit (a map
    built one scan at a time gets the same transforms)."""
    from gloc3d_tpu_torch.ops.ground import estimate_ground

    scans = [tilted_scan(x, y, yaw, roll=0.02, pitch=-0.01, seed=i)
             for i, (x, y, yaw) in enumerate(
                 [(-30, -30, 0.0), (0, -30, 0.4), (30, 0, 1.5),
                  (2.5, -31.5, 0.7)])]
    pts = np.stack([s[0] for s in scans])
    mask = np.stack([s[1] for s in scans])
    loc = GlobalLocalizer(ALIGNED_CFG, init_params(build_model(
        ALIGNED_CFG.model, ALIGNED_CFG.voxel), seed=0), device="cpu",
        align_ground=True, seed=3)
    calls = _counted(monkeypatch, "estimate_ground_batch")
    loc.add_keyframes(pts, mask)
    assert calls == [(4,)]
    gen = torch.Generator().manual_seed(3)
    for kf, p, m in zip(loc.keyframes, pts, mask):
        one = estimate_ground(torch.from_numpy(p), torch.from_numpy(m),
                              ALIGNED_CFG.ground, gen)
        np.testing.assert_array_equal(kf.ground.rotation,
                                      one.transform.rotation.numpy())
        np.testing.assert_array_equal(kf.ground.translation,
                                      one.transform.translation.numpy())
    assert torch.equal(gen.get_state(), loc._gen.get_state())
