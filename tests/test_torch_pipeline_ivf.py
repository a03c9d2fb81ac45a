"""The located query on the map-scale banks: the int8 flat bank, the IVF
index with fp32 cells and with int8 cells, port against JAX.

torch cannot replay the JAX key that trains an IVF quantizer, so both
packages serve one shared map: JAX builds it and saves it, the port loads
it. On that map ``detect``, ``locate``, ``locate_batch`` and
``locate_fused`` give JAX's ids, and success, keyframe, candidates, score
and pose at the tolerances tests/test_torch_serving.py holds the flat path
to (pose 1e-3 m / 1e-3 rad, score 1e-3). Descriptors differ between the
packages by up to 2e-4 (tests/test_torch_pipeline.py), so distances are
held to 1e-3. A map the port builds and trains itself loads in JAX, and
at full probe the port's own IVF map ranks as its flat bank does."""

import numpy as np
import pytest

from gloc3d_tpu.config import IndexConfig
from gloc3d_tpu.pipeline import GlobalLocalizer as JaxLocalizer
from gloc3d_tpu.pipeline import _IVFBankAdapter as JaxIVFAdapter
from gloc3d_tpu_torch import config as port_config
from gloc3d_tpu_torch.pipeline import GlobalLocalizer, _IVFBankAdapter
from test_torch_pipeline import (  # noqa: F401  (module fixture reuse)
    CFG, DB_POSES, _scans, localizers,
)
from test_torch_serving import QUERY_SCANS, _same
from test_torch_threads import _two_threads  # noqa: F401


BANKS = {
    "int8": dict(quantize="int8"),
    # 4 cells, 2 probed: the narrow probe, on the shared cell layout
    "ivf": dict(backend="ivf", ivf_num_cells=4, ivf_cell_capacity=4,
                ivf_nprobe=2, ivf_train_sample=64),
    "ivf-int8": dict(backend="ivf", quantize="int8", ivf_num_cells=4,
                     ivf_cell_capacity=4, ivf_nprobe=2, ivf_train_sample=64),
}


def _cfg(kind):
    return CFG.replace(index=CFG.index.replace(**BANKS[kind]))


@pytest.fixture(scope="module", params=list(BANKS))
def shared(request, localizers, tmp_path_factory):  # noqa: F811
    """JAX's map on the bank kind, saved, and loaded by the port into a
    localizer with the device store and no host mirror."""
    ref, port = localizers
    cfg = _cfg(request.param)
    jax_loc = JaxLocalizer(cfg, ref.model, ref.params, host_stats=True,
                           device_keyframes=True)
    pts, mask = _scans(DB_POSES)
    for sl in (slice(0, 4), slice(4, None)):
        jax_loc.add_keyframes(pts[sl], mask[sl])
    out = str(tmp_path_factory.mktemp(request.param))
    jax_loc.save(out)
    loc = GlobalLocalizer(cfg, port.model, device="cpu", host_stats=True,
                          device_keyframes=True, host_mirror=False)
    loc.load(out)
    return request.param, jax_loc, loc, out


def test_map_loads_as_its_bank_kind(shared):
    kind, jax_loc, loc, _ = shared
    assert len(loc.bank) == len(jax_loc.bank) == len(DB_POSES)
    if kind == "int8":
        assert loc.bank._quantized
    else:
        assert isinstance(loc.bank, _IVFBankAdapter)
        ivf = loc.bank._ivf
        assert ivf.quantize == ("int8" if kind == "ivf-int8" else "none")
        assert ivf.nprobe == 2 and ivf._total == len(DB_POSES)
        np.testing.assert_array_equal(ivf._ids, jax_loc.bank._ivf._ids)


def test_detect_matches_jax(shared):
    _, jax_loc, loc, _ = shared
    pts = np.stack([q[0] for q in QUERY_SCANS])
    masks = np.stack([q[1] for q in QUERY_SCANS])
    d_t, i_t, _, _ = loc.detect(pts, masks)
    d_j, i_j, _, _ = jax_loc.detect(pts, masks)
    np.testing.assert_array_equal(i_t, np.asarray(i_j))
    np.testing.assert_allclose(d_t, np.asarray(d_j), atol=1e-3, rtol=2e-3)


@pytest.mark.parametrize("call", ["locate", "locate_fused"])
def test_locate_matches_jax(shared, call):
    _, jax_loc, loc, _ = shared
    n_success = 0
    for q in QUERY_SCANS:
        want = getattr(jax_loc, call)(*q)
        _same(getattr(loc, call)(*q), want, xy_tol=1e-3)
        n_success += want.success
    assert n_success > 0


def test_locate_batch_matches_jax(shared):
    _, jax_loc, loc, _ = shared
    pts = np.stack([q[0] for q in QUERY_SCANS])
    masks = np.stack([q[1] for q in QUERY_SCANS])
    for got, want in zip(loc.locate_batch(pts, masks),
                         jax_loc.locate_batch(pts, masks)):
        _same(got, want, xy_tol=1e-3)


def test_port_map_loads_in_jax(shared, localizers, tmp_path):  # noqa: F811
    """The port writes the loaded map back, grown by two keyframes; JAX
    loads it and locates as the port does."""
    kind, _, loc, src = shared
    ref = localizers[0]
    pts, mask = _scans(DB_POSES[:2])
    loc.add_keyframes(pts, mask)
    try:
        loc.save(str(tmp_path))
        back = JaxLocalizer(_cfg(kind), ref.model, ref.params,
                            host_stats=True)
        back.load(str(tmp_path))
        assert len(back.bank) == len(loc.bank) == len(DB_POSES) + 2
        for q in QUERY_SCANS[:3]:
            _same(loc.locate(*q), back.locate(*q), xy_tol=1e-3)
    finally:  # restore the shared map for the tests after this one
        loc.load(src)


def test_port_built_ivf_map_loads_in_jax(localizers, tmp_path):  # noqa: F811
    """The port trains its own quantizer (its draws, not JAX's): at full
    probe its IVF map ranks as its flat bank does, and JAX, loading the
    port's map, gives the port's results."""
    ref, port = localizers
    cfg = CFG.replace(index=CFG.index.replace(
        backend="ivf", quantize="int8", ivf_num_cells=4, ivf_cell_capacity=4,
        ivf_nprobe=4, ivf_train_sample=64))
    loc = GlobalLocalizer(cfg, port.model, device="cpu", host_stats=True)
    flat = GlobalLocalizer(CFG.replace(index=cfg.index.replace(
        backend="flat")), port.model, device="cpu", host_stats=True)
    pts, mask = _scans(DB_POSES)
    for sl in (slice(0, 4), slice(4, None)):
        loc.add_keyframes(pts[sl], mask[sl])
        flat.add_keyframes(pts[sl], mask[sl])
    assert loc.bank._ivf.centroids is None  # trains on the first query
    for q in QUERY_SCANS:
        _same(loc.locate(*q), flat.locate(*q))
    loc.save(str(tmp_path))
    back = JaxLocalizer(cfg, ref.model, ref.params, host_stats=True)
    back.load(str(tmp_path))
    np.testing.assert_array_equal(back.bank._ivf._ids, loc.bank._ivf._ids)
    for q in QUERY_SCANS[:3]:
        _same(loc.locate(*q), back.locate(*q), xy_tol=1e-3)


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_slam_exclude_recent_matches_jax(quantize):
    """tests/test_pipeline_ivf.py::test_ivf_exclude_recent on both
    adapters: at full probe the windowed search is exact, so the ids match
    although each package trains its own cells."""
    rng = np.random.RandomState(0)
    feats = rng.randn(64, 16).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    kw = dict(dim=16, top_k=5, backend="ivf", ivf_num_cells=4, ivf_nprobe=4,
              num_exclude_recent=8, quantize=quantize)
    ours = _IVFBankAdapter(port_config.IndexConfig(**kw), 16, "cpu")
    ref = JaxIVFAdapter(IndexConfig(**kw), dim=16)
    ours.add(feats)
    ref.add(feats)
    for q in (feats[3:4] + 0.01, feats[60:61] + 0.01):
        d2, idx = ours.query(q, k=5, exclude_recent=True)
        d_j, i_j = ref.query(q, k=5, exclude_recent=True)
        np.testing.assert_array_equal(idx, np.asarray(i_j))
        np.testing.assert_allclose(d2, np.asarray(d_j), rtol=1e-5,
                                   atol=1e-5)
        assert (idx[0] < 64 - 8).all()
    assert 3 in ours.query(feats[3:4] + 0.01, exclude_recent=True)[1][0]
    _, i_dev = ours.query_device(feats[60:61] + 0.01, k=5,
                                 exclude_recent=True)
    assert 60 not in i_dev[0].tolist()


def test_ivf_adapter_truncates_pending_rows_only():
    kw = dict(dim=8, backend="ivf", ivf_num_cells=2, ivf_train_sample=16)
    ours = _IVFBankAdapter(port_config.IndexConfig(**kw), 8, "cpu")
    rows = np.random.RandomState(1).randn(20, 8).astype(np.float32)
    ours.add(rows[:10])
    ours.add(rows[10:])
    ours.truncate(7)  # drops the second batch and 3 rows of the first
    assert len(ours) == 7 and [len(p) for p in ours._pending] == [7]
    ours.query(rows[:1])  # trains and ingests the 7
    assert len(ours._ivf) == 7
    with pytest.raises(ValueError, match="cannot truncate ingested"):
        ours.truncate(6)
