"""``locate_fused`` as one device program, on the CPU.

The port runs the located query as ``GlobalLocalizer._fused_program`` (the
JAX package's jitted ``_locate_fused_impl`` and its two variants) and, when
the top candidate fails, ``_fused_full`` (the full branch of its
``lax.cond``); on a card both are captured CUDA graphs. Held here:

- neither reads the device on the host: both run under ``FakeTensorMode``,
  where ``.item()``, ``.numpy()``, a data-dependent branch, ``nonzero`` or
  boolean indexing raises, for every extraction variant on every bank;
- the ``lax.cond``: a query whose top candidate succeeds, one that succeeds
  only at a later rank and one that fails at every rank give JAX's
  ``locate_fused`` (pose 1e-3, as tests/test_torch_serving.py holds it) and
  the port's ``locate``, and ``_fused_full`` runs exactly when stage 1
  failed;
- the bank's and the store's sizes are device inputs of the program;
- K2's id-range status leaves the program with its results and raises
  ``_check_status``'s error after the fetch;
- the ground refit's closed-form eigenvector, which keeps ``eigh`` (a host
  read on the card) out of the aligned program, against ``eigh``.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from gloc3d_tpu.config import BEVConfig, MatchConfig, PipelineConfig
from gloc3d_tpu.pipeline import GlobalLocalizer as JaxLocalizer
from gloc3d_tpu_torch.kernels import bin_sums as bs
from gloc3d_tpu_torch.models.descriptor import build_model, init_params
from gloc3d_tpu_torch.ops.ground import _least_eigvec_sym3
from gloc3d_tpu_torch.pipeline import GlobalLocalizer, Keyframe
from test_pipeline import scan_at
from test_pipeline_ground import CFG as ALIGNED_CFG
from test_pipeline_ground import tilted_scan
from test_torch_pipeline import (  # noqa: F401  (module fixture reuse)
    CFG, DB_POSES, N_PTS, _scans, localizers,
)
from test_torch_serving import QUERY_SCANS, _same
from test_torch_threads import _two_threads  # noqa: F401

I2I_CFG = PipelineConfig.i2i().replace(
    bev=BEVConfig(image_size=64, max_points=N_PTS, resolution=0.5),
    match=MatchConfig(image_size=64, min_score=0.1, min_overlap_pixels=16))
I2I_CFG = I2I_CFG.replace(
    model=I2I_CFG.model.replace(compute_dtype="float32"),
    index=I2I_CFG.index.replace(top_k=2, capacity=4))

VARIANTS = {  # the localizer's switches → the program it runs
    "host stats": dict(host_stats=True),
    "host stats, aligned": dict(host_stats=True, align_ground=True),
    "all-device": dict(),
    "aligned": dict(align_ground=True),
    "device_sort": dict(device_sort=True),
    "images": dict(),
}
PROGRAM = {"host stats": "host stats", "host stats, aligned": "host stats",
           "all-device": "device", "aligned": "aligned",
           "device_sort": "device", "images": "images"}
BANKS = {
    "flat fp32": dict(),
    "flat int8": dict(quantize="int8"),
    "IVF fp32": dict(backend="ivf", ivf_num_cells=2, ivf_nprobe=2,
                     ivf_cell_capacity=4, ivf_train_sample=16),
    "IVF int8": dict(backend="ivf", quantize="int8", ivf_num_cells=2,
                     ivf_nprobe=2, ivf_cell_capacity=4, ivf_train_sample=16),
}
N_MAP = 6


@pytest.fixture(scope="module")
def models():
    """One seeded model per family (its weights do not matter to shapes)."""
    return {"s2s": init_params(build_model(CFG.model, CFG.voxel), seed=0),
            "i2i": init_params(build_model(I2I_CFG.model, I2I_CFG.voxel),
                               seed=0)}


def _fake_map(models, variant, bank, staged=True):
    """A store map of N_MAP random descriptors and random BEV images (the
    program's shapes are what the fake run needs), and one query."""
    i2i = variant == "images"
    cfg = I2I_CFG if i2i else CFG
    cfg = cfg.replace(index=cfg.index.replace(**BANKS[bank]),
                      match=cfg.match.replace(staged_first=staged))
    loc = GlobalLocalizer(cfg, models["i2i" if i2i else "s2s"],
                          device="cpu", device_keyframes=True,
                          host_mirror=False, **VARIANTS[variant])
    rng = np.random.RandomState(0)
    s = cfg.bev.image_size
    loc.bank.add(rng.randn(N_MAP, cfg.index.dim).astype(np.float32))
    loc._store_keyframes((rng.rand(N_MAP, s, s) < 0.5).astype(np.float32),
                         rng.randn(N_MAP, 2).astype(np.float32), offset=0)
    loc.keyframes = [Keyframe(None, None)] * N_MAP
    if i2i:
        query = (rng.rand(s, s, 3).astype(np.float32), None,
                 np.float32([-16.0, -16.0]))
    else:
        query = scan_at(3, -2, 0.35, n=N_PTS)
    return loc, query


def _fake_run(loc, points, mask=None, origin=None):
    """``locate_fused``'s host side, then both programs on fake tensors."""
    variant = loc._fused_variant(points)
    query, _ = loc._fused_query(variant, points, mask, origin)
    query += (np.array([len(loc.bank), len(loc.keyframes)], np.int32),)
    bank = loc._fused_bank()
    store = (loc._kf_store, loc._kf_origins)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        def fake(t):
            return None if t is None else mode.from_tensor(t)

        *q, sizes = [fake(torch.from_numpy(np.ascontiguousarray(a)))
                     for a in query]
        fstore = tuple(fake(t) for t in store)
        words, layout, carry, k2 = loc._fused_program(
            variant, q, tuple(fake(t) for t in bank), sizes, fstore)
        full = loc._fused_full(*carry, fstore)
    return variant, words, layout, full, k2


@pytest.mark.parametrize("bank", list(BANKS))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_program_reads_nothing_on_the_host(models, variant, bank):
    loc, query = _fake_map(models, variant, bank)
    program, words, layout, full, k2 = _fake_run(loc, *query)
    assert program == PROGRAM[variant]
    k = loc.cfg.index.top_k
    names = [name for name, _, _ in layout]
    assert names[:8] == ["d2", "idx", "xy_yaw", "score", "overlap",
                         "success", "scale", "ratio"]
    assert dict((n, s) for n, s, _ in layout)["xy_yaw"] == (1, 3)
    assert ("ground_q" in names) == (variant == "aligned")
    # K2 bins twice per scatter extraction, never on the other paths
    assert len(k2) == (2 if variant in ("all-device", "aligned") else 0)
    assert isinstance(words, FakeTensor) and words.dtype == torch.int32
    assert words.shape[0] == sum(int(np.prod(s)) for _, s, _ in layout)
    assert full.xy_yaw.shape == (k, 3) and full.success.shape == (k,)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_unstaged_program_reads_nothing_on_the_host(models, variant):
    loc, query = _fake_map(models, variant, "flat fp32", staged=False)
    _, _, layout, _, _ = _fake_run(loc, *query)
    shapes = dict((n, s) for n, s, _ in layout)
    assert shapes["xy_yaw"] == (loc.cfg.index.top_k, 3)


def test_fake_mode_catches_a_host_read(models):
    """The control: ``_register`` (locate_batch's staged splice, which
    reads stage 1's success on the host) raises under the same mode."""
    loc, query = _fake_map(models, "host stats", "flat fp32")
    s = loc.cfg.bev.image_size
    with FakeTensorMode(allow_non_fake_inputs=True):
        img = torch.ones((1, s, s))
        org = torch.zeros((1, 2))
        with pytest.raises(Exception):
            loc._register(img, org, torch.zeros((1, 3), dtype=torch.long))


# ------------------------------------------------------------ lax.cond
@pytest.fixture(scope="module")
def stored(localizers):
    """The fixture's map in the port's device store, no host mirror."""
    loc = GlobalLocalizer(CFG, localizers[1].model, device="cpu",
                          host_stats=True, device_keyframes=True,
                          host_mirror=False)
    pts, mask = _scans(DB_POSES)
    for sl in (slice(0, 4), slice(4, None)):
        loc.add_keyframes(pts[sl], mask[sl])
    return loc


# QUERY_SCANS: (25, 5, 1.2) registers at its top candidate, (-12, 8, -2.0)
# at none, (60, -60, 0.0) only at its second
BRANCHES = {"top candidate": 0, "no candidate": 2, "later rank": 4}


@pytest.fixture(scope="module")
def jax_fused(localizers):
    """JAX's locate_fused of the three branch queries on the same map."""
    ref = localizers[0]
    loc = JaxLocalizer(CFG, ref.model, ref.params, host_stats=True,
                       device_keyframes=True, host_mirror=False)
    pts, mask = _scans(DB_POSES)
    for sl in (slice(0, 4), slice(4, None)):
        loc.add_keyframes(pts[sl], mask[sl])
    return {i: loc.locate_fused(*QUERY_SCANS[i]) for i in BRANCHES.values()}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_staged_branch_matches_jax_and_locate(stored, jax_fused, branch,
                                              monkeypatch):
    q = BRANCHES[branch]
    calls = []
    full = stored._fused_full

    def counted(*args):
        calls.append(args[2].shape)
        return full(*args)

    monkeypatch.setattr(stored, "_fused_full", counted)
    got = stored.locate_fused(*QUERY_SCANS[q])
    want = jax_fused[q]
    assert want.success == (branch != "no candidate")
    assert (want.success and want.db_index == want.candidates[0]) == (
        branch == "top candidate")
    # the full branch runs exactly when stage 1 failed, over all K rows
    k = CFG.index.top_k
    assert calls == ([] if branch == "top candidate" else [(k,)])
    _same(got, want, xy_tol=1e-3)
    monkeypatch.setattr(stored, "_fused_full", full)
    _same(got, stored.locate(*QUERY_SCANS[q]))


def test_unstaged_program_runs_the_full_branch_once(localizers,
                                                    monkeypatch):
    cfg = CFG.replace(match=CFG.match.replace(staged_first=False))
    loc = GlobalLocalizer(cfg, localizers[1].model, device="cpu",
                          host_stats=True, device_keyframes=True,
                          host_mirror=False)
    loc.add_keyframes(*_scans(DB_POSES))
    calls = []
    full = loc._fused_full
    monkeypatch.setattr(loc, "_fused_full",
                        lambda *a: calls.append(1) or full(*a))
    for q in (QUERY_SCANS[0], QUERY_SCANS[4]):
        got = loc.locate_fused(*q)
        _same(got, loc.locate(*q))
    assert len(calls) == 2


@pytest.mark.parametrize("host_stats", [True, False])
def test_aligned_variants_match_locate(host_stats):
    """The aligned programs on the same ground draws as ``locate``: the
    host stats variant's alignment program and the all-device one's."""
    loc = GlobalLocalizer(ALIGNED_CFG, init_params(build_model(
        ALIGNED_CFG.model, ALIGNED_CFG.voxel), seed=0), device="cpu",
        align_ground=True, host_stats=host_stats, device_keyframes=True,
        host_mirror=False)
    scans = [tilted_scan(x, y, yaw, roll=0.02, pitch=-0.01, seed=i)
             for i, (x, y, yaw) in enumerate(
                 [(-30, -30, 0.0), (0, -30, 0.4), (30, 0, 1.5)])]
    loc.add_keyframes(np.stack([s[0] for s in scans]),
                      np.stack([s[1] for s in scans]))
    q = tilted_scan(2.5, -31.5, 0.7, roll=0.03, pitch=-0.02, height=1.65,
                    seed=99)
    loc._gen.manual_seed(5)
    want = loc.locate(*q)
    state = loc._gen.get_state()
    loc._gen.manual_seed(5)
    got = loc.locate_fused(*q)
    assert want.success
    _same(got, want)
    # the fused query drew what locate drew, no more
    assert torch.equal(loc._gen.get_state(), state)


# ------------------------------------------------------------ sizes
def test_add_after_a_fused_query_gives_the_new_keyframe(localizers):
    loc = GlobalLocalizer(CFG, localizers[1].model, device="cpu",
                          host_stats=True, device_keyframes=True,
                          host_mirror=False)
    loc.add_keyframes(*_scans(DB_POSES[:2]))
    q = scan_at(*DB_POSES[2], n=N_PTS)
    before = loc.locate_fused(*q)
    assert 2 not in before.candidates
    loc.add_keyframes(*_scans(DB_POSES[2:3]))
    after = loc.locate_fused(*q)
    assert after.success and after.db_index == 2, after
    _same(after, loc.locate(*q))


def test_sizes_are_device_inputs_of_the_program(stored):
    """Rows from the size input on are not searched, and no candidate
    row reaches past the smaller of the bank's and the store's sizes."""
    q = QUERY_SCANS[0]
    variant = stored._fused_variant(q[0])
    query, _ = stored._fused_query(variant, *q, None)
    q_in = [torch.from_numpy(np.ascontiguousarray(a)) for a in query]
    bank, store = stored._fused_bank(), (stored._kf_store,
                                         stored._kf_origins)
    n = len(stored.bank)
    _, _, (_, _, rows), _ = stored._fused_program(
        variant, q_in, bank, torch.tensor([n, n], dtype=torch.int32), store)
    assert rows[0] == 1  # the query's own keyframe, db 1
    _, layout, (_, _, rows), _ = stored._fused_program(
        variant, q_in, bank, torch.tensor([1, n], dtype=torch.int32), store)
    assert rows.max() == 0
    words, layout, (_, _, rows), _ = stored._fused_program(
        variant, q_in, bank, torch.tensor([n, 1], dtype=torch.int32), store)
    assert rows.max() == 0
    k = CFG.index.top_k
    idx = words[k:2 * k]
    assert 1 in idx.tolist()  # the search itself saw every bank row


# ------------------------------------------------------------ K2 status
def _planted():
    """tests/test_torch_bin_sums.py's case: two items of 10 ids, item 1's
    rows 3 (id 9) and 7 (id -2) outside [0, 5)."""
    ids = torch.zeros((2, 10), dtype=torch.int32)
    ids[1, 3], ids[1, 7] = 9, -2
    return ids


def test_status_op_on_the_cpu_reports_as_the_kernel():
    ids = _planted()
    x = torch.arange(20 * 3, dtype=torch.float32).reshape(2, 10, 3)
    sums, counts, status = torch.ops.gloc3d.pillar_bin_sums_status(x, ids, 5)
    assert status.tolist() == [[0, 0, 0, 10], [2, 3, 9, 8]]
    keep = (ids >= 0) & (ids < 5)
    want_s, want_c = bs.pillar_bin_sums_plain(
        x * keep[..., None], torch.where(keep, ids, 0), 5)
    want_c[1, 0] -= 2  # the two bad rows are not counted at all
    np.testing.assert_array_equal(sums.numpy(), want_s.numpy())
    np.testing.assert_array_equal(counts.numpy(), want_c.numpy())


def test_deferred_status_raises_the_check_status_error():
    ids = _planted()
    status = torch.tensor([[0, 0, 0, 10], [2, 3, 9, 8]], dtype=torch.int32)
    with pytest.raises(ValueError) as want:
        bs._check_status(status, ids, 5)
    with pytest.raises(ValueError) as got:
        bs.check_deferred([np.zeros((1, 4), np.int32), status.numpy()],
                          [(None, ids[:1], 5), (status, ids, 5)])
    assert str(got.value) == str(want.value)
    bs.check_deferred([status.numpy()[:1]], [(status[:1], ids[:1], 5)])


def test_locate_fused_raises_on_a_bad_status_after_the_fetch(
        models, monkeypatch):
    loc, query = _fake_map(models, "all-device", "flat fp32")
    plain = bs.pillar_bin_sums_status_plain

    def planted(features, ids, num_voxels):
        sums, counts, status = plain(features, ids, num_voxels)
        return sums, counts, status + torch.tensor([[1, 5, 0, -1]],
                                                   dtype=torch.int32)

    monkeypatch.setattr(bs, "pillar_bin_sums_status_plain", planted)
    with pytest.raises(ValueError, match=r"the kernel read 1 of 2048 ids "
                                         r"outside \[0, \d+\) \(first at "
                                         r"flat row 5, id 0\)"):
        loc.locate_fused(*query)


# ------------------------------------------------------------ ground refit
def test_closed_form_eigenvector_matches_eigh():
    g = torch.Generator().manual_seed(0)
    q, _ = torch.linalg.qr(torch.randn(300, 3, 3, generator=g,
                                       dtype=torch.float64))
    ev = torch.rand(300, 3, generator=g, dtype=torch.float64)
    ev[:100] *= torch.tensor([400.0, 400.0, 1e-3], dtype=torch.float64)
    ev[100:200, 1] = ev[100:200, 0]  # a round scan: the two largest tie
    ev[100:200, 2] = ev[100:200, 0] * 1e-2
    a = q @ torch.diag_embed(ev) @ q.transpose(1, 2)
    a = (a + a.transpose(1, 2)) / 2
    got = _least_eigvec_sym3(a)
    want = torch.linalg.eigh(a)[1][..., 0]
    np.testing.assert_allclose((got * want).sum(-1).abs().numpy(), 1.0,
                               atol=1e-12)
    zero = _least_eigvec_sym3(torch.zeros((1, 3, 3), dtype=torch.float64))
    np.testing.assert_array_equal(
        zero.numpy(), torch.linalg.eigh(torch.zeros(
            (1, 3, 3), dtype=torch.float64))[1][..., 0].numpy())
