"""Kernel K2 (unsorted pillar binning): the port's plain version against the
JAX package's Pallas ``pillar_bin_sums`` (interpret mode on the CPU) and its
fp32 XLA scatter; the CUDA kernel against the plain version on a card.

Tolerances, relative to per-pillar L1 mass: against the Pallas kernel 2e-2
(its bf16 feature rounding, ≤ 2⁻⁹ per row; the bound
tests/test_pallas_scatter.py holds); against the fp32 scatter 1e-5 (fp32
sums in another order). Counts are exact. JAX is imported by the tests
that use it, so that the card tests run where it is not installed
(``pytest --noconftest -m cuda``)."""

import numpy as np
import pytest
import torch

from gloc3d_tpu_torch.kernels import bin_sums as bs


def _case(seed, b, n, c, v, p0=0, empty=()):
    """Random ids in [1, V) with p0 rows (spread through the scan) moved to
    pillar 0 and no row in the pillars ``empty``."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, v, (b, n))
    for e in empty:
        ids[ids == e] = (e + 1) % v or 1
    for i in range(b):
        ids[i, rng.permutation(n)[:p0]] = 0
    return (rng.randn(b, n, c).astype(np.float32), ids.astype(np.int32))


def _rel_err(got, want, l1):
    return float((np.abs(got - want) / np.maximum(l1, 1e-30)).max())


@pytest.mark.parametrize("n,c,v,chunk", [(1024, 8, 300, 256),
                                         (600, 64, 50, 128)])
def test_plain_matches_pallas_interpret(n, c, v, chunk):
    import jax.numpy as jnp
    from gloc3d_tpu.ops.pallas_scatter import pillar_bin_sums as jax_pallas

    x, ids = _case(0, 1, n, c, v, p0=n // 3)
    sums, cnt = bs.pillar_bin_sums(torch.from_numpy(x[0]),
                                   torch.from_numpy(ids[0]), v)
    p_sums, p_cnt = jax_pallas(jnp.asarray(x[0]), jnp.asarray(ids[0]), v,
                               chunk=chunk)
    l1, _ = bs.pillar_bin_sums(torch.from_numpy(np.abs(x[0])),
                               torch.from_numpy(ids[0]), v)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(p_cnt))
    assert _rel_err(sums.numpy(), np.asarray(p_sums), l1.numpy()) < 2e-2


@pytest.mark.parametrize("b,n,c,v,p0,empty", [
    (1, 4096, 64, 200, 3000, (5, 17)),   # pillar 0 holds most rows
    (2, 2048, 4, 100, 100, ()),          # the [valid, x, y, z] payload
    (1, 777, 65, 13, 0, (3,)),
])
def test_plain_matches_fp32_scatter(b, n, c, v, p0, empty):
    import jax.numpy as jnp

    x, ids = _case(1, b, n, c, v, p0, empty)
    sums, cnt = bs.pillar_bin_sums(torch.from_numpy(x), torch.from_numpy(ids),
                                   v)
    assert sums.shape == (b, v, c) and cnt.shape == (b, v)
    for i in range(b):
        want = jnp.zeros((v, c)).at[ids[i]].add(x[i])
        l1 = jnp.zeros((v, c)).at[ids[i]].add(np.abs(x[i]))
        assert _rel_err(sums[i].numpy(), np.asarray(want),
                        np.asarray(l1)) < 1e-5
        np.testing.assert_array_equal(cnt[i].numpy(),
                                      np.bincount(ids[i], minlength=v))
        for e in empty:
            assert (sums[i, e] == 0).all() and cnt[i, e] == 0


@pytest.mark.parametrize("c", [1, 3, 4, 64, 65, 256])
def test_plain_matches_fp32_scatter_at_every_width(c):
    import jax.numpy as jnp

    """The widths the kernel's narrow (C <= 8) and wide specialisations
    take, with a C that is not a multiple of 4 on each side."""
    b, n, v = 2, 1500, 97
    x, ids = _case(10 + c, b, n, c, v, p0=700, empty=(11,))
    sums, cnt = bs.pillar_bin_sums(torch.from_numpy(x), torch.from_numpy(ids),
                                   v)
    assert sums.shape == (b, v, c) and cnt.shape == (b, v)
    for i in range(b):
        want = jnp.zeros((v, c)).at[ids[i]].add(x[i])
        l1 = jnp.zeros((v, c)).at[ids[i]].add(np.abs(x[i]))
        assert _rel_err(sums[i].numpy(), np.asarray(want),
                        np.asarray(l1)) < 1e-5
        np.testing.assert_array_equal(cnt[i].numpy(),
                                      np.bincount(ids[i], minlength=v))
        assert (sums[i, 11] == 0).all() and cnt[i, 11] == 0


def test_every_row_in_pillar_zero_plain():
    x, _ = _case(5, 1, 2000, 64, 30)
    ids = np.zeros((1, 2000), np.int32)
    sums, cnt = bs.pillar_bin_sums(torch.from_numpy(x), torch.from_numpy(ids),
                                   30)
    np.testing.assert_allclose(sums[0, 0].numpy(), x[0].astype(np.float64)
                               .sum(0), rtol=1e-6, atol=1e-5)
    assert cnt[0, 0] == 2000 and (cnt[0, 1:] == 0).all()
    assert (sums[0, 1:] == 0).all()


def _non_finite_case():
    """Rows with NaN, +inf and -inf in some pillars and channels: pillar 1
    channel 0 NaN, pillar 2 channel 1 +inf and -inf (NaN), pillar 3 channel
    2 +inf, pillar 4 channel 2 -inf, pillar 0 channel 3 +inf; every other
    pillar-channel finite."""
    rng = np.random.RandomState(3)
    ids = np.array([0, 1, 1, 2, 2, 3, 3, 4, 5, 5, 0, 6], np.int32)
    x = rng.randn(len(ids), 4).astype(np.float32)
    x[1, 0] = np.nan
    x[3, 1], x[4, 1] = np.inf, -np.inf
    x[5, 2], x[7, 2] = np.inf, -np.inf
    x[0, 3] = np.inf
    return x, ids


def test_plain_non_finite_matches_jax():
    """Non-finite rows: the plain version (and so the kernel, which copies
    it) gives each pillar-channel the fp32 XLA scatter's value, JAX's
    ``.at[].add`` on the serving path: NaN where a row is NaN or both
    infinities meet, the infinity that occurs, finite sums elsewhere.
    JAX's Pallas ``pillar_bin_sums`` (interpret mode) cannot give per-pillar
    results: its one-hot product multiplies every non-finite value by the
    zeros of the other pillars' columns (0 · inf = NaN), so every
    pillar-channel whose scatter sum is finite reads NaN there; the port
    holds the scatter's semantics, as for finite rows, and counts agree
    with both."""
    import jax.numpy as jnp
    from gloc3d_tpu.ops.pallas_scatter import pillar_bin_sums as jax_pallas

    x, ids = _non_finite_case()
    v = 8
    sums, cnt = bs.pillar_bin_sums(torch.from_numpy(x), torch.from_numpy(ids),
                                   v)
    want = np.asarray(jnp.zeros((v, 4)).at[ids].add(x))
    np.testing.assert_array_equal(sums.numpy(), want)  # NaN == NaN here
    assert np.isnan(want[1, 0]) and np.isnan(want[2, 1])
    assert want[3, 2] == np.inf and want[4, 2] == -np.inf
    assert want[0, 3] == np.inf and np.isfinite(want[5:]).all()
    p_sums, p_cnt = jax_pallas(jnp.asarray(x), jnp.asarray(ids), v)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(p_cnt))
    assert np.isnan(np.asarray(p_sums)[np.isfinite(want)]).all()


def test_cpu_tensors_take_the_plain_version():
    x, ids = _case(2, 1, 300, 64, 20)
    before = bs.pillar_bin_sums.launches
    got = bs.pillar_bin_sums(torch.from_numpy(x), torch.from_numpy(ids), 20)
    assert bs.pillar_bin_sums.launches == before
    want = bs.pillar_bin_sums_plain(torch.from_numpy(x),
                                    torch.from_numpy(ids), 20)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("feats,ids,v,match", [
    (torch.zeros(10, 4, dtype=torch.float64), torch.zeros(10, dtype=torch.int32),
     5, "float32"),
    (torch.zeros(10, 4), torch.zeros(10, dtype=torch.int64), 5, "int32"),
    (torch.zeros(10, 257), torch.zeros(10, dtype=torch.int32), 5, "channels"),
    (torch.zeros(10, 4), torch.zeros(9, dtype=torch.int32), 5, "expected"),
    (torch.zeros(10, 4), torch.full((10,), 5, dtype=torch.int32), 5,
     "outside"),
    (torch.zeros(10, 4), torch.full((10,), -1, dtype=torch.int32), 5,
     "outside"),
])
def test_kernel_input_checks(feats, ids, v, match):
    with pytest.raises((TypeError, ValueError), match=match):
        bs._check(feats, ids, v)


def test_out_of_range_ids_are_reported_from_a_host_copy():
    ids = torch.zeros((2, 10), dtype=torch.int32)
    ids[1, 3], ids[1, 7] = 9, -2
    with pytest.raises(ValueError) as err:
        bs._check(torch.zeros(2, 10, 4), ids, 5)
    msg = str(err.value)
    assert "ids span [-2, 9]" in msg
    assert "read back to the host they span [-2, 9], 2 of 20 out of range" \
        in msg
    assert "first at flat rows [13, 17], shape (2, 10)" in msg


def _planted_status_case():
    """Host ids (2, 10) with two out-of-range ids in item 1, at flat rows 13
    (id 9) and 17 (id -2), and the status the kernel reports for them."""
    ids = torch.zeros((2, 10), dtype=torch.int32)
    ids[1, 3], ids[1, 7] = 9, -2
    status = torch.tensor([[0, 0, 0, 10], [2, 3, 9, 8]], dtype=torch.int32)
    return status, ids


def test_status_message_names_the_kernel_and_the_host_reading():
    status, ids = _planted_status_case()
    msg = bs.status_message(status, ids, 5)
    assert msg.startswith("the kernel read 2 of 20 ids outside [0, 5) "
                          "(first at flat row 13, id 9); ")
    assert msg.endswith("read back to the host they span [-2, 9], 2 of 20 "
                        "out of range (first at flat rows [13, 17], shape "
                        "(2, 10))")


def test_status_message_shows_a_bad_read_of_good_ids():
    """The kernel's status says one id was bad while the host's copy holds
    none: the message shows both, so a fault in the read is told from bad
    ids in memory."""
    ids = torch.arange(12, dtype=torch.int32).reshape(3, 4) % 5
    status = torch.tensor([[0, 0, 0, 4], [0, 0, 0, 4], [1, 2, 1140861452, 3]],
                          dtype=torch.int32)
    msg = bs.status_message(status, ids, 5)
    assert "the kernel read 1 of 12 ids outside [0, 5) (first at flat row " \
        "10, id 1140861452)" in msg
    assert "read back to the host they span [0, 4], 0 of 12 out of range " \
        "(first at flat rows [], shape (3, 4))" in msg


def test_status_message_flattens_every_leading_axis():
    ids = torch.zeros((2, 3, 10), dtype=torch.int32)
    ids[1, 2, 6] = 70
    status = torch.zeros((6, 4), dtype=torch.int32)
    status[:, 3] = 10
    status[5] = torch.tensor([1, 6, 70, 9])
    msg = bs.status_message(status, ids, 64)
    assert "read 1 of 60 ids outside [0, 64) (first at flat row 56, id 70)" \
        in msg
    assert "1 of 60 out of range (first at flat rows [56], shape (2, 3, 10))" \
        in msg


@pytest.mark.parametrize("clean", [True, False])
def test_check_status_raises_only_on_a_bad_status(clean):
    status, ids = _planted_status_case()
    if clean:
        bs._check_status(torch.tensor([[0, 0, 0, 10], [0, 0, 0, 10]],
                                      dtype=torch.int32), ids * 0, 5)
        return
    with pytest.raises(ValueError, match=r"the kernel read 2 of 20 ids .* "
                       r"read back to the host they span \[-2, 9\]"):
        bs._check_status(status, ids, 5)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")


def _hard_ids(n=122480, v=11200):
    """Id patterns (N,) that stress the kernel's order of adds: 50 000 rows
    in pillar 4321, every row in pillar 7, ids in descending order, a scan's
    ids permuted."""
    rng = np.random.RandomState(11)
    base = rng.randint(1, v, n)
    base[rng.permutation(n)[:82000]] = 0
    crowded = base.copy()
    crowded[rng.permutation(n)[:50000]] = 4321
    return [crowded, np.full(n, 7), np.sort(base)[::-1].copy(),
            base[rng.permutation(n)]]


def _held_to_plain(feats, ids, v, sums, cnt):
    p_sums, p_cnt = bs.pillar_bin_sums_plain(feats, ids, v)
    l1, _ = bs.pillar_bin_sums_plain(feats.abs(), ids, v)
    err = ((sums - p_sums).double().abs()
           / l1.double().clamp_min(1e-30)).max()
    assert float(err) < 1e-5, (tuple(feats.shape), v, float(err))
    assert torch.equal(cnt, p_cnt)
    assert bool((sums[p_cnt == 0] == 0).all())


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    _cuda_or_skip()
    cases = [(1, 122480, 64, 11200, 83000, ()), (1, 122480, 4, 11200, 90000,
                                                  (7, 99)),
             (2, 4096, 64, 100, 0, ()), (1, 300, 65, 50, 3, (4,)),
             (1, 777, 256, 13, 0, ()), (24, 20000, 64, 11200, 13000, ()),
             (24, 20000, 4, 11200, 13000, ()), (1, 5000, 1, 300, 2000, ()),
             (1, 5000, 3, 300, 2000, ()), (1, 5000, 12, 300, 2000, ()),
             (1, 5000, 9, 300, 2000, ()), (3, 3001, 130, 77, 1000, (5,)),
             (1, 5, 64, 40, 1, ()),
             # V beyond one window of the tiles' histograms
             (1, 20000, 4, 30000, 5000, (7,)), (2, 9001, 64, 40000, 0, ())]
    inputs = [_case(seed, *case) + (case[3],)
              for seed, case in enumerate(cases)]
    # one pillar far longer than a block's share of sorted positions, every
    # row in one pillar, sorted and permuted ids
    rng = np.random.RandomState(3)
    for hard in _hard_ids():
        inputs.append((rng.randn(1, hard.size, 64).astype(np.float32),
                       hard.astype(np.int32)[None], 11200))
    for x, ids, v in inputs:
        x, ids = torch.from_numpy(x).cuda(), torch.from_numpy(ids).cuda()
        before = bs.pillar_bin_sums.launches
        sums, cnt = bs.pillar_bin_sums(x, ids, v)
        torch.cuda.synchronize()
        assert bs.pillar_bin_sums.launches == before + 1
        _held_to_plain(x, ids, v, sums, cnt)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [4, 64, 65])
def test_cuda_kernel_is_deterministic(c):
    """Every pillar's sums and every count are the same bits over four
    launches (sums in a fixed order, rounded once), also when every
    row lies in pillar 0, the features are misaligned or the ids are one of
    the hard patterns; and item 3 of a batch of 24 gives the bits it gives
    binned alone."""
    _cuda_or_skip()
    x, ids = _case(7, 2, 122480, c, 11200, p0=82000)
    x, ids = torch.from_numpy(x).cuda(), torch.from_numpy(ids).cuda()
    zero = torch.zeros_like(ids)
    shifted = torch.empty(x.numel() + 1, device="cuda")[1:].view(x.shape)
    shifted.copy_(x)
    cases = [(x, ids), (x, zero), (shifted, ids)]
    for hard in _hard_ids():
        cases.append((x[:1], torch.from_numpy(hard.astype(np.int32))[None]
                      .cuda()))
    for feats, i in cases:
        a, ca = bs.pillar_bin_sums(feats, i, 11200)
        for _ in range(3):
            b_, cb = bs.pillar_bin_sums(feats, i, 11200)
            assert torch.equal(a, b_) and torch.equal(ca, cb)
        _held_to_plain(feats, i, 11200, a, ca)
    gen = torch.Generator().manual_seed(5)
    big = torch.randn((24, 122480, c), generator=gen).cuda()
    big_ids = ids[torch.arange(24) % 2][:, torch.randperm(122480,
                                                          generator=gen)]
    big_ids = big_ids.contiguous()
    sums, cnt = bs.pillar_bin_sums(big, big_ids, 11200)
    alone, c_alone = bs.pillar_bin_sums(big[3:4].contiguous(),
                                        big_ids[3:4].contiguous(), 11200)
    assert torch.equal(sums[3:4], alone) and torch.equal(cnt[3:4], c_alone)


@pytest.mark.cuda
def test_cuda_out_of_range_ids_raise_from_the_kernel_status():
    """Planted bad ids: the kernel's status names the count and the first
    (flat row 122480 + 4100, id 11200), the host's reading stands beside
    it, and a clean call reads a zero status."""
    _cuda_or_skip()
    x, ids = _case(8, 2, 122480, 4, 11200, p0=80000)
    x, ids = torch.from_numpy(x).cuda(), torch.from_numpy(ids).cuda()
    _, _, status = bs._launch(x, ids, 11200)
    assert status.cpu().tolist() == [[0, 0, 0, 122480]] * 2
    bad = ids.clone()
    bad[1, 4100], bad[1, 9000], bad[1, 60000] = 11200, -1, 99999
    with pytest.raises(ValueError) as err:
        bs.pillar_bin_sums(x, bad, 11200)
    msg = str(err.value)
    assert "the kernel read 3 of 244960 ids outside [0, 11200) (first at " \
        "flat row 126580, id 11200)" in msg
    assert "read back to the host they span [-1, 99999], 3 of 244960 out " \
        "of range (first at flat rows [126580, 131480, 182480]" in msg
    _, _, status = bs._launch(x, bad, 11200)
    assert status.cpu().tolist() == [[0, 0, 0, 122480],
                                     [3, 4100, 11200, 122477]]


@pytest.mark.cuda
@pytest.mark.parametrize("c", [4, 64])
def test_cuda_non_finite_matches_plain(c):
    """NaN, +inf and -inf rows give the plain version's value in their own
    pillar-channel (both kernels' row walks), and only there."""
    _cuda_or_skip()
    x, ids = _non_finite_case()
    xs = np.zeros((len(ids), c), np.float32)
    xs[:, :4] = x
    x = torch.from_numpy(np.tile(xs, (3, 1))).cuda()
    ids = torch.from_numpy(np.tile(ids, 3)).cuda()
    got, cnt = bs.pillar_bin_sums(x, ids, 8)
    want, p_cnt = bs.pillar_bin_sums_plain(x, ids, 8)
    assert torch.equal(cnt, p_cnt)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    fin = torch.isfinite(want)
    assert torch.equal(got[~fin & ~torch.isnan(want)],
                       want[~fin & ~torch.isnan(want)])
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-6, atol=1e-6)
