"""Kernel K2 (unsorted pillar binning): the port's plain version against the
JAX package's Pallas ``pillar_bin_sums`` (interpret mode on the CPU) and its
fp32 XLA scatter; the CUDA kernel against the plain version on a card.

Tolerances, relative to per-pillar L1 mass: against the Pallas kernel 2e-2
(its bf16 feature rounding, ≤ 2⁻⁹ per row; the bound
tests/test_pallas_scatter.py holds); against the fp32 scatter 1e-5 (fp32
sums in another order). Counts are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gloc3d_tpu.ops.pallas_scatter import pillar_bin_sums as jax_pallas
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


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")


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
             (1, 5, 64, 40, 1, ())]
    for seed, (b, n, c, v, p0, empty) in enumerate(cases):
        x, ids = _case(seed, b, n, c, v, p0, empty)
        x, ids = torch.from_numpy(x).cuda(), torch.from_numpy(ids).cuda()
        before = bs.pillar_bin_sums.launches
        sums, cnt = bs.pillar_bin_sums(x, ids, v)
        torch.cuda.synchronize()
        assert bs.pillar_bin_sums.launches == before + 1
        p_sums, p_cnt = bs.pillar_bin_sums_plain(x, ids, v)
        l1, _ = bs.pillar_bin_sums_plain(x.abs(), ids, v)
        err = ((sums - p_sums).double().abs()
               / l1.double().clamp_min(1e-30)).max()
        assert float(err) < 1e-5, (b, n, c, v, p0, float(err))
        assert torch.equal(cnt, p_cnt)
        assert bool((sums[p_cnt == 0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("c", [4, 64, 65])
def test_cuda_pillar_zero_is_deterministic(c):
    """Pillar 0 (every padding and out-of-grid row) is summed through
    per-block partials in a fixed order: two launches give the same bits,
    also when every row lies in pillar 0 or the features are misaligned."""
    _cuda_or_skip()
    x, ids = _case(7, 2, 122480, c, 11200, p0=82000)
    x, ids = torch.from_numpy(x).cuda(), torch.from_numpy(ids).cuda()
    zero = torch.zeros_like(ids)
    shifted = torch.empty(x.numel() + 1, device="cuda")[1:].view(x.shape)
    shifted.copy_(x)
    for feats, i in ((x, ids), (x, zero), (shifted, ids)):
        a, ca = bs.pillar_bin_sums(feats, i, 11200)
        b_, cb = bs.pillar_bin_sums(feats, i, 11200)
        assert torch.equal(a[:, 0], b_[:, 0]) and torch.equal(ca, cb)
        p_sums, p_cnt = bs.pillar_bin_sums_plain(feats, i, 11200)
        l1, _ = bs.pillar_bin_sums_plain(feats.abs(), i, 11200)
        err = ((a - p_sums).double().abs()
               / l1.double().clamp_min(1e-30)).max()
        assert float(err) < 1e-5 and torch.equal(ca, p_cnt)
