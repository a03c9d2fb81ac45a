"""Kernel K1 (segment sums of segment-sorted rows): the port's plain version
against the JAX package's Pallas kernel (interpret mode on the CPU) and its
XLA cumsum reference; the CUDA kernel against the plain version on a card.

Tolerance rtol 1e-5 / atol 1e-4 (the bound tests/test_pallas_scatter.py
holds between the two JAX versions): fp32 sums in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gloc3d_tpu.ops.pallas_scatter import segment_sum_sorted_fast
from gloc3d_tpu.ops.voxelize import segment_sum_sorted as jax_cumsum_version
from gloc3d_tpu_torch.kernels import segment_sum as ss

TOL = dict(rtol=1e-5, atol=1e-4)


def _sorted_case(rng, n, c, v, p0_rows=0):
    ids = np.sort(np.concatenate([
        np.zeros(p0_rows, np.int64), rng.randint(0, v, n - p0_rows)]))
    starts = np.searchsorted(ids, np.arange(v + 1), side="left")
    return (rng.randn(n, c).astype(np.float32), starts.astype(np.int32))


@pytest.mark.parametrize("n,c,v,p0", [
    (1000, 64, 37, 0), (4096, 128, 100, 0), (777, 32, 13, 0),
    (4096, 64, 200, 3000),  # pillar 0 holds most rows (padding + OOB)
])
def test_plain_matches_pallas_and_xla(n, c, v, p0):
    x, starts = _sorted_case(np.random.RandomState(2), n, c, v, p0)
    got = ss.segment_sum_sorted(torch.from_numpy(x), torch.from_numpy(starts))
    pallas = segment_sum_sorted_fast(jnp.asarray(x), jnp.asarray(starts),
                                     chunk=64)
    xla = jax_cumsum_version(jnp.asarray(x), jnp.asarray(starts))
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), **TOL)


def test_plain_empty_segments():
    # segments 0 and 3 empty; all rows in segments 1, 2, 4
    ids = np.array([1, 1, 2, 2, 2, 4], np.int32)
    starts = np.searchsorted(ids, np.arange(6), side="left").astype(np.int32)
    x = np.arange(6 * 64, dtype=np.float32).reshape(6, 64)
    got = ss.segment_sum_sorted(torch.from_numpy(x),
                                torch.from_numpy(starts)).numpy()
    want = np.asarray(segment_sum_sorted_fast(jnp.asarray(x),
                                              jnp.asarray(starts), chunk=8))
    assert (got[0] == 0).all() and (got[3] == 0).all()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got[2], x[2:5].sum(0))


def test_plain_batched_matches_per_item():
    rng = np.random.RandomState(3)
    cases = [_sorted_case(rng, 512, 64, 50, p0) for p0 in (0, 400)]
    x = torch.from_numpy(np.stack([c[0] for c in cases]))
    starts = torch.from_numpy(np.stack([c[1] for c in cases]))
    got = ss.segment_sum_sorted(x, starts)
    assert got.shape == (2, 50, 64)
    for i, (xi, si) in enumerate(cases):
        want = jax_cumsum_version(jnp.asarray(xi), jnp.asarray(si))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), **TOL)


def test_cpu_tensors_take_the_plain_version():
    x, starts = _sorted_case(np.random.RandomState(4), 300, 64, 20)
    before = ss.segment_sum_sorted.launches
    got = ss.segment_sum_sorted(torch.from_numpy(x), torch.from_numpy(starts))
    assert ss.segment_sum_sorted.launches == before
    np.testing.assert_array_equal(
        got.numpy(), ss.segment_sum_sorted_plain(
            torch.from_numpy(x), torch.from_numpy(starts)).numpy())


@pytest.mark.parametrize("shape,dtype,c", [
    ((10, 63), torch.float32, "even C"),
    ((10, 258), torch.float32, "even C"),
    ((10, 64), torch.float64, "float32"),
])
def test_kernel_input_checks(shape, dtype, c):
    values = torch.zeros(shape, dtype=dtype)
    starts = torch.tensor([0, 4, 10], dtype=torch.int32)
    with pytest.raises((TypeError, ValueError), match=c):
        ss._check(values, starts)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")
    rng = np.random.RandomState(5)
    cases = [(1, 122480, 64, 11200, 20000), (1, 122480, 64, 11200, 90000),
             (2, 4096, 128, 100, 0), (1, 777, 32, 13, 0), (1, 300, 66, 50, 3)]
    for b, n, c, v, p0 in cases:
        items = [_sorted_case(rng, n, c, v, p0) for _ in range(b)]
        x = torch.from_numpy(np.stack([i[0] for i in items])).cuda()
        starts = torch.from_numpy(np.stack([i[1] for i in items])).cuda()
        before = ss.segment_sum_sorted.launches
        got = ss.segment_sum_sorted(x, starts)
        torch.cuda.synchronize()
        assert ss.segment_sum_sorted.launches == before + 1
        plain = ss.segment_sum_sorted_plain(x, starts)
        l1 = ss.segment_sum_sorted_plain(x.abs(), starts).double()
        err = ((got - plain).double().abs() / l1.clamp_min(1e-30)).max()
        assert float(err) < 1e-5, (b, n, c, v, p0, float(err))
