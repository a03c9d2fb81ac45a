"""Exact L2 top-k and the flat descriptor bank, fp32 and int8: port vs JAX.

Indices must be EQUAL, including exact ties (earliest index wins) and masked
rows. fp32 distances agree to 1e-4 absolute: ‖q‖² − 2q·b + ‖b‖² cancels in
fp32 at ‖q‖² ≈ 32 (32 random dims), so a summation order change moves it
~1e-5. int8 codes are bit-equal and their cross term is an exact integer
product, so int8 distances of unit rows agree to rtol 1e-6 (only the fp32
norms are summed in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gloc3d_tpu.config import IndexConfig
from gloc3d_tpu.index.bank import DescriptorBank as JaxBank
from gloc3d_tpu.ops.topk import l2_topk as jax_topk
from gloc3d_tpu.ops.topk import l2_topk_int8 as jax_topk_int8
from gloc3d_tpu.ops.topk import quantize_rows as jax_quantize
from gloc3d_tpu_torch.index.bank import DescriptorBank
from gloc3d_tpu_torch.ops.topk import (
    int8_dots, l2_topk, l2_topk_int8, quantize_rows,
)
from test_torch_threads import _two_threads  # noqa: F401


def _bank(seed=0, n=300, d=32):
    return np.random.RandomState(seed).randn(n, d).astype(np.float32)


@pytest.mark.parametrize("case", ["plain", "ties", "masked"])
def test_l2_topk_matches_jax(case):
    bank = _bank()
    q = np.random.RandomState(1).randn(4, 32).astype(np.float32)
    valid = None
    if case == "ties":
        # exact duplicates of the nearest rows at later and earlier indices
        bank[[250, 251, 3]] = bank[[10, 10, 10]]
        q[0] = bank[10]
        bank[[120, 7]] = bank[[60, 60]]
        q[1] = bank[60] + 1e-3
    if case == "masked":
        valid = np.ones(len(bank), bool)
        valid[::3] = False
        valid[200:] = False
    k = 20
    d_j, i_j = jax_topk(jnp.asarray(q), jnp.asarray(bank), k,
                        None if valid is None else jnp.asarray(valid))
    d_t, i_t = l2_topk(torch.from_numpy(q), torch.from_numpy(bank), k,
                       None if valid is None else torch.from_numpy(valid))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-4)
    if case == "ties":
        assert list(i_t[0, :4]) == [3, 10, 250, 251]
    if case == "masked":
        assert valid[i_t.numpy()].all()


def test_bank_grow_query_exclude_recent_matches_jax():
    cfg = IndexConfig(dim=32, top_k=5, capacity=16, num_exclude_recent=30)
    ours, ref = DescriptorBank(cfg, device="cpu"), JaxBank(cfg)
    rows = _bank(2, 100)
    for chunk in np.split(rows, [10, 11, 64]):  # crosses 3 doublings
        ours.add(chunk)
        ref.add(jnp.asarray(chunk))
    ours.add(rows[5])  # a (D,) row
    ref.add(jnp.asarray(rows[5]))
    assert len(ours) == len(ref) == 101 and ours._capacity == 128
    q = rows[[5, 70, 99]] + 0.01
    for excl in (False, True):
        d_t, i_t = ours.query(q, exclude_recent=excl)
        d_j, i_j = ref.query(jnp.asarray(q), exclude_recent=excl)
        np.testing.assert_array_equal(i_t, i_j)
        np.testing.assert_allclose(d_t, d_j, atol=1e-4)
    assert (ours.query(q, exclude_recent=True)[1] < 101 - 30).all()
    assert ours.detect_loop(rows[20] + 1e-4) == pytest.approx(
        ref.detect_loop(jnp.asarray(rows[20] + 1e-4)), abs=1e-4)
    ours.truncate(40)
    ref.truncate(40)
    np.testing.assert_array_equal(ours.query(q)[1],
                                  ref.query(jnp.asarray(q))[1])
    with pytest.raises(ValueError):
        ours.truncate(41)


def test_bank_files_load_across_packages(tmp_path):
    cfg = IndexConfig(dim=32, top_k=4, capacity=8)
    rows = _bank(3, 20)
    ref = JaxBank(cfg)
    ref.add(jnp.asarray(rows))
    ref.save(str(tmp_path / "jax.npz"))
    ours = DescriptorBank.load(str(tmp_path / "jax.npz"), device="cpu")
    assert ours.cfg.top_k == 4 and len(ours) == 20
    np.testing.assert_array_equal(ours.data.numpy(), rows)

    ours.add(rows[:3] * 2.0)
    ours.save(str(tmp_path / "port.npz"))
    back = JaxBank.load(str(tmp_path / "port.npz"))
    assert len(back) == 23
    np.testing.assert_array_equal(np.asarray(back.data), ours.data.numpy())
    q = rows[[1, 2]]
    np.testing.assert_array_equal(back.query(jnp.asarray(q))[1],
                                  ours.query(q)[1])


# ---------------------------------------------------------------- int8
def _unit(seed=0, n=300, d=64):
    x = _bank(seed, n, d)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_quantize_rows_matches_jax():
    x = _bank(4, 200, 48) * np.linspace(0.01, 30, 200)[:, None].astype(
        np.float32)
    x[3] = 0.0  # an all-zero row: scale 1e-12 / 127, codes 0
    got = quantize_rows(torch.from_numpy(x))
    want = jax_quantize(jnp.asarray(x))
    assert got[0].dtype == torch.int8
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("case", ["plain", "ties", "masked"])
def test_l2_topk_int8_matches_jax(case):
    bank = _unit()
    q = _unit(1, 4) + 0.01
    valid = None
    if case == "ties":
        bank[[250, 251, 3]] = bank[[10, 10, 10]]
        q[0] = bank[10]
    if case == "masked":
        valid = np.ones(len(bank), bool)
        valid[::3] = False
    codes, scales, bsq = jax_quantize(jnp.asarray(bank))
    d_j, i_j = jax_topk_int8(jnp.asarray(q), codes, scales, bsq, 20,
                             None if valid is None else jnp.asarray(valid))
    d_t, i_t = l2_topk_int8(
        torch.from_numpy(q), *(torch.from_numpy(np.asarray(a))
                               for a in (codes, scales, bsq)), 20,
        None if valid is None else torch.from_numpy(valid))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-6,
                               atol=1e-6)
    if case == "ties":
        assert list(i_t[0, :4]) == [3, 10, 250, 251]


@pytest.mark.parametrize("m,k,n", [(300, 64, 4), (5, 36, 1), (17, 8, 9)])
def test_int8_dots_is_the_int32_product(m, k, n):
    rng = np.random.RandomState(m)
    a = rng.randint(-127, 128, (m, k)).astype(np.int8)
    b = rng.randint(-127, 128, (n, k)).astype(np.int8)
    got = int8_dots(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(
        got.numpy(), a.astype(np.int64) @ b.astype(np.int64).T)


def test_int8_bank_grow_query_exclude_recent_matches_jax():
    cfg = IndexConfig(dim=64, top_k=5, capacity=16, num_exclude_recent=30,
                      quantize="int8")
    ours, ref = DescriptorBank(cfg, device="cpu"), JaxBank(cfg)
    rows = _unit(2, 100)
    for chunk in np.split(rows, [10, 11, 64]):  # crosses 3 doublings
        ours.add(chunk)
        ref.add(jnp.asarray(chunk))
    assert len(ours) == len(ref) == 100 and ours._capacity == 128
    np.testing.assert_array_equal(ours._bank.numpy(), np.asarray(ref._bank))
    np.testing.assert_allclose(ours.data.numpy(), np.asarray(ref.data),
                               rtol=1e-6)
    q = rows[[5, 70, 99]] + 0.01
    for excl in (False, True):
        d_t, i_t = ours.query(q, exclude_recent=excl)
        d_j, i_j = ref.query(jnp.asarray(q), exclude_recent=excl)
        np.testing.assert_array_equal(i_t, i_j)
        np.testing.assert_allclose(d_t, d_j, rtol=1e-6, atol=1e-6)
    d_dev, i_dev = ours.query_device(q)
    assert i_dev.device.type == "cpu" and i_dev.shape == (3, 5)
    np.testing.assert_array_equal(i_dev.numpy(), ours.query(q)[1])
    # rank 1 of the int8 bank is the fp32 bank's on unit-norm rows
    f32 = DescriptorBank(cfg.replace(quantize="none"), device="cpu")
    f32.add(rows)
    np.testing.assert_array_equal(ours.query(q)[1][:, 0],
                                  f32.query(q)[1][:, 0])
    ours.truncate(40)
    ref.truncate(40)
    np.testing.assert_array_equal(ours.query(q)[1],
                                  ref.query(jnp.asarray(q))[1])


def test_int8_bank_files_load_across_packages(tmp_path):
    cfg = IndexConfig(dim=64, top_k=4, capacity=8, quantize="int8")
    rows = _unit(3, 20)
    ref = JaxBank(cfg)
    ref.add(jnp.asarray(rows))
    ref.save(str(tmp_path / "jax.npz"))
    assert "bank_q" in np.load(str(tmp_path / "jax.npz"))
    ours = DescriptorBank.load(str(tmp_path / "jax.npz"), device="cpu")
    assert ours._quantized and len(ours) == 20 and ours._capacity == 32
    np.testing.assert_array_equal(ours._bank[:20].numpy(),
                                  np.asarray(ref._bank[:20]))
    np.testing.assert_array_equal(ours._bsq[:20].numpy(),
                                  np.asarray(ref._bsq[:20]))

    ours.add(rows[:3] * 2.0)
    ours.save(str(tmp_path / "port.npz"))
    back = JaxBank.load(str(tmp_path / "port.npz"))
    assert back._quantized and len(back) == 23
    q = rows[[1, 2, 7]] + 0.005
    d_t, i_t = ours.query(q)
    d_j, i_j = back.query(jnp.asarray(q))
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-6, atol=1e-6)
    # an int8 file loads as int8 whatever config the caller passes
    again = DescriptorBank.load(str(tmp_path / "port.npz"),
                                cfg=cfg.replace(quantize="none"),
                                device="cpu")
    assert again._quantized and len(again) == 23
