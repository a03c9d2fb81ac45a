"""Exact L2 top-k and the flat descriptor bank: port vs JAX.

Indices must be EQUAL, including exact ties (earliest index wins) and masked
rows. Distances agree to 1e-4 absolute: ‖q‖² − 2q·b + ‖b‖² cancels in fp32
at ‖q‖² ≈ 32 (32 random dims), so a summation order change moves it ~1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gloc3d_tpu.config import IndexConfig
from gloc3d_tpu.index.bank import DescriptorBank as JaxBank
from gloc3d_tpu.ops.topk import l2_topk as jax_topk
from gloc3d_tpu_torch.index.bank import DescriptorBank
from gloc3d_tpu_torch.ops.topk import l2_topk


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


def test_int8_bank_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="item 13"):
        DescriptorBank(IndexConfig(quantize="int8"), device="cpu")
