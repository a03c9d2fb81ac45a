"""The port's IVF index (gloc3d_tpu_torch/index/ivf.py) against the JAX
package's, the cases of tests/test_ivf.py.

torch cannot replay a JAX key, so the two packages share a cell layout in
three ways: the port's index takes JAX's trained centroids, trains on
JAX's replayed k-means++ draws (centroids within rtol 1e-5), or loads the
file JAX saved (and the other way round). On one layout the query results
are held to ids equal and dists² within rtol 1e-5 / atol 1e-5 of the
terms that ‖q‖² − 2q·b + ‖b‖² cancels (2·max‖x‖²: 2 for unit rows, ~1600
for the clustered rows of tests/test_ivf.py): the same cells and the same
fp32 or exact int8 cross term, summed in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gloc3d_tpu.index.ivf import IVFBank as JaxIVF
from gloc3d_tpu.ops.topk import l2_topk as jax_topk
from gloc3d_tpu_torch.index.ivf import IVFBank
from gloc3d_tpu_torch.ops.topk import l2_topk
from test_torch_mining import _jax_seed_draws
from test_torch_threads import _two_threads  # noqa: F401


def _data(n=2000, d=32, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(16, d) * 5
    return (centers[rng.randint(0, 16, n)] + rng.randn(n, d)).astype(
        np.float32)


def _unit_data(n=1500, d=64, seed=7):
    x = _data(n, d, seed)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _pair(data, train_rows=500, key=0, **kw):
    """A JAX index trained on ``data[:train_rows]`` and the port's with
    JAX's centroids, both filled with ``data``."""
    ref = JaxIVF(**kw)
    ref.train(data[:train_rows], key=jax.random.PRNGKey(key))
    ref.add(data)
    ours = IVFBank(device="cpu", **kw)
    ours.centroids = torch.tensor(np.asarray(ref.centroids))
    ours.add(data)
    return ref, ours


def _same(got, want, data):
    """ids equal, dists² within 1e-5 of the cancelled terms."""
    scale = 2.0 * float((data * data).sum(1).max())
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-5,
                               atol=1e-5 * scale)


def _same_layout(ours, ref):
    for name in ("_ids", "_sizes", "_cells", "_bsq"):
        np.testing.assert_allclose(getattr(ours, name), getattr(ref, name),
                                   rtol=1e-6, err_msg=name)
    assert ours.cell_capacity == ref.cell_capacity
    assert len(ours) == len(ref)


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_full_probe_is_exact_and_matches_jax(quantize):
    data = _data() if quantize == "none" else _unit_data(2000, 32)
    ref, ours = _pair(data, dim=32, num_cells=16, cell_capacity=64,
                      quantize=quantize)
    _same_layout(ours, ref)
    q = data[123:128]
    got = ours.query(q, k=5, nprobe=16)
    _same(got, ref.query(q, k=5, nprobe=16), data)
    d2, idx = l2_topk(torch.from_numpy(q), torch.from_numpy(data), 5)
    if quantize == "none":  # all cells probed: the exact search
        np.testing.assert_array_equal(got[1], idx.numpy())
        np.testing.assert_allclose(got[0], d2.numpy(), rtol=1e-4, atol=1e-3)
        _, idx_j = jax_topk(jnp.asarray(q), jnp.asarray(data), 5)
        np.testing.assert_array_equal(got[1], np.asarray(idx_j))
    else:  # rank 1 of the exact search
        np.testing.assert_array_equal(got[1][:, 0], idx[:, 0].numpy())


def test_narrow_probe_recall_and_parity():
    data = _data(seed=1)
    ref, ours = _pair(data, dim=32, num_cells=16, cell_capacity=64,
                      nprobe=4)
    q = data[:50]
    got = ours.query(q, k=1)
    _same(got, ref.query(q, k=1), data)
    assert (got[1][:, 0] == np.arange(50)).mean() >= 0.95
    own = IVFBank(dim=32, num_cells=16, cell_capacity=64, nprobe=4,
                  device="cpu")
    own.train(data[:500])  # the port's own draws
    own.add(data)
    _, idx = own.query(q, k=1)
    assert (idx[:, 0] == np.arange(50)).mean() >= 0.95


def test_cell_overflow_grows_as_in_jax():
    rng = np.random.RandomState(2)
    data = rng.randn(300, 8).astype(np.float32) * 0.01  # all in one cell
    ref, ours = _pair(data, train_rows=100, dim=8, num_cells=4,
                      cell_capacity=16)
    _same_layout(ours, ref)
    assert ours.cell_capacity >= 300 / 4
    got = ours.query(data[7], k=1, nprobe=4)
    assert got[1][0, 0] == 7
    _same(got, ref.query(data[7], k=1, nprobe=4), data)


def test_bulk_add_matches_small_batches():
    data = _data(seed=3)
    ref, bulk = _pair(data, dim=32, num_cells=16, cell_capacity=256)
    small = IVFBank(dim=32, num_cells=16, cell_capacity=256, device="cpu")
    small.centroids = bulk.centroids
    for i in range(0, len(data), 37):
        small.add(data[i:i + 37])
    assert len(small) == len(bulk) == len(data)
    q = data[200:232]
    a, b = bulk.query(q, k=5, nprobe=16), small.query(q, k=5, nprobe=16)
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_allclose(a[0], b[0], rtol=1e-5)
    _same(b, ref.query(q, k=5, nprobe=16), data)


def test_bounded_capacity_spills_as_in_jax():
    rng = np.random.RandomState(4)
    data = rng.randn(300, 8).astype(np.float32) * 0.01
    kw = dict(dim=8, num_cells=32, cell_capacity=16, max_cell_capacity=16,
              spill_probes=32)
    ref = JaxIVF(**kw)
    ref.train(rng.randn(200, 8).astype(np.float32))
    ref.add(data)
    ours = IVFBank(device="cpu", **kw)
    ours.centroids = torch.tensor(np.asarray(ref.centroids))
    ours.add(data)
    _same_layout(ours, ref)
    assert ours.cell_capacity == 16 and ours.spilled == ref.spilled > 0
    assert sorted(ours._ids[ours._ids >= 0].tolist()) == list(range(300))
    got = ours.query(data[:50], k=1, nprobe=32)
    assert (got[1][:, 0] == np.arange(50)).all()
    _same(got, ref.query(data[:50], k=1, nprobe=32), data)


def test_spill_overflow_last_resort_and_full_error():
    rng = np.random.RandomState(5)
    data = rng.randn(60, 8).astype(np.float32) * 0.01
    train = rng.randn(100, 8).astype(np.float32)
    kw = dict(dim=8, num_cells=4, cell_capacity=16, max_cell_capacity=16,
              spill_probes=2)
    ref = JaxIVF(**kw)
    ref.train(train)
    ref.add(data)
    ours = IVFBank(device="cpu", **kw)
    ours.centroids = torch.tensor(np.asarray(ref.centroids))
    ours.add(data)
    _same_layout(ours, ref)
    assert ours.spill_overflow == ref.spill_overflow > 0
    with pytest.raises(RuntimeError, match="IVFBank full"):
        ours.add(rng.randn(10, 8).astype(np.float32) * 0.01)


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_exclude_after_and_filler_match_jax(quantize):
    data = _unit_data(n=100, d=32, seed=5)
    ref, ours = _pair(data, train_rows=50, dim=32, num_cells=4,
                      cell_capacity=64, nprobe=4, quantize=quantize)
    q = data[10:11]
    got = ours.query(q, k=5, exclude_after=11)
    assert got[1][0, 0] == 10 and (got[1][0] < 11).all()
    _same(got, ref.query(q, k=5, exclude_after=11), data)
    d2, idx = ours.query(q, k=5, exclude_after=0)
    assert (idx[0] == -1).all() and np.isinf(d2[0]).all()
    _same((d2, idx), ref.query(q, k=5, exclude_after=0), data)
    # fewer live rows than k in the probed cells: -1 after the last one
    d2, idx = ours.query(q, k=5, exclude_after=3)
    assert list(idx[0, 3:]) == [-1, -1] and np.isinf(d2[0, 3:]).all()
    _same((d2, idx), ref.query(q, k=5, exclude_after=3), data)


def test_int8_ranks_match_fp32_and_jax():
    data = _unit_data()
    ref8, q8 = _pair(data, dim=64, num_cells=16, cell_capacity=256,
                     nprobe=16, quantize="int8")
    assert q8._cells.dtype == np.int8
    np.testing.assert_array_equal(q8._cells, ref8._cells)
    np.testing.assert_allclose(q8._scales, ref8._scales, rtol=1e-6)
    f32 = IVFBank(dim=64, num_cells=16, cell_capacity=256, nprobe=16,
                  device="cpu")
    f32.centroids = q8.centroids
    f32.add(data)
    q = data[100:140] + 0.003
    d2f, idxf = f32.query(q, k=10)
    got = q8.query(q, k=10)
    np.testing.assert_array_equal(got[1][:, 0], idxf[:, 0])
    overlap = np.mean([len(set(got[1][i]) & set(idxf[i])) / 10
                       for i in range(len(q))])
    assert overlap >= 0.9, overlap
    np.testing.assert_allclose(got[0], d2f, atol=5e-3)
    _same(got, ref8.query(q, k=10), data)
    # more than 8 queries: the int8 scan runs in groups of 8
    _same(q8.query(data[:19], k=3, nprobe=4),
          ref8.query(data[:19], k=3, nprobe=4), data)


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_files_load_across_packages(tmp_path, quantize):
    data = _unit_data(seed=8)
    ref = JaxIVF(dim=64, num_cells=16, cell_capacity=256, nprobe=4,
                 quantize=quantize)
    ref.train(data[:500], key=jax.random.PRNGKey(1))
    ref.add(data[:1000])
    ref.save(str(tmp_path / "jax.npz"))
    ours = IVFBank.load(str(tmp_path / "jax.npz"), device="cpu")
    assert ours.quantize == quantize and ours.nprobe == 4
    _same_layout(ours, ref)
    q = data[50:66] + 0.002
    _same(ours.query(q, k=5), ref.query(q, k=5), data)

    ours.add(data[1000:])  # grows the map on the port's side
    ours.save(str(tmp_path / "port.npz"))
    back = JaxIVF.load(str(tmp_path / "port.npz"))
    assert back.quantize == quantize and len(back) == len(data)
    q = data[1200:1216] + 0.002
    _same(ours.query(q, k=5), back.query(q, k=5), data)


def test_pre_dot_form_file_gets_its_norms(tmp_path):
    """An fp32 file written before the dot form has no ``bsq``: the loader
    recomputes the exact norms, as JAX's does."""
    data = _data(n=400, seed=6)
    ref, _ = _pair(data, train_rows=200, dim=32, num_cells=8,
                   cell_capacity=64)
    path = str(tmp_path / "old.npz")
    ref.save(path)
    old = dict(np.load(path))
    del old["bsq"]
    np.savez(path, **old)
    ours = IVFBank.load(path, device="cpu")
    np.testing.assert_allclose(ours._bsq, ref._bsq, rtol=1e-5)
    _same(ours.query(data[:8], k=4), JaxIVF.load(path).query(data[:8], k=4),
          data)


def test_train_with_replayed_draws_gives_jax_centroids():
    data = _data(n=600, seed=9)
    key = jax.random.PRNGKey(3)
    ref = JaxIVF(dim=32, num_cells=16)
    ref.train(data, key=key, iters=10)
    ours = IVFBank(dim=32, num_cells=16, device="cpu")
    ours.train(data, iters=10, seed_draws=_jax_seed_draws(key, len(data), 16))
    np.testing.assert_allclose(ours.centroids.numpy(),
                               np.asarray(ref.centroids), rtol=1e-5,
                               atol=1e-5)


def test_train_and_add_refuse_out_of_order():
    ours = IVFBank(dim=8, num_cells=4, device="cpu")
    with pytest.raises(RuntimeError, match="train must run before add"):
        ours.add(np.zeros((2, 8), np.float32))
    with pytest.raises(RuntimeError, match="train must run before save"):
        ours.save("unused.npz")


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_query_functions_match_jax(quantize):
    """``_ivf_query`` / ``_ivf_query_int8`` on the tensors of one layout,
    against JAX's functions on the same arrays, with a limit."""
    from gloc3d_tpu.index import ivf as jax_ivf
    from gloc3d_tpu_torch.index import ivf as port_ivf

    data = _unit_data(n=800, d=32, seed=11)
    ref, _ = _pair(data, dim=32, num_cells=8, cell_capacity=256,
                   quantize=quantize)
    q = data[:12] + 0.01
    arrays = [ref.centroids, ref._cells, ref._bsq, ref._ids]
    if quantize == "int8":
        arrays.insert(2, ref._scales)
        want = jax_ivf._ivf_query_int8(
            *map(jnp.asarray, arrays), jnp.asarray(q), 6, 3, jnp.int32(700))
        got = port_ivf._ivf_query_int8(
            *(torch.tensor(np.asarray(a)) for a in arrays),
            torch.from_numpy(q), 6, 3, 700)
    else:
        want = jax_ivf._ivf_query(
            *map(jnp.asarray, arrays), jnp.asarray(q), 6, 3, jnp.int32(700))
        got = port_ivf._ivf_query(
            *(torch.tensor(np.asarray(a)) for a in arrays),
            torch.from_numpy(q), 6, 3, 700)
    assert (got[1] < 700).all()
    _same((got[0].numpy(), got[1].numpy()), want, data)
