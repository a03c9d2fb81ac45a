"""Mining, k-means and NetVLAD's data init against the JAX package.

torch cannot replay JAX PRNG streams, so the draws are replayed: JAX's
categorical negative sample goes into ``mine_triplets(samples=...)``, and
k-means++ gets JAX's first seed index and Gumbel noise (``categorical`` is
``argmax(logits + gumbel)``). With the same draws the mined indices are
equal and the centroids agree within rtol 1e-5 (fp32 matmuls and sums in
another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gloc3d_tpu.index.kmeans import kmeans as jax_kmeans
from gloc3d_tpu.models.netvlad import NetVLAD as JaxNetVLAD
from gloc3d_tpu.models.netvlad import init_netvlad_params as jax_init
from gloc3d_tpu.train.mining import mine_triplets as jax_mine
from gloc3d_tpu_torch.convert import netvlad_state_dict
from gloc3d_tpu_torch.index.kmeans import kmeans
from gloc3d_tpu_torch.models.netvlad import NetVLAD, init_netvlad_params
from gloc3d_tpu_torch.train.mining import (
    mine_other_negative, mine_triplets,
)
from test_torch_threads import _two_threads  # noqa: F401


def _world(seed, ndb=64, nq=6, d=16):
    rng = np.random.RandomState(seed)
    utm_db = rng.uniform(0, 120, (ndb, 2))
    utm_q = utm_db[rng.choice(ndb, nq, replace=False)] + rng.uniform(
        -4, 4, (nq, 2))
    dist = np.linalg.norm(utm_q[:, None] - utm_db[None], axis=-1)
    cache_db = rng.randn(ndb, d).astype(np.float32)
    cache_q = rng.randn(nq, d).astype(np.float32)
    neg_cache = rng.randint(0, ndb, (nq, 3)).astype(np.int32)
    return cache_db, cache_q, dist <= 10.0, dist > 20.0, neg_cache


CASES = [(0, 0.1), (1, 2.0), (2, 0.5)]


def _mine_both(seed, margin):
    """Mine with JAX and with the port on JAX's draws; assert equality and
    return the port's neg_valid."""
    cache_db, cache_q, pos_mask, neg_mask, neg_cache = _world(seed)
    qidx = np.array([0, 2, 3, 5])
    key = jax.random.PRNGKey(seed)
    n_neg, n_sample = 3, 24
    want = jax_mine(jnp.asarray(cache_db), jnp.asarray(cache_q),
                    jnp.asarray(qidx), jnp.asarray(pos_mask),
                    jnp.asarray(neg_mask), jnp.asarray(neg_cache), key,
                    margin, n_neg, n_sample)
    # the draw inside jax's mine_triplets, replayed
    logits = jnp.where(jnp.asarray(neg_mask[qidx]), 0.0, -jnp.inf)
    samp = np.array(jax.random.categorical(
        key, logits, axis=-1, shape=(n_sample, len(qidx))).T)
    got = mine_triplets(torch.from_numpy(cache_db), torch.from_numpy(cache_q),
                        torch.from_numpy(qidx), torch.from_numpy(pos_mask),
                        torch.from_numpy(neg_mask),
                        torch.from_numpy(neg_cache), margin, n_neg, n_sample,
                        samples=torch.from_numpy(samp))
    for name in ("pos_idx", "neg_idx", "neg_valid", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.d_pos.numpy(), np.asarray(want.d_pos),
                               rtol=1e-5)
    return got.neg_valid.numpy()


@pytest.mark.parametrize("seed,margin", CASES)
def test_mine_triplets_matches_jax_with_replayed_draws(seed, margin):
    _mine_both(seed, margin)


def test_replayed_cases_fill_some_slots_and_not_others():
    filled = [_mine_both(s, m).mean() for s, m in CASES]
    assert min(filled) < 1.0 and max(filled) > 0.0, filled


def test_mine_triplets_semantics():
    """tests/test_train.py::test_mine_triplets_semantics on the port, with
    the default (generator) draw."""
    rng = np.random.RandomState(0)
    d, ndb, nq = 8, 32, 4
    cache_db = rng.randn(ndb, d).astype(np.float32)
    cache_q = rng.randn(nq, d).astype(np.float32)
    cache_q[0] = cache_db[3] + 0.01
    cache_db[10] = cache_q[0] + 0.02  # very close negative
    pos_mask = np.zeros((nq, ndb), bool)
    pos_mask[:, 3] = True
    neg_mask = np.ones((nq, ndb), bool)
    neg_mask[:, 3] = False
    mined = mine_triplets(
        torch.from_numpy(cache_db), torch.from_numpy(cache_q),
        torch.arange(4), torch.from_numpy(pos_mask),
        torch.from_numpy(neg_mask), torch.zeros((nq, 3), dtype=torch.long),
        margin=0.1, n_neg=3, n_sample=256,  # db 10 drawn: P(miss) ~2e-4
        generator=torch.Generator().manual_seed(0))
    assert int(mined.pos_idx[0]) == 3
    assert bool(mined.valid[0])
    assert int(mined.neg_idx[0, 0]) == 10
    sel = mined.neg_idx.numpy()[mined.neg_valid.numpy() > 0]
    assert not np.isin(sel, [3]).any()


def test_mine_no_violators_invalid():
    d = 4
    cache_db = 100.0 + np.arange(8 * d, dtype=np.float32).reshape(8, d)
    cache_q = np.zeros((1, d), np.float32)
    cache_db[0] = cache_q[0]  # identical positive: d_pos = 0
    pos_mask = np.zeros((1, 8), bool)
    pos_mask[0, 0] = True
    mined = mine_triplets(
        torch.from_numpy(cache_db), torch.from_numpy(cache_q),
        torch.zeros(1, dtype=torch.long), torch.from_numpy(pos_mask),
        torch.from_numpy(~pos_mask), torch.zeros((1, 3), dtype=torch.long),
        margin=0.1, n_neg=3, n_sample=16,
        generator=torch.Generator().manual_seed(1))
    assert not bool(mined.valid[0])
    assert float(mined.neg_valid.sum()) == 0.0


def test_mine_other_negative_is_eligible():
    _, _, _, neg_mask, _ = _world(4)
    qidx = torch.tensor([0, 1, 2])
    neg_idx = torch.tensor([[5, 6, 7], [1, 2, 3], [9, 9, 9]])
    gen = torch.Generator().manual_seed(0)
    nm = torch.from_numpy(neg_mask)
    for _ in range(20):
        other = mine_other_negative(nm, qidx, neg_idx, gen)
        for i, o in enumerate(other.tolist()):
            assert neg_mask[int(qidx[i]), o] and o not in neg_idx[i].tolist()


def _jax_seed_draws(key, n, k):
    """k-means++'s draws inside jax's kmeans: the first index, then one
    categorical per further seed (argmax of logits + gumbel)."""
    key, k0 = jax.random.split(key)
    first = int(jax.random.randint(k0, (), 0, n))
    gumbel = np.stack([np.asarray(jax.random.gumbel(sk, (n,), jnp.float32))
                       for sk in jax.random.split(key, k - 1)])
    return first, gumbel


@pytest.mark.parametrize("case", ["blobs", "duplicates"])
def test_kmeans_matches_jax_with_replayed_seeding(case):
    rng = np.random.RandomState(0)
    if case == "blobs":
        k, centers = 6, rng.randn(6, 8) * 4
        data = np.concatenate([c + rng.randn(60, 8) * 0.5 for c in centers])
    else:  # 3 distinct points, 5 clusters: empty clusters get re-seeded
        k = 5
        data = np.repeat(rng.randn(3, 8), 20, axis=0)
    data = data.astype(np.float32)
    key = jax.random.PRNGKey(5)
    want_c, want_a = jax_kmeans(key, jnp.asarray(data), k, num_iters=20)
    got_c, got_a = kmeans(torch.from_numpy(data), k, num_iters=20,
                          seed_draws=_jax_seed_draws(key, len(data), k))
    if case == "blobs":
        np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
        return
    # Each point's distance to its own centroid is 0 up to rounding, so the
    # point that re-seeds an empty cluster, argmax of those distances, is
    # set by the rounding residues of ‖x‖² − 2x·c + ‖c‖² (1.9e-6, 2.4e-7
    # or 0 for the three points in both packages, in an order that the
    # matmul's summation order sets). Assert what JAX's result fixes on
    # every machine: each centroid is one of the 3 points, each point lies
    # on its centroid, and the within-cluster cost equals JAX's.
    points = data[::20]
    for cents, assign in ((got_c.numpy(), got_a.numpy()),
                          (np.asarray(want_c), np.asarray(want_a))):
        to_point = np.linalg.norm(cents[:, None] - points[None], axis=-1)
        assert (to_point.min(1) <= 1e-5).all(), to_point.min(1)
        assert (np.linalg.norm(data - cents[assign], axis=-1) <= 1e-5).all()

    def cost(cents, assign):
        return float(((data - cents[assign]) ** 2).sum())

    assert cost(got_c.numpy(), got_a.numpy()) == pytest.approx(
        cost(np.asarray(want_c), np.asarray(want_a)), abs=1e-5)


@pytest.mark.parametrize("vladv2", [False, True])
def test_init_netvlad_params_matches_jax(vladv2):
    rng = np.random.RandomState(1)
    k, d = 8, 16
    descs = rng.randn(300, d).astype(np.float32)
    descs /= np.linalg.norm(descs, axis=1, keepdims=True)
    clusters = descs[rng.choice(300, k, replace=False)] + 0.05 * rng.randn(
        k, d).astype(np.float32)
    ref = JaxNetVLAD(num_clusters=k, dim=d, vladv2=vladv2)
    x = rng.randn(1, 3, 3, d).astype(np.float32)
    params = ref.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = netvlad_state_dict(jax_init(params, clusters, descs, vladv2))
    port = NetVLAD(num_clusters=k, dim=d, vladv2=vladv2)
    init_netvlad_params(port, clusters, descs, vladv2)
    got = port.state_dict()
    assert set(got) == set(want)
    initialised = ["centroids", "conv.weight"] + ["conv.bias"] * vladv2
    for name in initialised:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
