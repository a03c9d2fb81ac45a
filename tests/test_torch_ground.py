"""ops/ground.py: the port's ground estimator against the JAX package.

The JAX function draws from a PRNG key that torch cannot replay, so the
parity tests replay JAX's own draws: the subsample priorities
``uniform(k_samp)`` and ``categorical(k_tri)`` over the port's ground mask,
handed to the port through its injectable draws. Plane and transform agree
to 1e-4 (the port refits in float64, JAX in float32, and the two frameworks'
kNN distance matrices round differently). The scene tests are those of
tests/test_ground.py, run on the port with its own seeded draws. The
batched estimator (``estimate_ground_batch``) is held to
``jax.jit(jax.vmap(estimate_ground))`` on the same replayed draws, and to
the port's own one-scan calls bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gloc3d_tpu.config import GroundConfig
from gloc3d_tpu.ops.ground import _smallest_eigvec_3x3 as jax_eigvec
from gloc3d_tpu.ops.ground import estimate_ground as jax_estimate
from gloc3d_tpu_torch.core.transforms import (
    get_yaw, quat_from_rpy, quat_rotate, transform_points,
)
from gloc3d_tpu_torch.kernels.knn_normals import _smallest_eigvec_3x3
from gloc3d_tpu_torch.ops.ground import (
    _plane_from_triplets, batch_ground_draws, estimate_ground,
    estimate_ground_batch, triplets_from,
)
from test_ground import make_scene
from test_pipeline_ground import CFG as ALIGNED_CFG
from test_pipeline_ground import tilted_scan
from test_torch_threads import _two_threads  # noqa: F401


CFG = GroundConfig(num_candidates=1024, ransac_iters=128)


def _scene(roll, pitch, height, seed):
    return np.asarray(make_scene(roll, pitch, height, seed=seed), np.float32)


def _replayed_draws(key, n):
    """JAX's draws of estimate_ground(…, key), in the port's form."""
    k_samp, k_tri = jax.random.split(key)
    prio = torch.from_numpy(np.asarray(jax.random.uniform(k_samp, (n,))))

    def sample_triplets(ground_ok, h):
        logits = jnp.where(jnp.asarray(ground_ok.cpu().numpy()), 0.0,
                           -jnp.inf)
        tri = jax.random.categorical(k_tri, logits[None, :], shape=(3, h))
        return torch.from_numpy(np.asarray(tri).astype(np.int64))

    return prio, sample_triplets


@pytest.mark.parametrize("roll,pitch,height,seed,pad", [
    (0.0, 0.0, 1.7, 0, 0), (0.06, -0.04, 1.73, 1, 0),
    (0.02, 0.02, 1.7, 3, 500),
])
def test_matches_jax_with_replayed_draws(roll, pitch, height, seed, pad):
    pts = _scene(roll, pitch, height, seed)
    pts = np.concatenate([pts, np.zeros((pad, 3), np.float32)])
    mask = np.concatenate([np.ones(len(pts) - pad, np.float32),
                           np.zeros(pad, np.float32)])
    key = jax.random.PRNGKey(seed + 10)
    prio, sampler = _replayed_draws(key, len(pts))
    got = estimate_ground(torch.from_numpy(pts), torch.from_numpy(mask), CFG,
                          priority=prio, sample_triplets=sampler)
    want = jax_estimate(jnp.asarray(pts), jnp.asarray(mask), CFG, key)
    assert bool(got.valid) == bool(want.valid)
    np.testing.assert_allclose(got.plane.numpy(), np.asarray(want.plane),
                               atol=1e-4)
    np.testing.assert_allclose(got.transform.rotation.numpy(),
                               np.asarray(want.transform.rotation), atol=1e-4)
    np.testing.assert_allclose(got.transform.translation.numpy(),
                               np.asarray(want.transform.translation),
                               atol=1e-4)
    assert float(got.inlier_fraction) == pytest.approx(
        float(want.inlier_fraction), abs=1e-3)


# the tilted keyframes of tests/test_torch_i2i.py's aligned map
TILTED = [((-30, -30, 0.0), (0.02, -0.01)), ((0, -30, 0.4), (-0.015, 0.02)),
          ((30, 0, 1.5), (0.01, 0.015))]


@pytest.mark.parametrize("scan,seed", [(0, 0), (1, 1), (2, 2), (2, 12)])
def test_tilted_scans_match_jax_with_replayed_draws(scan, seed):
    """The aligned map's scans with the i2i test's draws. Scan 1 at seed 1
    draws a triplet whose p1 and p2 coincide: JAX's fp32 normal for it is
    a rounding residue with 41 inliers, and the port, which had counted
    every point on its float64 zero plane, picked a plane 6.4 mm higher
    (ROADMAP Queue 3 item 7). Scan 2 at seed 12 draws one that repeats p0,
    whose zero plane both packages count whole, and JAX picks it."""
    pose, (roll, pitch) = TILTED[scan]
    pts, mask = tilted_scan(*pose, roll=roll, pitch=pitch, seed=seed)
    _, sub = jax.random.split(jax.random.PRNGKey(4))
    key = jax.random.split(sub, 3)[scan]
    prio, sampler = _replayed_draws(key, len(pts))
    cfg = ALIGNED_CFG.ground
    got = estimate_ground(torch.from_numpy(pts), torch.from_numpy(mask), cfg,
                          priority=prio, sample_triplets=sampler)
    want = jax_estimate(jnp.asarray(pts), jnp.asarray(mask), cfg, key)
    np.testing.assert_allclose(got.plane.numpy(), np.asarray(want.plane),
                               atol=1e-5)
    np.testing.assert_allclose(got.transform.rotation.numpy(),
                               np.asarray(want.transform.rotation), atol=1e-5)
    np.testing.assert_allclose(got.transform.translation.numpy(),
                               np.asarray(want.transform.translation),
                               atol=1e-5)
    assert float(got.inlier_fraction) == float(want.inlier_fraction)


def _batch_scans():
    """A tilted scan, a flat one and an all-masked one, in one batch."""
    scans = [tilted_scan(-30, -30, 0.0, roll=0.02, pitch=-0.01, seed=0),
             tilted_scan(0, -30, 0.4, roll=0.0, pitch=0.0, seed=1),
             tilted_scan(30, 0, 1.5, roll=0.01, pitch=0.015, seed=2)]
    pts = np.stack([p for p, _ in scans])
    mask = np.stack([m for _, m in scans])
    mask[2] = 0.0
    return pts, mask


def _stacked(draws):
    """Per-scan (priority, sampler) pairs as the batched estimator's
    (priority (B, N), sampler over (B, M) rows)."""
    def sample(ground_ok, h):
        return torch.stack([smp(ok, h) for (_, smp), ok
                            in zip(draws, ground_ok)])

    return torch.stack([p for p, _ in draws]), sample


def _fields(est):
    return (est.transform.rotation, est.transform.translation, est.plane,
            est.valid, est.inlier_fraction)


def test_batch_matches_jax_vmap_with_replayed_draws():
    """B = 3 against ``jax.jit(jax.vmap(estimate_ground))``, each scan on
    its own key's draws, at the 1e-5 bound of the tilted-scan test above;
    the all-masked scan is invalid and the identity in both."""
    pts, mask = _batch_scans()
    cfg = ALIGNED_CFG.ground
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    prio, sampler = _stacked([_replayed_draws(k, pts.shape[1])
                              for k in keys])
    got = estimate_ground_batch(torch.from_numpy(pts),
                                torch.from_numpy(mask), cfg,
                                priority=prio, sample_triplets=sampler)
    want = jax.jit(jax.vmap(lambda p, m, k: jax_estimate(p, m, cfg, k)))(
        jnp.asarray(pts), jnp.asarray(mask), keys)
    np.testing.assert_array_equal(got.valid.numpy(), [True, True, False])
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    for g, w in zip(_fields(got)[:3], _fields(want)[:3]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    np.testing.assert_array_equal(got.transform.rotation[2].numpy(),
                                  [1.0, 0.0, 0.0, 0.0])
    np.testing.assert_array_equal(got.transform.translation[2].numpy(), 0.0)
    np.testing.assert_array_equal(got.inlier_fraction.numpy(),
                                  np.asarray(want.inlier_fraction))


@pytest.mark.parametrize("draws", ["replayed", "generator"])
def test_batch_equals_one_scan_calls(draws):
    """The batch against three one-scan calls, bit for bit: on JAX's
    replayed draws, and on the default draws of one generator, which the
    batch takes scan by scan as the one-scan calls do (the generator ends
    in the same state, and ``batch_ground_draws`` gives the same numbers)."""
    pts, mask = _batch_scans()
    pts, mask = torch.from_numpy(pts), torch.from_numpy(mask)
    cfg = ALIGNED_CFG.ground
    if draws == "replayed":
        per_scan = [_replayed_draws(k, pts.shape[1])
                    for k in jax.random.split(jax.random.PRNGKey(8), 3)]
        prio, sampler = _stacked(per_scan)
        got = estimate_ground_batch(pts, mask, cfg, priority=prio,
                                    sample_triplets=sampler)
        want = [estimate_ground(pts[i], mask[i], cfg, priority=p,
                                sample_triplets=smp)
                for i, (p, smp) in enumerate(per_scan)]
    else:
        gen = torch.Generator().manual_seed(9)
        got = estimate_ground_batch(pts, mask, cfg, gen)
        gen_one = torch.Generator().manual_seed(9)
        want = [estimate_ground(pts[i], mask[i], cfg, gen_one)
                for i in range(3)]
        assert torch.equal(gen.get_state(), gen_one.get_state())
        prio, uni = batch_ground_draws(3, pts.shape[1], cfg,
                                       torch.Generator().manual_seed(9))
        again = estimate_ground_batch(pts, mask, cfg, priority=prio,
                                      sample_triplets=triplets_from(uni))
        for g, a in zip(_fields(got), _fields(again)):
            assert torch.equal(g, a)
    for i, one in enumerate(want):
        for g, w in zip(_fields(got), _fields(one)):
            assert torch.equal(g[i], w)


def test_repeated_point_triplets():
    """A triplet that repeats p0 gives the zero plane, which every point
    lies on (as in JAX); one whose p1 and p2 coincide away from p0 counts
    no inliers; three distinct points span their plane."""
    p = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
                     dtype=torch.float64)
    planes, counts = _plane_from_triplets(p[[0, 0, 0, 1]], p[[0, 1, 1, 1]],
                                          p[[1, 0, 1, 1]])
    assert counts.tolist() == [True, True, False, True]
    np.testing.assert_array_equal(planes[[0, 1, 3]].numpy(), 0.0)
    planes, counts = _plane_from_triplets(p[:1], p[1:2], p[2:])
    assert counts.tolist() == [True]
    np.testing.assert_allclose(planes.numpy(), [[0.0, 0.0, 1.0, 0.0]])


def _estimate(pts, mask=None, seed=0):
    pts = torch.as_tensor(pts)
    mask = torch.ones(pts.shape[0]) if mask is None else mask
    return estimate_ground(pts, mask, CFG,
                           torch.Generator().manual_seed(seed))


def test_flat_ground_identity():
    pts = _scene(0.0, 0.0, 1.7, 0)
    est = _estimate(pts)
    assert bool(est.valid)
    np.testing.assert_allclose(est.plane[:3].numpy(), [0, 0, 1], atol=0.02)
    assert abs(abs(float(est.plane[3])) - 1.7) < 0.05
    out = transform_points(est.transform, torch.from_numpy(pts))
    assert abs(float(out[:2000, 2].median())) < 0.05


def test_tilted_ground_aligns_yaw_free():
    pts = _scene(0.06, -0.04, 1.73, 1)
    est = _estimate(pts, seed=1)
    assert bool(est.valid)
    out = transform_points(est.transform, torch.from_numpy(pts))
    assert abs(float(out[:2000, 2].median())) < 0.05
    assert abs(float(get_yaw(est.transform.rotation))) < 1e-4


def test_yaw_invariance():
    pts = torch.from_numpy(_scene(0.05, 0.03, 1.5, 2))
    z = torch.tensor(0.0)
    qz = quat_from_rpy(z, z, torch.tensor(1.2))
    yawed = quat_rotate(qz[None, :], pts)
    for cloud in (pts, yawed):
        est = _estimate(cloud, seed=3)
        out = transform_points(est.transform, cloud)
        assert abs(float(out[:2000, 2].median())) < 0.05


def test_masked_padding():
    pts = _scene(0.02, 0.02, 1.7, 3)
    n = len(pts)
    padded = torch.zeros(n + 500, 3)
    padded[:n] = torch.from_numpy(pts)
    mask = torch.zeros(n + 500)
    mask[:n] = 1.0
    est = _estimate(padded, mask, seed=4)
    assert bool(est.valid)
    assert float(est.inlier_fraction) > 0.4


def test_all_masked_scan_is_identity_and_does_not_raise():
    """No candidate at all: no near-vertical bin, so the estimate is invalid
    and the transform is the identity, as in the JAX function (the default
    triplet sampler must not fail on an all-zero weight row)."""
    pts = torch.from_numpy(_scene(0.02, 0.02, 1.7, 3))
    est = _estimate(pts, torch.zeros(pts.shape[0]))
    want = jax_estimate(jnp.asarray(pts.numpy()), jnp.zeros(pts.shape[0]),
                        CFG, jax.random.PRNGKey(0))
    assert not bool(est.valid) and not bool(want.valid)
    np.testing.assert_array_equal(est.transform.rotation.numpy(),
                                  np.asarray(want.transform.rotation))
    np.testing.assert_array_equal(est.transform.translation.numpy(),
                                  np.asarray(want.transform.translation))
    assert float(est.inlier_fraction) == float(want.inlier_fraction) == 0.0


def test_default_draws_follow_the_generator():
    pts = torch.from_numpy(_scene(0.06, -0.04, 1.73, 1))
    a, b = _estimate(pts, seed=5), _estimate(pts, seed=5)
    np.testing.assert_array_equal(a.transform.rotation.numpy(),
                                  b.transform.rotation.numpy())
    np.testing.assert_array_equal(a.plane.numpy(), b.plane.numpy())


def test_smallest_eigvec_matches_jax_and_eigh():
    rng = np.random.RandomState(3)
    mats = []
    for _ in range(200):
        a = rng.randn(5, 3)
        mats.append(a.T @ a / 5)
    a = np.stack(mats).astype(np.float32)
    got = _smallest_eigvec_3x3(torch.from_numpy(a)).numpy()
    want = np.asarray(jax_eigvec(jnp.asarray(a)))
    # the column the closed form picks fixes the sign; a near-tie between
    # two columns may flip it, so compare up to sign (fp32, 1e-5)
    np.testing.assert_allclose(np.abs(np.sum(got * want, -1)), 1.0,
                               atol=1e-5)
    _, vecs = np.linalg.eigh(a.astype(np.float64))
    np.testing.assert_allclose(np.abs(np.sum(got * vecs[..., 0], -1)), 1.0,
                               atol=2e-3)


def test_smallest_eigvec_degenerate():
    a = np.zeros((3, 3, 3), np.float32)
    a[1] = np.eye(3)
    a[2] = 2.5 * np.eye(3)
    got = _smallest_eigvec_3x3(torch.from_numpy(a)).numpy()
    want = np.asarray(jax_eigvec(jnp.asarray(a)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.tile([0.0, 0.0, 1.0], (3, 1)))
