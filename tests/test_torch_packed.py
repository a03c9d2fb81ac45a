"""The port's packed and pillar-sorted PointPillar against the JAX package's,
on the CPU at fp32.

``pack_points`` against JAX's, all 16 channels (atol 1e-6; the voxel index
and mask channels exact); ``PointPillarPacked`` against the port's
``PointPillar`` and JAX's ``PointPillar`` end to end (atol 1e-5, the bound
of JAX's own ``test_packed_equals_fused``); ``points_to_voxels_presorted``
and ``PointPillarSorted`` against JAX's on the same host-sorted input (the
port's host pass; atol 1e-5, or twice JAX's own floor where its cumsum
sums exceed that, see the test); one state dict loads strictly into all
three variants. K2 and K1 run their plain versions here; JAX's sorted path runs
its cumsum segment sums. The small grid of JAX's own test: 256-point
clouds on (-10, 10) × (-6, 6) at 0.5 m.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gloc3d_tpu.models.packed import PointPillarPacked as JaxPacked
from gloc3d_tpu.models.packed import PointPillarSorted as JaxSorted
from gloc3d_tpu.models.packed import pack_points as jax_pack_points
from gloc3d_tpu.models.pointpillar import PointPillar as JaxPointPillar
from gloc3d_tpu.ops.voxelize import points_to_voxels as jax_points_to_voxels
from gloc3d_tpu.ops.voxelize import (
    points_to_voxels_presorted as jax_presorted,
)
from gloc3d_tpu_torch.convert import pointpillar_state_dict
from gloc3d_tpu_torch.data.native import compute_voxel_stats_host_sorted
from gloc3d_tpu_torch.models.packed import (
    PointPillarPacked, PointPillarSorted, pack_points,
)
from gloc3d_tpu_torch.models.pointpillar import PointPillar
from gloc3d_tpu_torch.ops.voxelize import points_to_voxels_presorted
from test_packed_export import XB, YB, ZB, _scan
from test_torch_threads import _two_threads  # noqa: F401

N = 256
# every point a real row, then padding: the host pass takes a prefix count
PREFIX = (200, 240)


def _np(x):
    return np.asarray(x, np.float32)


def _masked_scan():
    pts, mask = _scan(b=2)
    return _np(pts).copy(), _np(mask).copy()


def _prefix_scan():
    pts, _ = _scan(seed=4, b=2)
    pts = _np(pts).copy()
    mask = np.zeros((2, N), np.float32)
    for i, n in enumerate(PREFIX):
        mask[i, :n] = 1.0
        pts[i, n:] = 0.0
    pts[0, 5, :2] = (-10.2, 3.0)  # out of the grid: pillar 0, not valid
    return pts, mask


@functools.lru_cache(maxsize=None)
def _jax_variables():
    pts, mask = _masked_scan()
    model = JaxPointPillar(xbound=XB, ybound=YB, zbound=ZB,
                           compute_dtype=jnp.float32)
    return model, jax.jit(model.init)(jax.random.PRNGKey(0),
                                      jnp.asarray(pts), jnp.asarray(mask))


def _state_dict():
    _, variables = _jax_variables()
    return pointpillar_state_dict(variables["params"],
                                  variables["batch_stats"], prefix="")


def _port(cls):
    model = cls(XB, YB, ZB, torch.float32)
    model.load_state_dict(_state_dict())
    return model.eval()


def test_pack_points_matches_jax():
    pts, mask = _masked_scan()
    want = _np(jax.jit(lambda p, m: jax_pack_points(p, m, XB, YB, ZB))(
        jnp.asarray(pts), jnp.asarray(mask)))
    got = pack_points(torch.from_numpy(pts), torch.from_numpy(mask),
                      XB, YB, ZB).numpy()
    assert got.shape == want.shape == (2, N, 16)
    np.testing.assert_array_equal(got[..., 14:], want[..., 14:])
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_packed_equals_fused_and_jax():
    pts, mask = _masked_scan()
    model, variables = _jax_variables()
    want = _np(jax.jit(model.apply)(variables, jnp.asarray(pts),
                                    jnp.asarray(mask)))
    packed_model = JaxPacked(xbound=XB, ybound=YB, zbound=ZB,
                             compute_dtype=jnp.float32)
    jax_packed = _np(jax.jit(lambda v, p, m: packed_model.apply(
        v, jax_pack_points(p, m, XB, YB, ZB)))(
        variables, jnp.asarray(pts), jnp.asarray(mask)))
    tp, tm = torch.from_numpy(pts), torch.from_numpy(mask)
    with torch.no_grad():
        packed = _port(PointPillarPacked)(pack_points(tp, tm, XB, YB, ZB))
        fused = _port(PointPillar)(tp, tm)
    assert packed.shape == (2, 24, 40, 128)
    np.testing.assert_allclose(packed.numpy(), fused.numpy(), atol=1e-5)
    np.testing.assert_allclose(packed.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(packed.numpy(), jax_packed, atol=1e-5)


def _host_sorted():
    pts, mask = _prefix_scan()
    p, v, ids, _, _, starts = compute_voxel_stats_host_sorted(
        pts, mask.sum(1).astype(np.int64), XB, YB, ZB, crop=False)
    return pts, mask, (p, v, ids, starts)


@pytest.mark.parametrize("key", [
    "voxel_point_count", "point_centroids", "local_points_xyz",
    "points_per_voxel", "raw_counts", "points_mask", "voxel_centers"])
def test_points_to_voxels_presorted_matches_jax(key):
    """Against JAX's presorted function, and against JAX's scatter
    ``points_to_voxels`` on the same sorted points (atol 1e-5). JAX's
    presorted sums are one cumsum over all rows, differenced at the
    starts, and pillar 0's padding rows (9.75 m from its centre) come
    first: every later pillar's sum carries the rounding of a running sum
    near 700, 5.6e-5 on the centroids against JAX's own scatter. The
    bound against JAX's presorted function is therefore twice that floor,
    measured in the run, where it exceeds 1e-5."""
    _, _, (p, v, ids, starts) = _host_sorted()
    xyz = jnp.asarray(p[..., :3])
    want = jax_presorted(xyz, jnp.asarray(v), jnp.asarray(ids),
                         jnp.asarray(starts), XB, YB, ZB)
    fused = jax_points_to_voxels(xyz, jnp.asarray(v), XB, YB, ZB)
    got = points_to_voxels_presorted(
        torch.from_numpy(p[..., :3]), torch.from_numpy(v),
        torch.from_numpy(ids), torch.from_numpy(starts), XB, YB, ZB)
    floor = float(np.abs(_np(want[key]) - _np(fused[key])).max())
    assert got[key].shape == want[key].shape
    np.testing.assert_allclose(got[key].numpy(), _np(want[key]),
                               atol=max(1e-5, 2 * floor))
    np.testing.assert_allclose(got[key].numpy(), _np(fused[key]), atol=1e-5)
    np.testing.assert_array_equal(got["voxel_indices"].numpy(), ids)


def test_sorted_equals_fused_and_jax():
    pts, mask, (p, v, ids, starts) = _host_sorted()
    _, variables = _jax_variables()
    want = _np(jax.jit(JaxSorted(xbound=XB, ybound=YB, zbound=ZB,
                                 compute_dtype=jnp.float32).apply)(
        variables, *map(jnp.asarray, (p, v, ids, starts))))
    with torch.no_grad():
        got = _port(PointPillarSorted)(*map(torch.from_numpy,
                                            (p, v, ids, starts)))
        fused = _port(PointPillar)(torch.from_numpy(pts),
                                   torch.from_numpy(mask))
    assert got.shape == (2, 24, 40, 128)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), fused.numpy(), atol=1e-5)


def test_weights_transfer_between_the_three_variants():
    sd = _state_dict()
    names = []
    for cls in (PointPillar, PointPillarPacked, PointPillarSorted):
        model = cls(XB, YB, ZB, torch.float32)
        model.load_state_dict(sd)  # strict
        names.append(sorted(model.state_dict()))
        assert all(torch.equal(model.state_dict()[k], v)
                   for k, v in sd.items())
    assert names[0] == names[1] == names[2] == sorted(sd)
