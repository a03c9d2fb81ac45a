"""ops/bev.py: the port's on-device BEV against the JAX ``scan_to_bev`` and
the host pass ``compute_bev_host``, on the same float inputs.

Bit-equal: after the first rounding of each coordinate the projection is
integer math, so image, origin and occupied count must agree exactly, in
both branches (no rotation, the serving one; and a given alignment
rotation), in the crop and the pad regime, and for an empty scan."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gloc3d_tpu.config import BEVConfig
from gloc3d_tpu.core.transforms import quat_from_rpy
from gloc3d_tpu.data.native import compute_bev_host
from gloc3d_tpu.ops.bev import scan_to_bev as jax_bev
from gloc3d_tpu_torch.ops.bev import batch_scan_to_bev, scan_to_bev
from test_pipeline import scan_at
from test_torch_threads import _two_threads  # noqa: F401


N_PTS = 4096
CFG = BEVConfig(image_size=128, max_points=N_PTS)


def _scans():
    """Crop regime (35 m view > 128 px), pad regime (8 m view), a scan
    with returns beyond max_range and below z_min, and an empty scan."""
    a = scan_at(3, -5, 0.7, n=N_PTS)
    b = scan_at(-10, 12, 2.5, view_radius=8.0, n=N_PTS)
    c = scan_at(20, 0, -1.0, n=N_PTS)
    c[0][:50, 0] += 150.0      # beyond max_range
    c[0][50:80, 2] = -60.0     # below z_min
    empty = (np.zeros_like(a[0]), np.zeros_like(a[1]))
    pts = np.stack([s[0][:, :3] for s in (a, b, c, empty)])
    mask = np.stack([s[1] for s in (a, b, c, empty)])
    return pts, mask


def _assert_same(got, image, origin, nocc):
    np.testing.assert_array_equal(got.image.numpy(), np.asarray(image))
    np.testing.assert_array_equal(got.origin_xy.numpy(), np.asarray(origin))
    np.testing.assert_array_equal(got.num_occupied.numpy(), np.asarray(nocc))


def test_matches_jax_and_host_pass_no_rotation():
    pts, mask = _scans()
    got = batch_scan_to_bev(torch.from_numpy(pts), torch.from_numpy(mask),
                            CFG)
    want = jax.vmap(lambda p, m: jax_bev(p, m, CFG))(jnp.asarray(pts),
                                                     jnp.asarray(mask))
    _assert_same(got, want.image, want.origin_xy, want.num_occupied)
    imgs, origins, nocc = compute_bev_host(
        pts, np.asarray(mask.sum(1), np.int64), CFG)
    _assert_same(got, imgs, origins, nocc)
    assert int(got.num_occupied[3]) == 0
    assert (got.image[3] == CFG.free_value).all()
    assert (got.origin_xy[3] == 0).all()


def test_rotation_branch_matches_jax():
    pts, mask = _scans()
    rpy = np.array([[0.03, -0.02, 0.4], [-0.05, 0.01, -2.0],
                    [0.0, 0.04, 1.0], [0.01, 0.01, 0.0]], np.float32)
    q = np.asarray(quat_from_rpy(*jnp.asarray(rpy.T)))
    got = batch_scan_to_bev(torch.from_numpy(pts), torch.from_numpy(mask),
                            CFG, torch.from_numpy(q))
    want = jax.vmap(lambda p, m, r: jax_bev(p, m, CFG, r))(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(q))
    _assert_same(got, want.image, want.origin_xy, want.num_occupied)


@pytest.mark.parametrize("rotated", [False, True])
def test_one_scan_view(rotated):
    pts, mask = _scans()
    q = np.array([0.999, 0.02, -0.03, 0.01], np.float32)
    q /= np.linalg.norm(q)
    rot_t = torch.from_numpy(q) if rotated else None
    got = scan_to_bev(torch.from_numpy(pts[0]), torch.from_numpy(mask[0]),
                      CFG, rot_t)
    want = jax_bev(jnp.asarray(pts[0]), jnp.asarray(mask[0]), CFG,
                   jnp.asarray(q) if rotated else None)
    _assert_same(got, want.image, want.origin_xy, want.num_occupied)
