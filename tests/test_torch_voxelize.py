"""Pillar features: port vs JAX.

Host-stats path, on the output of the shared host pass: exact for integer
outputs, 1e-6 for floats (the same IEEE fp32 elementwise ops on both sides).
On-device binning (``points_to_voxels`` and ``scatter_mean_to_grid``, the
port on kernel K2's plain version, JAX on its XLA scatter): integers exact,
floats 1e-5 (per-pillar fp32 sums taken in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gloc3d_tpu.config import VoxelConfig
from gloc3d_tpu.data.native import compute_voxel_stats_host_sorted
from gloc3d_tpu.ops.voxelize import points_to_voxels as jax_p2v
from gloc3d_tpu.ops.voxelize import points_to_voxels_hoststats as jax_vox
from gloc3d_tpu.ops.voxelize import scatter_mean_to_grid as jax_mean
from gloc3d_tpu_torch.ops.voxelize import (
    points_to_voxels, points_to_voxels_hoststats, scatter_mean_to_grid,
)
from test_pipeline import scan_at
from test_torch_threads import _two_threads  # noqa: F401


N_PTS = 2048
VC = VoxelConfig(max_points=N_PTS)


def _host_pass():
    scans = [scan_at(3, -5, 0.7, n=N_PTS), scan_at(-20, 10, 2.0, n=N_PTS)]
    pts = np.stack([s[0] for s in scans])
    # a few out-of-bounds rows and the padding alias into pillar 0
    pts[0, :5, 0] = 60.0
    counts = np.asarray([s[1].sum() for s in scans], np.int64)
    return compute_voxel_stats_host_sorted(
        pts, counts, VC.xbound, VC.ybound, VC.zbound, crop=False,
        per_point=True)


@pytest.mark.parametrize("with_per_point", [True, False])
def test_hoststats_matches_jax(with_per_point):
    p, v, i, c, g, _, pp = _host_pass()
    pp_arg = pp if with_per_point else None
    want = jax_vox(jnp.asarray(p[..., :3]), jnp.asarray(v), jnp.asarray(i),
                   jnp.asarray(c), jnp.asarray(g), VC.xbound, VC.ybound,
                   VC.zbound,
                   per_point=None if pp_arg is None else jnp.asarray(pp_arg))
    got = points_to_voxels_hoststats(
        torch.from_numpy(p[..., :3]), torch.from_numpy(v),
        torch.from_numpy(i), torch.from_numpy(c), torch.from_numpy(g),
        VC.xbound, VC.ybound, VC.zbound,
        per_point=None if pp_arg is None else torch.from_numpy(pp_arg))
    assert set(got) == set(want)
    assert got["grid_shape"] == want["grid_shape"] == (140, 80, 1)
    assert got["num_voxels"] == want["num_voxels"]
    for key in ("voxel_coords", "voxel_indices", "grid_size"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    for key, val in got.items():
        if isinstance(val, torch.Tensor) and val.is_floating_point():
            np.testing.assert_allclose(val.numpy(), np.asarray(want[key]),
                                       atol=1e-6, rtol=1e-6, err_msg=key)
    # pillar 0: the valid count excludes the padding its raw count holds
    assert float(got["points_per_voxel"][0, 0]) < float(
        got["raw_counts"][0, 0])


def _device_inputs():
    scans = [scan_at(3, -5, 0.7, n=N_PTS), scan_at(-20, 10, 2.0, n=N_PTS)]
    pts = np.stack([s[0][:, :3] for s in scans])
    mask = np.stack([s[1] for s in scans])
    pts[0, :5, 0] = 60.0       # out of the grid: aliases into pillar 0
    pts[1, 7, 1] = -20.3       # within one pillar below the grid: truncation
    return pts, mask


def test_points_to_voxels_matches_jax():
    pts, mask = _device_inputs()
    want = jax_p2v(jnp.asarray(pts), jnp.asarray(mask), VC.xbound, VC.ybound,
                   VC.zbound)
    got = points_to_voxels(torch.from_numpy(pts), torch.from_numpy(mask),
                           VC.xbound, VC.ybound, VC.zbound)
    assert set(got) == set(want)
    assert got["grid_shape"] == want["grid_shape"] == (140, 80, 1)
    assert got["num_voxels"] == want["num_voxels"]
    assert got["voxel_indices"].dtype == torch.int32
    for key, val in got.items():
        if not isinstance(val, torch.Tensor):
            continue
        if val.is_floating_point():
            np.testing.assert_allclose(val.numpy(), np.asarray(want[key]),
                                       atol=1e-5, rtol=1e-5, err_msg=key)
        else:
            np.testing.assert_array_equal(val.numpy(), np.asarray(want[key]),
                                          err_msg=key)
    # pillar 0: the raw count holds the padding, the valid count does not
    assert float(got["points_per_voxel"][0, 0]) < float(
        got["raw_counts"][0, 0])


@pytest.mark.parametrize("with_counts", [True, False])
def test_scatter_mean_to_grid_matches_jax(with_counts):
    pts, mask = _device_inputs()
    vox = points_to_voxels(torch.from_numpy(pts), torch.from_numpy(mask),
                           VC.xbound, VC.ybound, VC.zbound)
    rng = np.random.RandomState(0)
    feats = rng.randn(2, N_PTS, 64).astype(np.float32)
    feats *= vox["points_mask"].numpy()[..., None]  # PointNet zeroes padding
    ids = vox["voxel_indices"]
    counts = vox["raw_counts"] if with_counts else None
    got = scatter_mean_to_grid(torch.from_numpy(feats), ids,
                               vox["num_voxels"], counts=counts)
    want = jax_mean(jnp.asarray(feats), jnp.asarray(ids.numpy()),
                    vox["num_voxels"],
                    counts=None if counts is None else jnp.asarray(
                        counts.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
