"""Point → pillar binning: host-stats and on-device variants.

Port of ``gloc3d_tpu/ops/voxelize.py``:

- ``points_to_voxels_hoststats`` (the s2s serving path): the per-pillar
  counts, centroids, pillar sort and per-point rows come from the host pass
  (``data/native.py::compute_voxel_stats_host_sorted``), so the device does
  only elementwise math;
- ``points_to_voxels`` + ``scatter_mean_to_grid`` (the all-device path):
  the pillar statistics and the feature mean are unsorted segment sums on
  kernel K2 (``kernels/bin_sums.py``);
- ``points_to_voxels_presorted`` (``models/packed.py::PointPillarSorted``):
  pillar-sorted points whose statistics are sorted segment sums on kernel
  K1 (``kernels/segment_sum.py``).

Reference quirks kept: coordinates truncate toward zero (torch ``.int()``),
``voxel_centers`` come from the unclamped coordinates, padding and
out-of-grid rows alias to pillar 0 (so its centroid averages them in and
its raw count includes them), and the pillar ravel is x-major.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from gloc3d_tpu_torch.kernels.bin_sums import (
    pillar_bin_sums, pillar_bin_sums_grad,
)
from gloc3d_tpu_torch.kernels.segment_sum import segment_sum_sorted_grad

Bound = Sequence[float]


def grid_shape(xbound: Bound, ybound: Bound, zbound: Bound
               ) -> Tuple[int, int, int]:
    return tuple(int(round((b[1] - b[0]) / b[2]))
                 for b in (xbound, ybound, zbound))


def _trunc_int(x: torch.Tensor) -> torch.Tensor:
    """Truncate toward zero like torch ``.int()`` / C int casts."""
    return torch.trunc(x).to(torch.int32)


def points_to_voxels_hoststats(
    points_xyz: torch.Tensor,   # (B, N, 3)
    valid: torch.Tensor,        # (B, N) 1.0 = real decoded row
    ids: torch.Tensor,          # (B, N) int32 pillar ids (padding/OOB → 0)
    raw_counts: torch.Tensor,   # (B, V) counts incl. padding at pillar 0
    centroids: torch.Tensor,    # (B, V, 3)
    xbound: Bound, ybound: Bound, zbound: Bound,
    per_point: Optional[torch.Tensor] = None,  # (B, N, 4) host-gathered
                                               # (count, cx, cy, cz) rows
) -> Dict[str, torch.Tensor]:
    """Same keys and values as the JAX function (fp32, exact elementwise)."""
    dev, dt = points_xyz.device, points_xyz.dtype
    gx, gy, gz = grid_shape(xbound, ybound, zbound)
    voxel_size = torch.tensor([xbound[2], ybound[2], zbound[2]], dtype=dt,
                              device=dev)
    grid_offset = torch.tensor([xbound[0], ybound[0], zbound[0]], dtype=dt,
                               device=dev)
    grid_size = torch.tensor([gx, gy, gz], dtype=torch.int32, device=dev)

    shifted = points_xyz - grid_offset
    voxel_xyz = shifted / voxel_size
    coords = _trunc_int(voxel_xyz)
    padding = (valid < 1.0) | ((coords >= grid_size) | (coords < 0)).any(-1)
    voxel_centers = (coords.to(dt) + 0.5) * voxel_size + grid_offset
    coords = torch.where(padding[..., None], 0, coords)
    voxel_xyz = torch.where(padding[..., None], 0.0, voxel_xyz)
    valid_f = 1.0 - padding.to(dt)

    # valid-point count: equal to the raw count except at pillar 0
    in_bin0_valid = torch.sum(valid_f * (ids == 0), dim=-1)  # (B,)
    points_per_voxel = raw_counts.clone()
    points_per_voxel[:, 0] = in_bin0_valid

    if per_point is not None:
        voxel_point_count = per_point[..., 0]
        point_centroids = per_point[..., 1:]
    else:
        table = torch.cat([points_per_voxel[..., None], centroids], dim=-1)
        g = torch.gather(table, 1, ids.long()[..., None].expand(-1, -1, 4))
        voxel_point_count = g[..., 0]
        point_centroids = g[..., 1:]

    return {
        "local_points_xyz": points_xyz - point_centroids,
        "shifted_points_xyz": shifted,
        "point_centroids": point_centroids,
        "points_xyz": points_xyz,
        "grid_offset": grid_offset,
        "voxel_coords": coords,
        "voxel_centers": voxel_centers,
        "voxel_indices": ids,
        "voxel_paddings": padding.to(dt),
        "points_mask": valid_f,
        "num_voxels": gx * gy * gz,
        "grid_size": grid_size,
        "grid_shape": (gx, gy, gz),
        "voxel_xyz": voxel_xyz,
        "voxel_size": voxel_size,
        "voxel_point_count": voxel_point_count,
        "points_per_voxel": points_per_voxel,
        "raw_counts": raw_counts,
        "voxel_centroids": centroids,
    }


def points_to_voxels(points_xyz: torch.Tensor, points_mask: torch.Tensor,
                     xbound: Bound, ybound: Bound, zbound: Bound
                     ) -> Dict[str, torch.Tensor]:
    """Assign (B, N, 3) padded points to pillars and compute the per-point
    and per-pillar statistics on the device: the payload ``[valid, x, y,
    z]`` and K2's count column in one binning, then one (N, 4) row gather
    back to the points. Same keys and values as the JAX function (fp32
    sums in another order)."""
    if points_xyz.dim() != 3:
        raise ValueError(f"points_xyz must be (B, N, 3), got "
                         f"{tuple(points_xyz.shape)}")
    dev, dt = points_xyz.device, points_xyz.dtype
    gx, gy, gz = grid_shape(xbound, ybound, zbound)
    num_voxels = gx * gy * gz
    voxel_size = torch.tensor([xbound[2], ybound[2], zbound[2]], dtype=dt,
                              device=dev)
    grid_offset = torch.tensor([xbound[0], ybound[0], zbound[0]], dtype=dt,
                               device=dev)
    grid_size = torch.tensor([gx, gy, gz], dtype=torch.int32, device=dev)

    shifted = points_xyz - grid_offset
    voxel_xyz = shifted / voxel_size
    coords = _trunc_int(voxel_xyz)
    padding = (points_mask < 1.0) | (
        (coords >= grid_size) | (coords < 0)).any(-1)
    idx = coords[..., 0] * (gy * gz) + coords[..., 1] * gz + coords[..., 2]
    idx = torch.where(padding, 0, idx).to(torch.int32)
    voxel_centers = (coords.to(dt) + 0.5) * voxel_size + grid_offset
    coords = torch.where(padding[..., None], 0, coords)
    voxel_xyz = torch.where(padding[..., None], 0.0, voxel_xyz)
    valid = 1.0 - padding.to(dt)

    payload = torch.cat([valid[..., None], points_xyz], dim=-1).contiguous()
    acc, raw_counts = pillar_bin_sums(payload, idx, num_voxels)  # (B, V, 4)
    points_per_voxel = acc[..., 0]
    voxel_centroids = acc[..., 1:] / raw_counts.clamp_min(1.0)[..., None]

    table = torch.cat([points_per_voxel[..., None], voxel_centroids], dim=-1)
    g = torch.gather(table, 1, idx.long()[..., None].expand(-1, -1, 4))
    voxel_point_count = g[..., 0]
    point_centroids = g[..., 1:]

    return {
        "local_points_xyz": points_xyz - point_centroids,
        "shifted_points_xyz": shifted,
        "point_centroids": point_centroids,
        "points_xyz": points_xyz,
        "grid_offset": grid_offset,
        "voxel_coords": coords,
        "voxel_centers": voxel_centers,
        "voxel_indices": idx,
        "voxel_paddings": padding.to(dt),
        "points_mask": valid,
        "num_voxels": num_voxels,
        "grid_size": grid_size,
        "grid_shape": (gx, gy, gz),
        "voxel_xyz": voxel_xyz,
        "voxel_size": voxel_size,
        "voxel_point_count": voxel_point_count,
        "points_per_voxel": points_per_voxel,
        "raw_counts": raw_counts,
    }


def points_to_voxels_presorted(
    points_xyz: torch.Tensor,   # (B, N, 3) pillar-sorted
    valid: torch.Tensor,        # (B, N) 1.0 = real decoded row
    ids: torch.Tensor,          # (B, N) int32 pillar ids (padding/OOB → 0)
    starts: torch.Tensor,       # (B, V+1) int32 segment offsets
    xbound: Bound, ybound: Bound, zbound: Bound,
) -> Dict[str, torch.Tensor]:
    """``points_to_voxels`` for pillar-sorted input (the host pass's
    ``points, valid, ids, starts``): the same per-point values up to the
    order of the points. The per-pillar sums are one sorted segment sum on
    K1 of the payload ``[valid, xyz − centre of the assigned pillar]``:
    centre-relative coordinates bound the fp32 error of the sums. The raw
    counts are ``diff(starts)``; empty pillars have centroid 0."""
    dev, dt = points_xyz.device, points_xyz.dtype
    gx, gy, gz = grid_shape(xbound, ybound, zbound)
    num_voxels = gx * gy * gz
    voxel_size = torch.tensor([xbound[2], ybound[2], zbound[2]], dtype=dt,
                              device=dev)
    grid_offset = torch.tensor([xbound[0], ybound[0], zbound[0]], dtype=dt,
                               device=dev)
    grid_size = torch.tensor([gx, gy, gz], dtype=torch.int32, device=dev)

    shifted = points_xyz - grid_offset
    voxel_xyz = shifted / voxel_size
    coords = _trunc_int(voxel_xyz)
    padding = (valid < 1.0) | ((coords >= grid_size) | (coords < 0)).any(-1)
    voxel_centers = (coords.to(dt) + 0.5) * voxel_size + grid_offset

    ids = ids.to(torch.int32)
    idl = ids.long()
    seg = torch.stack([idl // (gy * gz), (idl // gz) % gy, idl % gz], -1)
    rel = points_xyz - ((seg.to(dt) + 0.5) * voxel_size + grid_offset)
    valid_f = 1.0 - padding.to(dt)
    payload = torch.cat([valid_f[..., None], rel], dim=-1).contiguous()
    sums = segment_sum_sorted_grad(payload, starts.contiguous(), ids)
    points_per_voxel = sums[..., 0]
    raw_counts = starts.diff(dim=-1).to(dt)

    cell = torch.arange(num_voxels, device=dev)
    cell_center = (torch.stack([cell // (gy * gz), (cell // gz) % gy,
                                cell % gz], -1).to(dt) + 0.5
                   ) * voxel_size + grid_offset
    voxel_centroids = torch.where(
        (raw_counts > 0)[..., None],
        sums[..., 1:] / raw_counts.clamp_min(1.0)[..., None] + cell_center,
        0.0)
    table = torch.cat([points_per_voxel[..., None], voxel_centroids], dim=-1)
    g = torch.gather(table, 1, idl[..., None].expand(-1, -1, 4))
    voxel_point_count = g[..., 0]
    point_centroids = g[..., 1:]

    return {
        "local_points_xyz": points_xyz - point_centroids,
        "shifted_points_xyz": shifted,
        "point_centroids": point_centroids,
        "points_xyz": points_xyz,
        "grid_offset": grid_offset,
        "voxel_coords": torch.where(padding[..., None], 0, coords),
        "voxel_centers": voxel_centers,
        "voxel_indices": ids,
        "voxel_paddings": padding.to(dt),
        "points_mask": valid_f,
        "num_voxels": num_voxels,
        "grid_size": grid_size,
        "grid_shape": (gx, gy, gz),
        "voxel_xyz": torch.where(padding[..., None], 0.0, voxel_xyz),
        "voxel_size": voxel_size,
        "voxel_point_count": voxel_point_count,
        "points_per_voxel": points_per_voxel,
        "raw_counts": raw_counts,
        "segment_starts": starts,
    }


def scatter_mean_to_grid(features: torch.Tensor, voxel_indices: torch.Tensor,
                         num_voxels: int,
                         counts: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Mean-pool (B, N, C) per-point features into (B, V, C) pillars on K2.

    torch_scatter ``scatter_mean`` semantics: the denominator counts every
    row binned to the pillar, padding included (padding carries id 0).
    ``counts``: optional (B, V) all-rows counts (``raw_counts`` of
    ``points_to_voxels``); without them K2's count column is used.
    Differentiable in ``features`` (the backward is a row gather)."""
    sums, cnt = pillar_bin_sums_grad(
        features.float().contiguous(),
        voxel_indices.to(torch.int32).contiguous(), num_voxels)
    if counts is not None:
        cnt = counts.to(sums.dtype)
    return sums / cnt.clamp_min(1.0)[..., None]
