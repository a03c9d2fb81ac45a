"""Packed-input and pillar-sorted PointPillar, and the pose head.

Port of ``gloc3d_tpu/models/packed.py``:

- ``pack_points`` builds the reference's packed tensor (s2s_merged.py
  PointPillarTest): the 14 point features, the voxel index and the mask in
  one ``(B, N, 16)`` tensor, so a network can run from precomputed voxel
  features; ``PointPillarPacked`` runs from it, its pillar mean on kernel
  K2 (``ops/voxelize.py::scatter_mean_to_grid``).
- ``PointPillarSorted`` runs on pillar-sorted points (the host pass's
  ``points, valid, ids, starts``): both of its segment sums, the 4-channel
  statistics payload and the 64-channel features, run on kernel K1.
- ``PoseHead`` regresses a 6-DoF relative pose [angle-axis | translation]
  from two BEV encodings (the working form of the reference's PoseLayer).

Both PointPillar variants are ``PointPillar`` subclasses built in mode
``"vlad"``, as JAX's are: the same parameter names, so one state dict loads
into all three.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from gloc3d_tpu_torch.kernels.segment_sum import segment_sum_sorted_grad
from gloc3d_tpu_torch.models.batchnorm import BatchNorm
from gloc3d_tpu_torch.models.pointpillar import PointPillar, _pad_same
from gloc3d_tpu_torch.ops.voxelize import (
    grid_shape, points_to_voxels, points_to_voxels_presorted,
    scatter_mean_to_grid,
)


def pack_points(points: torch.Tensor, mask: torch.Tensor, xbound, ybound,
                zbound) -> torch.Tensor:
    """(B, N, 4) points and their (B, N) mask → the packed (B, N, 16)
    tensor ``[points (4) | voxel point count | local xyz | centroid |
    offset to the voxel centre (3) | voxel index | mask]``
    (s2s_merged.py:219-231). The voxel index travels as fp32, which is
    exact below 2²⁴ pillars."""
    xyz = points[..., :3]
    v = points_to_voxels(xyz, mask, xbound, ybound, zbound)
    return torch.cat([
        points,
        v["voxel_point_count"][..., None],
        v["local_points_xyz"],
        v["point_centroids"],
        xyz - v["voxel_centers"],
        v["voxel_indices"][..., None].to(points.dtype),
        v["points_mask"][..., None],
    ], dim=-1)


class PointPillarPacked(PointPillar):
    """PointPillar from a packed tensor (``pack_points``); mode "vlad".
    The pillar mean's denominator counts every row binned to the pillar,
    padding included (K2's count column)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, mode="vlad", **kw)

    def forward(self, packed: torch.Tensor) -> torch.Tensor:
        feats = packed[..., :-2]
        ids = packed[..., -2].to(torch.int32)
        x = self.pn(feats, packed[..., -1])
        gx, gy, gz = grid_shape(self.xbound, self.ybound, self.zbound)
        return self.bev_heads(scatter_mean_to_grid(x, ids, gx * gy * gz))


class PointPillarSorted(PointPillar):
    """PointPillar on pillar-sorted points (``data/native.py::
    compute_voxel_stats_host_sorted``: ``points, valid, ids, starts``);
    mode "vlad". Equal to ``PointPillar`` up to fp32 summation order."""

    def __init__(self, *args, **kw):
        super().__init__(*args, mode="vlad", **kw)

    def forward(self, points: torch.Tensor, valid: torch.Tensor,
                ids: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
        ids, starts = ids.to(torch.int32), starts.contiguous()
        vox = points_to_voxels_presorted(points[..., :3], valid, ids, starts,
                                         self.xbound, self.ybound,
                                         self.zbound)
        x = self.point_features(points, vox)
        sums = segment_sum_sorted_grad(x.contiguous(), starts, ids)
        return self.bev_heads(
            sums / vox["raw_counts"].clamp_min(1.0)[..., None])


class PoseHead(nn.Module):
    """Two (B, H, W, C) encodings → (B, 6) [angle-axis | translation]:
    concat, a 3×3 stride-2 conv without bias (Flax ``SAME``: (0, 1)
    padding), BatchNorm (Flax momentum 0.9, biased running variance), ReLU,
    a per-location ``Linear(hidden, 6)`` and the spatial mean. fp32, as
    Flax's default dtype is."""

    def __init__(self, in_channels: int = 256, hidden: int = 128):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, hidden, 3, stride=2, bias=False)
        self.bn = BatchNorm(hidden)
        self.fc = nn.Linear(hidden, 6)

    def forward(self, enc_q: torch.Tensor, enc_p: torch.Tensor
                ) -> torch.Tensor:
        x = torch.cat([enc_q, enc_p], dim=-1).float().permute(0, 3, 1, 2)
        x = F.conv2d(_pad_same(x, 3, 2), self.conv.weight, stride=2)
        x = F.relu(self.bn(x)).permute(0, 2, 3, 1)
        return self.fc(x).mean(dim=(1, 2))
