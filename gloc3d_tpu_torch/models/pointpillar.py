"""PointPillar BEV encoder in PyTorch (s2s path).

Port of ``gloc3d_tpu/models/pointpillar.py``: 14-dim per-point features →
1×1 PointNet → mean into the 140×80 pillar grid → three conv blocks (64/128/256) with FPN upsampling → 448-channel concat →
128-channel heads: the descriptor head ``conv_out`` and the pose head
``conv_out_pose``. NCHW inside; the public output keeps the JAX
layout ``(B, gy, gx, 128)``. With host stats (pillar-sorted points) the
mean runs on kernel K1 (sorted segment sums); without, the pillar
statistics and the mean are unsorted binnings on kernel K2.

Parameter names are the reference torch model's (``encoder.pn.pointnet.0``,
``encoder.block1.layers.{3i}``, ``up2.1``, ``conv_out.{0,1,3,4}``,
``conv_out_pose.{0,1,3,4}``), so the
Flax bridge (convert.py) and reference checkpoints map one to one. With
``fold_bn=True`` each BatchNorm is an ``nn.Identity`` and its conv carries
the folded bias.

Traps kept from the reference and the Flax model:

- Flax ``padding="SAME"`` pads a stride-2 3×3 conv by (0 low, 1 high), not
  (1, 1) as ``nn.Conv2d(padding=1)`` does: ``_pad_same`` pads explicitly.
- PointNet BN sees unmasked rows; the mask applies after the ReLU.
- The pillar ravel is x-major (H = gx, W = gy), and the head ends with an
  x↔y swap.
- The FPN upsample uses align-corners bilinear.
- Compute dtype: convs run in ``compute_dtype`` (bf16 by default); BN and
  the folded model's ``relu=False`` head end return fp32.
- A Flax module creates a head's parameters only for the mode it is
  initialised with; the port builds the heads of its ``mode`` argument
  (``HEADS``), so the descriptor model keeps exactly the descriptor head
  and a pose model has no ``conv_out``.
- Training (``model.train()``): BatchNorm normalises with batch statistics
  and keeps Flax's biased running variance (``models/batchnorm.py``); both
  pillar means carry gradients through their kernels' autograd Functions
  (K1: ``segment_sum_sorted_grad``, K2: ``scatter_mean_to_grid``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from gloc3d_tpu_torch.kernels.segment_sum import segment_sum_sorted_grad
from gloc3d_tpu_torch.models.batchnorm import BatchNorm
from gloc3d_tpu_torch.ops.voxelize import (
    grid_shape, points_to_voxels, points_to_voxels_hoststats,
    scatter_mean_to_grid,
)

POINT_FEATURES = 14  # 4 input columns + count + 3 local + 3 centroid + 3 center


def _pad_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Flax/TF ``SAME`` padding for an NCHW input: ceil(in/s) outputs, the
    odd pad cell on the high side."""
    pads = []
    for size in (x.shape[-1], x.shape[-2]):  # F.pad order: W, then H
        total = max((math.ceil(size / s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def _bn(channels: int, fold_bn: bool) -> nn.Module:
    return nn.Identity() if fold_bn else BatchNorm(channels)


def conv_bn_act(x: torch.Tensor, conv: nn.Conv2d, bn: nn.Module, relu: bool,
                compute_dtype: torch.dtype) -> torch.Tensor:
    """One ConvBNRelu of the Flax model (conv in ``compute_dtype``)."""
    s = conv.stride[0]
    x = _pad_same(x.to(compute_dtype), conv.kernel_size[0], s)
    bias = None if conv.bias is None else conv.bias.to(compute_dtype)
    y = F.conv2d(x, conv.weight.to(compute_dtype), bias, stride=s)
    if isinstance(bn, nn.Identity):  # folded serving model
        return F.relu(y) if relu else y.float()
    y = bn(y.float())
    return F.relu(y) if relu else y


def _conv(cin: int, cout: int, stride: int, fold_bn: bool) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=0, bias=fold_bn)


class PillarBlock(nn.Module):
    """num_layers × (3×3 conv + BN + ReLU); stride on the first conv only."""

    def __init__(self, cin: int, dims: int, num_layers: int, stride: int,
                 fold_bn: bool):
        super().__init__()
        mods = []
        for i in range(num_layers):
            mods += [_conv(cin if i == 0 else dims, dims,
                           stride if i == 0 else 1, fold_bn),
                     _bn(dims, fold_bn), nn.ReLU()]
        self.layers = nn.Sequential(*mods)

    def forward(self, x, compute_dtype):
        for i in range(0, len(self.layers), 3):
            x = conv_bn_act(x, self.layers[i], self.layers[i + 1], True,
                            compute_dtype)
        return x


class PointNet(nn.Module):
    """Per-point 1×1 conv + BN + ReLU, masked after."""

    def __init__(self, idims: int = POINT_FEATURES, odims: int = 64,
                 fold_bn: bool = False):
        super().__init__()
        self.pointnet = nn.Sequential(
            nn.Conv1d(idims, odims, 1, bias=fold_bn),
            nn.Identity() if fold_bn else BatchNorm(odims),
            nn.ReLU())

    def forward(self, feats, mask, compute_dtype):
        conv, bn = self.pointnet[0], self.pointnet[1]
        bias = None if conv.bias is None else conv.bias.to(compute_dtype)
        x = F.linear(feats.to(compute_dtype),
                     conv.weight[:, :, 0].to(compute_dtype), bias).float()
        if not isinstance(bn, nn.Identity):
            b, n, c = x.shape
            x = bn(x.reshape(b * n, c)).reshape(b, n, c)
        return F.relu(x) * mask[..., None]


HEADS = {  # mode → the heads it builds and runs
    "vlad": ("conv_out",),
    "cluster": ("conv_out",),
    "pose": ("conv_out_pose",),
    "both": ("conv_out", "conv_out_pose"),
}


def _head(fold_bn: bool) -> nn.Sequential:
    return nn.Sequential(
        _conv(448, 256, 1, fold_bn), _bn(256, fold_bn), nn.ReLU(),
        _conv(256, 128, 1, fold_bn), _bn(128, fold_bn))


class PointPillar(nn.Module):
    """PointPillar backbone + the descriptor and pose heads.

    ``forward(points (B, N, 4), mask (B, N), voxel_stats=None, mode=None)``
    bins on the device; ``voxel_stats=(ids, raw_counts, centroids, starts[,
    per_point]))`` takes pillar-sorted points from the host stats pass.
    ``mode`` (default: the one the module was built with) is JAX's:
    ``"vlad"`` → ``(B, gy, gx, 128)`` from ``conv_out``; ``"cluster"`` → the
    same, L2-normalised over channels; ``"pose"`` → ``(B, gy, gx, 128)``
    from ``conv_out_pose``; ``"both"`` → the (vlad, pose) pair. The module
    holds the heads of the mode it is built with (``HEADS``).
    """

    def __init__(self, xbound: Sequence[float] = (-35.0, 35.0, 0.5),
                 ybound: Sequence[float] = (-20.0, 20.0, 0.5),
                 zbound: Sequence[float] = (-10.0, 10.0, 20.0),
                 compute_dtype: torch.dtype = torch.bfloat16,
                 fold_bn: bool = False, mode: str = "vlad"):
        super().__init__()
        if mode not in HEADS:
            raise ValueError(f"unknown mode {mode!r}")
        self.xbound, self.ybound, self.zbound = xbound, ybound, zbound
        self.compute_dtype = compute_dtype
        self.fold_bn = fold_bn
        self.mode = mode
        self.pn = PointNet(POINT_FEATURES, 64, fold_bn)
        self.block1 = PillarBlock(64, 64, 2, 1, fold_bn)
        self.block2 = PillarBlock(64, 128, 3, 2, fold_bn)
        self.block3 = PillarBlock(128, 256, 3, 2, fold_bn)
        self.up1 = nn.Sequential(_conv(64, 64, 1, fold_bn), _bn(64, fold_bn),
                                 nn.ReLU())
        self.up2 = nn.Sequential(
            nn.Upsample(scale_factor=2, mode="bilinear", align_corners=True),
            _conv(128, 128, 1, fold_bn), _bn(128, fold_bn), nn.ReLU())
        self.up3 = nn.Sequential(
            nn.Upsample(scale_factor=4, mode="bilinear", align_corners=True),
            _conv(256, 256, 1, fold_bn), _bn(256, fold_bn), nn.ReLU())
        for name in HEADS[mode]:
            setattr(self, name, _head(fold_bn))

    def forward(self, points, mask, voxel_stats=None, mode=None):
        xyz = points[..., :3]
        if voxel_stats is None:
            vox = points_to_voxels(xyz, mask, self.xbound, self.ybound,
                                   self.zbound)
        else:
            if len(voxel_stats) < 4:
                raise ValueError("voxel_stats are (ids, raw_counts, "
                                 "centroids, starts[, per_point])")
            ids, raw_counts, centroids, starts = voxel_stats[:4]
            pp = voxel_stats[4] if len(voxel_stats) > 4 else None
            vox = points_to_voxels_hoststats(
                xyz, mask, ids, raw_counts, centroids,
                self.xbound, self.ybound, self.zbound, per_point=pp)
        feats = self.point_features(points, vox)

        if voxel_stats is None:
            pillar = scatter_mean_to_grid(feats, vox["voxel_indices"],
                                          vox["num_voxels"],
                                          counts=vox["raw_counts"])
        else:
            sums = segment_sum_sorted_grad(feats.contiguous(),
                                           starts.contiguous(), ids)
            pillar = sums / raw_counts.clamp_min(1.0)[..., None]  # (B, V, 64)
        return self.bev_heads(pillar, mode)

    def point_features(self, points, vox):
        """The 14 per-point features of (B, N, 4) ``points`` → the masked
        (B, N, 64) PointNet features."""
        xyz = points[..., :3]
        feats = torch.cat([
            points,
            vox["voxel_point_count"][..., None],
            vox["local_points_xyz"],
            vox["point_centroids"],
            xyz - vox["voxel_centers"],
        ], dim=-1)
        return self.pn(feats, vox["points_mask"], self.compute_dtype)

    def bev_heads(self, pillar, mode=None):
        """(B, V, 64) pillar means → the CNN, the FPN and the heads of
        ``mode``."""
        cd = self.compute_dtype
        mode = mode or self.mode
        missing = [h for h in HEADS[mode] if not hasattr(self, h)]
        if missing:
            raise ValueError(f"mode {mode!r} needs {missing}: this module "
                             f"was built with mode {self.mode!r}")
        gx, gy, _ = grid_shape(self.xbound, self.ybound, self.zbound)
        # x-major ravel: H = gx, W = gy (≙ torch view(B, C, gx, gy))
        x = pillar.reshape(pillar.shape[0], gx, gy, 64).permute(0, 3, 1, 2)

        f1 = self.block1(x, cd)
        f2 = self.block2(f1, cd)
        f3 = self.block3(f2, cd)
        f1 = conv_bn_act(f1, self.up1[0], self.up1[1], True, cd)
        f2 = conv_bn_act(self.up2[0](f2), self.up2[1], self.up2[2], True, cd)
        f3 = conv_bn_act(self.up3[0](f3), self.up3[1], self.up3[2], True, cd)
        feat = torch.cat([f1.to(cd), f2.to(cd), f3.to(cd)], dim=1)

        def head(co):
            h = conv_bn_act(feat, co[0], co[1], True, cd)
            h = conv_bn_act(h, co[3], co[4], False, cd)  # (B, 128, gx, gy)
            return h.permute(0, 3, 2, 1)  # x↔y swap → (B, gy, gx, 128)

        if mode == "cluster":
            out = head(self.conv_out)
            return out * torch.rsqrt((out * out).sum(-1, keepdim=True)
                                     + 1e-12)
        outs = tuple(head(getattr(self, h)) for h in HEADS[mode])
        return outs if mode == "both" else outs[0]
