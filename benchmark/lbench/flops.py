"""Operations and bytes the work needs, computed from the configuration's
shapes alone (not from how the program computes them), and the card's
published peaks.

FLOPs count 2 per multiply-add of every convolution and matrix product of
the descriptor network; elementwise work, BatchNorm, pooling and softmax
are not counted. K2's bytes are its inputs read once and its outputs
written once.
"""

from __future__ import annotations

import math

from lbench.reference.models import VGG16, grid_shape

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def _conv(positions: int, cin: int, cout: int, k: int = 3) -> int:
    return 2 * positions * cin * cout * k * k


def vgg16_flops(image_size: int) -> int:
    """The 13 convs of VGG16 on one image of ``image_size``² pixels."""
    total, cin, s = 0, 3, image_size
    for cout, pool in VGG16:
        if pool:
            s //= 2
        total += _conv(s * s, cin, cout)
        cin = cout
    return total


def pointpillar_flops(vcfg: dict) -> int:
    """PointPillar on one scan: the 14 → 64 PointNet over every padded row,
    the three blocks, the three FPN convs at the first block's grid and
    the two head convs."""
    gx, gy, _ = grid_shape(vcfg)
    full = gx * gy
    half = -(-gx // 2) * -(-gy // 2)
    quarter = -(-gx // 4) * -(-gy // 4)
    total = 2 * vcfg["max_points"] * 14 * 64
    total += 2 * _conv(full, 64, 64)
    total += _conv(half, 64, 128) + 2 * _conv(half, 128, 128)
    total += _conv(quarter, 128, 256) + 2 * _conv(quarter, 256, 256)
    total += (_conv(full, 64, 64) + _conv(full, 128, 128)
              + _conv(full, 256, 256))
    total += _conv(full, 448, 256) + _conv(full, 256, 128)
    return total


def netvlad_fc_flops(positions: int, dim: int, clusters: int) -> int:
    """Assignment logits, the weighted sums, and the (K·D, D) projection."""
    return 2 * positions * dim * clusters * 2 + 2 * clusters * dim * dim


def descriptor_flops(cfg: dict) -> int:
    """The descriptor network's FLOPs for one query of configuration
    ``cfg`` (the configuration file's ``pipeline`` tree)."""
    m = cfg["model"]
    if m["encoder"] == "pointpillar":
        gx, gy, _ = grid_shape(cfg["voxel"])
        return (pointpillar_flops(cfg["voxel"])
                + netvlad_fc_flops(gx * gy, m["encoder_dim"],
                                   m["num_clusters"]))
    s = cfg["bev"]["image_size"]
    return (vgg16_flops(s) + netvlad_fc_flops((s // 16) ** 2,
                                              m["encoder_dim"],
                                              m["num_clusters"]))


def k2_bytes(batch: int, rows: int, channels: int, pillars: int) -> int:
    """One K2 binning: features (B, N, C) fp32 and ids (B, N) int32 read,
    sums (B, V, C) fp32 and counts (B, V) fp32 written."""
    return 4 * batch * (rows * channels + rows + pillars * channels
                        + pillars)


def k2_bytes_per_scan(vcfg: dict) -> int:
    """The all-device extraction's two binnings of one scan: the pillar
    statistics (C = 4) and the PointNet feature mean (C = 64)."""
    v = math.prod(grid_shape(vcfg))
    n = vcfg["max_points"]
    return k2_bytes(1, n, 4, v) + k2_bytes(1, n, 64, v)
