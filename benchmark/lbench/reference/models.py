"""The two descriptor networks, plain PyTorch in float32.

Written from the published architectures (peterWon/GLoc3D
``model/pointpillar.py``, ``model/netvlad_fc.py``, ``main.py:519-564``)
over a state dict with the reference's torch names, BatchNorm unfolded and
in eval mode:

- PointPillar: 14 per-point features (xyzi, the pillar's point count, the
  offset from and the pillar centroid, the offset from the pillar centre)
  → a 1×1 PointNet (64) with BatchNorm and ReLU, masked → the mean of each
  pillar of the 140 × 80 grid (every row counted, padding and out-of-grid
  rows in pillar 0) → three conv blocks (64, 128, 256; TF ``SAME`` padding,
  stride 2 on the first conv of blocks 2 and 3) → align-corners bilinear
  upsampling and 3×3 convs to the first block's grid → a 448-channel
  concatenation → a 256 and a 128-channel 3×3 conv (no ReLU on the last)
  → (B, 80, 140, 128), the pillar ravel x-major and the map transposed.
- VGG16: the 13 3×3 convs of ``vgg16.features`` up to conv5_3 (no ReLU
  after it, no last pool), 2×2 max-pools before convs 3, 5, 8 and 11, on
  the BEV image repeated to three channels → (B, S/16, S/16, 512).
- NetVLAD-FC: inputs L2-normalised, a softmax assignment over K clusters
  by a 1×1 conv, residual sums to the centroids, intra-normalisation, a
  K-major flatten, global L2, and the (K·D, D) projection.

``q`` is applied to the inputs and weights of every convolution and matrix
product: the identity, or the control's rounding to a lower precision.
Pillar sums run in float64 and round once.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
Quant = Callable[[Tensor], Tensor]
BN_EPS = 1e-5

VGG16 = ((64, False), (64, False), (128, True), (128, False),
         (256, True), (256, False), (256, False), (512, True), (512, False),
         (512, False), (512, True), (512, False), (512, False))
VGG16_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def identity(x: Tensor) -> Tensor:
    return x


# ------------------------------------------------------------ parameters
def _bn(name: str, c: int) -> List[tuple]:
    return [(f"{name}.weight", (c,), "bn_weight"),
            (f"{name}.bias", (c,), "bn_bias"),
            (f"{name}.running_mean", (c,), "bn_mean"),
            (f"{name}.running_var", (c,), "bn_var"),
            (f"{name}.num_batches_tracked", (), "count")]


def _pointpillar_convs() -> List[Tuple[str, int, int, int]]:
    """(conv name, cin, cout, stride) of PointPillar's 3×3 convs; each is
    followed by a BatchNorm at the next index."""
    convs = []
    for blk, cin, dims, layers, stride in (("block1", 64, 64, 2, 1),
                                           ("block2", 64, 128, 3, 2),
                                           ("block3", 128, 256, 3, 2)):
        for i in range(layers):
            convs.append((f"encoder.{blk}.layers.{3 * i}",
                          cin if i == 0 else dims, dims,
                          stride if i == 0 else 1))
    convs += [("encoder.up1.0", 64, 64, 1), ("encoder.up2.1", 128, 128, 1),
              ("encoder.up3.1", 256, 256, 1),
              ("encoder.conv_out.0", 448, 256, 1),
              ("encoder.conv_out.3", 256, 128, 1)]
    return convs


def _bn_after(conv: str) -> str:
    head, idx = conv.rsplit(".", 1)
    return f"{head}.{int(idx) + 1}"


def param_specs(mcfg: dict) -> List[tuple]:
    """(name, shape, kind) of every tensor of the unfolded model's state
    dict, in order; ``kind`` says how the benchmark draws it."""
    k, d = mcfg["num_clusters"], mcfg["encoder_dim"]
    specs: List[tuple] = []
    if mcfg["encoder"] == "pointpillar":
        specs.append(("encoder.pn.pointnet.0.weight", (64, 14, 1), "weight"))
        specs += _bn("encoder.pn.pointnet.1", 64)
        for name, cin, cout, _ in _pointpillar_convs():
            specs.append((f"{name}.weight", (cout, cin, 3, 3), "weight"))
            specs += _bn(_bn_after(name), cout)
    elif mcfg["encoder"] == "vgg16":
        cin = 3
        for idx, (cout, _) in zip(VGG16_IDX, VGG16):
            specs.append((f"encoder.{idx}.weight", (cout, cin, 3, 3),
                          "weight"))
            specs.append((f"encoder.{idx}.bias", (cout,), "bias"))
            cin = cout
    else:
        raise ValueError(f"no reference for encoder {mcfg['encoder']!r}")
    specs += [("pool.conv.weight", (k, d, 1, 1), "assign"),
              ("pool.centroids", (k, d), "centroids"),
              ("pool.hidden1_weights", (k * d, d), "hidden1")]
    return specs


# ------------------------------------------------------------ layers
def _bn_eval(x: Tensor, p: Dict[str, Tensor], name: str) -> Tensor:
    shape = (1, -1) + (1,) * (x.dim() - 2)
    inv = torch.rsqrt(p[f"{name}.running_var"] + BN_EPS)
    return ((x - p[f"{name}.running_mean"].view(shape)) * inv.view(shape)
            * p[f"{name}.weight"].view(shape) + p[f"{name}.bias"].view(shape))


def _pad_same(x: Tensor, k: int, s: int) -> Tensor:
    pads = []
    for size in (x.shape[-1], x.shape[-2]):
        total = max((math.ceil(size / s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def _conv_bn(x: Tensor, p, conv: str, stride: int, relu: bool,
             q: Quant) -> Tensor:
    w = p[f"{conv}.weight"]
    y = F.conv2d(q(_pad_same(x, w.shape[-1], stride)), q(w), stride=stride)
    y = _bn_eval(y, p, _bn_after(conv))
    return F.relu(y) if relu else y


# ------------------------------------------------------------ PointPillar
def grid_shape(vcfg: dict) -> Tuple[int, int, int]:
    return tuple(int(round((b[1] - b[0]) / b[2]))
                 for b in (vcfg["xbound"], vcfg["ybound"], vcfg["zbound"]))


def _bin_sums(feats: Tensor, ids: Tensor, v: int) -> Tuple[Tensor, Tensor]:
    """Sums (float64, rounded once) and counts of (B, N, C) rows by id."""
    b, n, c = feats.shape
    flat = (ids.long() + torch.arange(b, device=ids.device)[:, None] * v
            ).reshape(-1)
    sums = torch.zeros((b * v, c), dtype=torch.float64, device=feats.device)
    sums.index_add_(0, flat, feats.reshape(b * n, c).double())
    counts = torch.zeros(b * v, dtype=torch.float64, device=feats.device)
    counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.float64))
    return sums.float().reshape(b, v, c), counts.float().reshape(b, v)


def pointpillar(p: Dict[str, Tensor], vcfg: dict, points: Tensor,
                mask: Tensor, q: Quant = identity) -> Tensor:
    """(B, N, 4) scans and (B, N) masks → (B, gy, gx, 128) features."""
    dev = points.device
    gx, gy, gz = grid_shape(vcfg)
    v = gx * gy * gz
    bounds = (vcfg["xbound"], vcfg["ybound"], vcfg["zbound"])
    size = torch.tensor([b[2] for b in bounds], dtype=torch.float32,
                        device=dev)
    offset = torch.tensor([b[0] for b in bounds], dtype=torch.float32,
                          device=dev)
    xyz = points[..., :3]
    coords = torch.trunc((xyz - offset) / size).to(torch.int32)
    grid = torch.tensor([gx, gy, gz], dtype=torch.int32, device=dev)
    padding = (mask < 1.0) | ((coords >= grid) | (coords < 0)).any(-1)
    ids = coords[..., 0] * (gy * gz) + coords[..., 1] * gz + coords[..., 2]
    ids = torch.where(padding, 0, ids)
    centres = (coords.float() + 0.5) * size + offset
    valid = 1.0 - padding.float()

    stats, counts = _bin_sums(torch.cat([valid[..., None], xyz], -1), ids, v)
    centroids = stats[..., 1:] / counts.clamp_min(1.0)[..., None]
    table = torch.cat([stats[..., :1], centroids], -1)
    per_point = torch.gather(table, 1, ids.long()[..., None].expand(-1, -1,
                                                                    4))
    feats = torch.cat([points, per_point[..., :1], xyz - per_point[..., 1:],
                       per_point[..., 1:], xyz - centres], -1)

    w = p["encoder.pn.pointnet.0.weight"][:, :, 0]
    x = q(feats) @ q(w).t()
    bsz, n, c = x.shape
    x = _bn_eval(x.reshape(bsz * n, c), p, "encoder.pn.pointnet.1")
    x = F.relu(x).reshape(bsz, n, c) * valid[..., None]
    sums, _ = _bin_sums(x, ids, v)
    pillar = sums / counts.clamp_min(1.0)[..., None]

    x = pillar.reshape(bsz, gx, gy, 64).permute(0, 3, 1, 2)
    convs = {name: s for name, _, _, s in _pointpillar_convs()}

    def block(x, name, layers):
        for i in range(layers):
            conv = f"encoder.{name}.layers.{3 * i}"
            x = _conv_bn(x, p, conv, convs[conv], True, q)
        return x

    f1 = block(x, "block1", 2)
    f2 = block(f1, "block2", 3)
    f3 = block(f2, "block3", 3)
    f1 = _conv_bn(f1, p, "encoder.up1.0", 1, True, q)
    f2 = _conv_bn(F.interpolate(f2, scale_factor=2, mode="bilinear",
                                align_corners=True),
                  p, "encoder.up2.1", 1, True, q)
    f3 = _conv_bn(F.interpolate(f3, scale_factor=4, mode="bilinear",
                                align_corners=True),
                  p, "encoder.up3.1", 1, True, q)
    h = torch.cat([f1, f2, f3], 1)
    h = _conv_bn(h, p, "encoder.conv_out.0", 1, True, q)
    h = _conv_bn(h, p, "encoder.conv_out.3", 1, False, q)
    return h.permute(0, 3, 2, 1)


# ------------------------------------------------------------ VGG16
def vgg16(p: Dict[str, Tensor], images: Tensor,
          q: Quant = identity) -> Tensor:
    """(B, S, S, 3) images → (B, S/16, S/16, 512) conv5_3 features."""
    x = images.permute(0, 3, 1, 2)
    for i, (idx, (_, pool)) in enumerate(zip(VGG16_IDX, VGG16)):
        if pool:
            x = F.max_pool2d(x, 2, 2)
        x = F.conv2d(q(x), q(p[f"encoder.{idx}.weight"]),
                     q(p[f"encoder.{idx}.bias"]), padding=1)
        if i < len(VGG16) - 1:
            x = F.relu(x)
    return x.permute(0, 2, 3, 1)


# ------------------------------------------------------------ NetVLAD-FC
def _l2(x: Tensor) -> Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12)


def netvlad_fc(p: Dict[str, Tensor], feats: Tensor,
               q: Quant = identity) -> Tensor:
    """(B, H, W, D) features → (B, D) descriptors."""
    b, d = feats.shape[0], feats.shape[-1]
    x = _l2(feats.reshape(b, -1, d))
    w = p["pool.conv.weight"].reshape(-1, d)
    a = torch.softmax(q(x) @ q(w).t(), dim=-1)
    weighted = q(a).transpose(1, 2) @ q(x)
    vlad = weighted - a.sum(1)[..., None] * p["pool.centroids"][None]
    vlad = _l2(_l2(vlad).reshape(b, -1))
    return q(vlad) @ q(p["pool.hidden1_weights"])


def features(p, mcfg: dict, vcfg: dict, inputs: Tensor, mask=None,
             q: Quant = identity) -> Tensor:
    """The encoder's feature map: PointPillar on scans and masks, VGG16 on
    (B, S, S) BEV images (repeated to three channels)."""
    if mcfg["encoder"] == "pointpillar":
        return pointpillar(p, vcfg, inputs, mask, q)
    return vgg16(p, inputs[..., None].repeat(1, 1, 1, 3), q)


def descriptor(p, mcfg: dict, vcfg: dict, inputs: Tensor, mask=None,
               q: Quant = identity) -> Tensor:
    return netvlad_fc(p, features(p, mcfg, vcfg, inputs, mask, q), q)


def fp8(x: Tensor) -> Tensor:
    """The control's rounding: to float8 e4m3 and back, per tensor scaled
    so that its largest magnitude sits at the format's largest value."""
    amax = x.detach().abs().amax().clamp_min(1e-30).float()
    scale = 448.0 / amax
    return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale
            ).to(x.dtype)
