"""End-to-end descriptor extractor: encoder + pooling in one module.

Port of ``gloc3d_tpu/models/descriptor.py``: PointPillar on padded clouds
(s2s), or an image encoder on ``(B, S, S, 3)`` BEV images (i2i: VGG16, and
the AlexNet / MobileNetV2 / ResNet18 baselines of ``models/encoders.py``),
followed by NetVLAD(-FC) or a max / avg head.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from gloc3d_tpu_torch.models.encoders import (
    build_image_encoder, is_image_encoder,
)
from gloc3d_tpu_torch.models.netvlad import GatingContext, NetVLAD
from gloc3d_tpu_torch.models.pointpillar import PointPillar


class _MaxPoolHead(nn.Module):
    def forward(self, x):
        v = x.float().amax(dim=(1, 2))
        return v * torch.rsqrt((v * v).sum(-1, keepdim=True) + 1e-12)


class _AvgPoolHead(nn.Module):
    def forward(self, x):
        v = x.float().mean(dim=(1, 2))
        return v * torch.rsqrt((v * v).sum(-1, keepdim=True) + 1e-12)


class DescriptorModel(nn.Module):
    """encoder ∘ pool → (B, D) global descriptor."""

    def __init__(self, model_cfg, voxel_cfg):
        super().__init__()
        self.model_cfg = model_cfg
        cd = getattr(torch, model_cfg.compute_dtype)
        if is_image_encoder(model_cfg.encoder):
            self.encoder = build_image_encoder(model_cfg.encoder, cd)
        elif model_cfg.encoder == "pointpillar":
            self.encoder = PointPillar(
                xbound=voxel_cfg.xbound, ybound=voxel_cfg.ybound,
                zbound=voxel_cfg.zbound, compute_dtype=cd,
                fold_bn=model_cfg.fold_bn)
        else:
            raise ValueError(f"unknown encoder {model_cfg.encoder!r}")
        if model_cfg.pooling in ("netvlad", "netvlad_fc"):
            self.pool = NetVLAD(
                num_clusters=model_cfg.num_clusters,
                dim=model_cfg.encoder_dim, vladv2=model_cfg.vladv2,
                use_fc=model_cfg.pooling == "netvlad_fc",
                gating=model_cfg.gating,
                normalize_input=model_cfg.normalize_input, compute_dtype=cd)
        elif model_cfg.pooling == "max":
            self.pool = _MaxPoolHead()
        elif model_cfg.pooling == "avg":
            self.pool = _AvgPoolHead()
        else:
            raise ValueError(f"unknown pooling {model_cfg.pooling!r}")

    def encode(self, inputs, mask: Optional[torch.Tensor] = None,
               voxel_stats=None):
        """The encoder's ``(B, H, W, D)`` feature map (NetVLAD's input):
        PointPillar's ``(B, gy, gx, 128)`` from clouds and ``mask``, or an
        image encoder's from ``(B, S, S, 3)`` images (``mask`` unused)."""
        if self.model_cfg.encoder == "pointpillar":
            return self.encoder(inputs, mask, voxel_stats=voxel_stats)
        return self.encoder(inputs)

    def forward(self, inputs, mask: Optional[torch.Tensor] = None,
                voxel_stats=None):
        return self.pool(self.encode(inputs, mask, voxel_stats))


def build_model(model_cfg, voxel_cfg) -> DescriptorModel:
    return DescriptorModel(model_cfg, voxel_cfg)


@torch.no_grad()
def init_params(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded init with the Flax model's initializer families: convs and
    the VLAD assignment lecun-normal (std 1/sqrt(fan_in)), BatchNorm at
    identity, centroids uniform [0, 1), FC and gating weights normal with
    std 1/sqrt(D). Same distributions as ``model.init`` in JAX, not the same
    numbers (the two generators differ)."""
    gen = torch.Generator().manual_seed(seed)

    def normal_(p, std):
        p.copy_(torch.randn(p.shape, generator=gen) * std)

    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d)):
            normal_(m.weight, 1.0 / math.sqrt(m.weight[0].numel()))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
        elif isinstance(m, GatingContext):
            normal_(m.gating_weights, 1.0 / math.sqrt(m.gating_weights.shape[0]))
        if isinstance(m, NetVLAD):
            m.centroids.copy_(torch.rand(m.centroids.shape, generator=gen))
            if m.hidden1_weights is not None:
                normal_(m.hidden1_weights, 1.0 / math.sqrt(m.dim))
    return model
