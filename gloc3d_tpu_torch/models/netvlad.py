"""NetVLAD / NetVLAD-FC pooling in PyTorch.

Port of ``gloc3d_tpu/models/netvlad.py``: soft assignment by a 1×1 conv,
the VLAD as two matmuls (Σ_i a_ik·x_i − (Σ_i a_ik)·c_k), intra-
normalisation, a K-major flatten, global L2, and the optional FC projection
(``hidden1_weights``) and context gating. Parameter names and shapes are the
reference torch model's: ``conv.weight (K, D, 1, 1)``, ``centroids (K, D)``,
``hidden1_weights (K·D, D)``, ``context_gating.gating_weights (D, D)`` with
``context_gating.bn1``.

``init_netvlad_params`` is the data-dependent centroid and assignment init
that ``train/cluster.py`` runs before training.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from gloc3d_tpu_torch.models.batchnorm import BatchNorm


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12)


class GatingContext(nn.Module):
    """Context gating: sigmoid(BN(x·W)) ⊙ x."""

    def __init__(self, dim: int):
        super().__init__()
        self.gating_weights = nn.Parameter(torch.empty(dim, dim))
        self.bn1 = BatchNorm(dim)  # batch = the descriptors: Flax's update

    def forward(self, x):
        return x * torch.sigmoid(self.bn1(x @ self.gating_weights))


class NetVLAD(nn.Module):
    """``(B, H, W, D)`` feature map → ``(B, D)`` (FC) or ``(B, K·D)``."""

    def __init__(self, num_clusters: int = 64, dim: int = 128,
                 normalize_input: bool = True, vladv2: bool = False,
                 use_fc: bool = True, gating: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_clusters, self.dim = num_clusters, dim
        self.normalize_input = normalize_input
        self.compute_dtype = compute_dtype
        self.conv = nn.Conv2d(dim, num_clusters, 1, bias=vladv2)
        self.centroids = nn.Parameter(torch.empty(num_clusters, dim))
        self.hidden1_weights = (nn.Parameter(torch.empty(num_clusters * dim,
                                                         dim))
                                if use_fc else None)
        self.context_gating = (GatingContext(dim) if use_fc and gating
                               else None)

    def forward(self, x):
        b, c = x.shape[0], x.shape[-1]
        if c != self.dim:
            raise ValueError(f"feature dim {c} != configured dim {self.dim}")
        cd = self.compute_dtype
        x = x.reshape(b, -1, c).float()  # (B, HW, D)
        if self.normalize_input:
            x = _l2n(x)
        w = self.conv.weight.reshape(self.num_clusters, c)
        logits = (x.to(cd) @ w.t().to(cd)).float()  # (B, HW, K)
        if self.conv.bias is not None:
            logits = logits + self.conv.bias
        a = F.softmax(logits, dim=-1)
        weighted = (a.to(cd).transpose(1, 2) @ x.to(cd)).float()  # (B, K, D)
        vlad = weighted - a.sum(1)[..., None] * self.centroids[None]
        vlad = _l2n(vlad)                   # intra-normalisation
        vlad = _l2n(vlad.reshape(b, -1))    # K-major flatten, global L2
        if self.hidden1_weights is not None:
            vlad = (vlad.to(cd) @ self.hidden1_weights.to(cd)).float()
            if self.context_gating is not None:
                vlad = self.context_gating(vlad)
        return vlad


@torch.no_grad()
def init_netvlad_params(pool: NetVLAD, clusters, train_descs,
                        vladv2: bool = False) -> NetVLAD:
    """Data-dependent centroid and assignment init of ``pool``, in place.

    Port of ``gloc3d_tpu/models/netvlad.py::init_netvlad_params``, fp32 on
    the CPU as the JAX version computes in numpy. ``clusters (K, D)`` are
    k-means centroids, ``train_descs (M, D)`` sampled local descriptors.

    - vladv1: alpha from the mean gap between each descriptor's two largest
      dot products with the normalised centroids; assignment weight =
      alpha · normalised centroids.
    - vladv2: alpha from the mean gap between each centroid's two smallest
      squared distances to the descriptors; weight = 2·alpha·centroids,
      bias = −alpha·‖centroids‖. The distances, as the math calls for (the
      reference squares the neighbours' indices instead), as in JAX.
    """
    c = torch.as_tensor(clusters, dtype=torch.float32).detach().cpu()
    x = torch.as_tensor(train_descs, dtype=torch.float32).detach().cpu()
    if not vladv2:
        norm = c / c.norm(dim=1, keepdim=True).clamp_min(1e-12)
        dots = (norm @ x.t()).sort(dim=0, descending=True).values  # (K, M)
        alpha = -math.log(0.01) / float((dots[0] - dots[1]).mean())
        weight = alpha * norm
    else:
        # (K, M) squared distances, one centroid at a time (not (K, M, D))
        d2 = torch.stack([((x - ck) ** 2).sum(-1) for ck in c])
        d2 = d2.sort(dim=1).values
        alpha = -math.log(0.01) / float((d2[:, 1] - d2[:, 0]).mean())
        weight = 2.0 * alpha * c
        pool.conv.bias.copy_(-alpha * c.norm(dim=1))
    pool.centroids.copy_(c)
    pool.conv.weight.copy_(weight[:, :, None, None])
    return pool
