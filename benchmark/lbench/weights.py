"""Seeded weights of the unfolded model, made on the device in a few large
calls, and NetVLAD's data-initialised clusters.

Convolution and projection weights are normal with std 1/sqrt(fan in);
BatchNorm scales 1 + 0.1·N(0, 1), shifts and running means 0.1·N(0, 1),
running variances uniform in [0.5, 2] (so that folding them matters);
VGG16's biases 0.01·N(0, 1). NetVLAD's centroids are K unit local
features of the reference encoder, sampled from the feature maps of the
map's first scans, and its assignment weights alpha·centroids: seeded
centroids (uniform in [0, 1)) dwarf unit-norm features, so every
descriptor would be nearly the same and the ranking decided by rounding.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from lbench.reference import models
from lbench.reference.pipeline import ieee_fp32

ALPHA = 30.0


def seeded_params(mcfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every tensor of ``models.param_specs`` but the clusters, drawn from
    one normal and one uniform call on ``device``."""
    specs = [s for s in models.param_specs(mcfg)
             if s[2] not in ("centroids", "assign")]
    sizes = [math.prod(shape) for _, shape, _ in specs]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape, kind), n in zip(specs, sizes):
        z = normal[at:at + n].reshape(shape)
        u = uniform[at:at + n].reshape(shape)
        at += n
        if kind == "weight":
            out[name] = z / math.sqrt(math.prod(shape[1:]))
        elif kind == "hidden1":
            out[name] = z / math.sqrt(mcfg["encoder_dim"])
        elif kind == "bn_weight":
            out[name] = 1.0 + 0.1 * z
        elif kind in ("bn_bias", "bn_mean"):
            out[name] = 0.1 * z
        elif kind == "bn_var":
            out[name] = 0.5 + 1.5 * u
        elif kind == "bias":
            out[name] = 0.01 * z
        elif kind == "count":
            out[name] = torch.zeros((), dtype=torch.long, device=device)
        else:
            raise ValueError(f"no draw for {name} ({kind})")
    return out


@torch.no_grad()
def init_clusters(params: Dict[str, torch.Tensor], cfg: dict, inputs,
                  masks, seed: int, device) -> None:
    """Centroids (and assignment weights ALPHA·centroids) in place: K unit
    local features of the reference encoder on ``inputs`` (scans with
    ``masks``, or BEV images), picked by a seeded permutation."""
    mcfg = cfg["model"]
    k, d = mcfg["num_clusters"], mcfg["encoder_dim"]
    params["pool.centroids"] = torch.zeros((k, d), device=device)
    params["pool.conv.weight"] = torch.zeros((k, d, 1, 1), device=device)
    x = torch.as_tensor(inputs, device=device)
    m = None if masks is None else torch.as_tensor(masks, device=device)
    with ieee_fp32():
        feats = models.features(params, mcfg, cfg["voxel"], x, m)
    f = torch.nn.functional.normalize(feats.reshape(-1, d).float(), dim=-1)
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    pick = torch.randperm(f.shape[0], generator=gen, device=device)[:k]
    params["pool.centroids"] = f[pick].contiguous()
    params["pool.conv.weight"] = (ALPHA * f[pick])[:, :, None, None
                                                  ].contiguous()
