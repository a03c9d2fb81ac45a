"""NetVLAD centroid initialisation from encoder descriptors.

Port of ``gloc3d_tpu/train/cluster.py`` (the reference's cluster mode):
sample scans (or BEV images, i2i), take random spatial positions of the
encoder's channel-wise L2-normalised feature map, k-means them into
``num_clusters`` centroids, then set NetVLAD's assignment conv from them
(``init_netvlad_params``).

The random draws are injectable (``draws``, ``seed_draws``) so a test can
replay JAX's; by default they come from a CPU ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gloc3d_tpu_torch.index.kmeans import kmeans
from gloc3d_tpu_torch.models.netvlad import init_netvlad_params


@torch.no_grad()
def sample_encoder_descriptors(
    model, inputs: np.ndarray, masks: Optional[np.ndarray],
    generator: Optional[torch.Generator] = None,
    num_images: int = 500, per_image: int = 100, batch: int = 8,
    l2_normalize: bool = True,
    draws: Optional[Tuple[Sequence[int], np.ndarray]] = None,
) -> torch.Tensor:
    """``(len(sel)·per_image, D)`` encoder features at random positions,
    on the model's device. ``masks`` is None for BEV images (an image
    encoder). ``draws = (sel, positions)``: the scans to
    encode, in order, and a ``(len(sel), per_image)`` array of flat
    positions in the ``gy·gx`` map; drawn from ``generator`` otherwise (a
    permutation, then per batch of scans, uniform positions)."""
    dev = next(model.parameters()).device
    n = len(inputs)
    if draws is None:
        sel = torch.randperm(n, generator=generator)[:min(num_images, n)]
        positions = None
    else:
        sel, positions = draws
    sel = np.asarray(sel)
    was_training = model.training
    model.eval()
    out = []
    try:
        for i in range(0, len(sel), batch):
            idx = sel[i:i + batch]
            mask = (None if masks is None else torch.from_numpy(
                np.asarray(masks[idx], np.float32)).to(dev))
            feat = model.encode(
                torch.from_numpy(np.asarray(inputs[idx], np.float32)).to(dev),
                mask)
            b, h, w, c = feat.shape
            flat = feat.reshape(b, h * w, c).float()
            if l2_normalize:
                flat = flat * torch.rsqrt((flat * flat).sum(-1, keepdim=True)
                                          + 1e-12)
            pos = (torch.randint(h * w, (b, per_image), generator=generator)
                   if positions is None
                   else torch.as_tensor(np.array(positions[i:i + batch])))
            pos = pos.to(dev).long()
            out.append(flat.gather(1, pos[..., None].expand(-1, -1, c))
                       .reshape(-1, c))
    finally:
        model.train(was_training)
    return torch.cat(out)


def init_vlad_from_data(
    cfg, model, inputs: np.ndarray, masks: Optional[np.ndarray],
    generator: Optional[torch.Generator] = None,
    num_images: int = 500, per_image: int = 100,
    draws=None, seed_draws=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cluster mode + NetVLAD init in one call: sets ``model.pool``'s
    centroids and assignment conv in place and returns (centroids (K, D),
    sampled descriptors (M, D))."""
    descs = sample_encoder_descriptors(model, inputs, masks, generator,
                                       num_images, per_image, draws=draws)
    cents, _ = kmeans(descs, cfg.model.num_clusters, num_iters=100,
                      generator=generator, seed_draws=seed_draws)
    init_netvlad_params(model.pool, cents, descs, vladv2=cfg.model.vladv2)
    return cents, descs
