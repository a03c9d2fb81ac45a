"""Lloyd's k-means with k-means++ seeding, for NetVLAD's centroid init.

Port of ``gloc3d_tpu/index/kmeans.py``: assignment by one matmul and an
argmin, the update by an ``index_add_``, empty clusters re-seeded from the
point farthest from its centroid. Runs on ``data``'s device.

The seeding's random draws are injectable, because torch cannot replay JAX
PRNG streams: ``seed_draws = (first, gumbel)``, the first seed's row index
and a (K−1, N) Gumbel noise array. Each further seed is
``argmax(log(p + 1e-20) + gumbel[j])`` with p ∝ the squared distance to the
nearest seed so far, which is how ``jax.random.categorical`` draws; fed
JAX's own noise, the port picks the same seeds. By default the draws come
from a CPU ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _draw_seeds(n: int, k: int,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[int, torch.Tensor]:
    """The default ``seed_draws``: a uniform first index and (K−1, N)
    standard Gumbel noise, on the CPU."""
    first = int(torch.randint(n, (), generator=generator))
    u = torch.rand((k - 1, n), generator=generator).clamp(1e-12, 1 - 1e-7)
    return first, -torch.log(-torch.log(u))


def kmeans(data: torch.Tensor, num_clusters: int, num_iters: int = 100,
           generator: Optional[torch.Generator] = None,
           seed_draws: Optional[Tuple[int, torch.Tensor]] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cluster ``data (N, D)`` → (centroids (K, D), assignments (N,))."""
    data = data.float()
    n, d = data.shape
    k = num_clusters
    x_sq = (data * data).sum(-1)
    first, gumbel = (seed_draws if seed_draws is not None
                     else _draw_seeds(n, k, generator))
    gumbel = torch.as_tensor(gumbel, dtype=torch.float32, device=data.device)

    def d2_to(c: torch.Tensor) -> torch.Tensor:
        return (x_sq - 2.0 * (data @ c) + (c * c).sum()).clamp_min(0.0)

    seeds = [data[int(first)]]
    mind2 = d2_to(seeds[0])
    for j in range(k - 1):
        p = mind2 / mind2.sum().clamp_min(1e-12)
        nxt = data[torch.argmax(torch.log(p + 1e-20) + gumbel[j])]
        seeds.append(nxt)
        mind2 = torch.minimum(mind2, d2_to(nxt))
    cents = torch.stack(seeds)

    def assign(c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        d2 = x_sq[:, None] - 2.0 * (data @ c.t()) + (c * c).sum(-1)[None, :]
        dist, a = d2.min(-1)
        return a, dist

    ones = torch.ones(n, device=data.device)
    for _ in range(num_iters):
        a, dist = assign(cents)
        sums = torch.zeros((k, d), device=data.device).index_add_(0, a, data)
        cnts = torch.zeros(k, device=data.device).index_add_(0, a, ones)
        new = sums / cnts.clamp_min(1.0)[:, None]
        far = data[torch.argmax(dist)]  # re-seed empties: farthest point
        cents = torch.where((cnts > 0)[:, None], new, far[None, :])
    return cents, assign(cents)[0]
