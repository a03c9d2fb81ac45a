"""On-device hard-negative mining.

Port of ``gloc3d_tpu/train/mining.py``: one batched computation over the
device feature cache mines a whole query batch.

- hardest positive: the nontrivial positive (≤ 10 m) nearest in feature
  space;
- negatives: ``n_sample`` random potential negatives (> 20 m) plus the
  query's negative cache, ranked by feature distance (a stable sort, as
  ``jnp.argsort``), margin violators ``d_neg < d_pos + √margin`` kept, the
  first ``n_neg`` taken;
- a query with no positive or no violator is invalid (the loss masks it).

torch cannot replay ``jax.random.categorical``, so the random draws are
injectable: ``samples`` (B, n_sample) negative candidates. By default they
are drawn uniformly over each query's potential negatives from a CPU
``torch.Generator``, so the same generator gives the same draws on every
device.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class MinedTriplets(NamedTuple):
    pos_idx: torch.Tensor    # (B,) hardest positive db index
    neg_idx: torch.Tensor    # (B, n_neg) selected negative db indices
    neg_valid: torch.Tensor  # (B, n_neg) 1.0 where the slot holds a violator
    valid: torch.Tensor      # (B,) ≥ 1 positive and ≥ 1 violating negative
    d_pos: torch.Tensor      # (B,) feature distance to the hardest positive


def _draw_uniform(weights: torch.Tensor, num: int,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """(B, N) 0/1 eligibility → (B, num) indices drawn uniformly with
    replacement among each row's eligible entries, on the CPU. A row with no
    eligible entry draws over all N (its draws are then rejected by the
    caller's mask, as JAX's all ``-inf`` categorical row is)."""
    w = weights.detach().float().cpu()
    w = torch.where(w.sum(1, keepdim=True) > 0, w, torch.ones_like(w))
    return torch.multinomial(w, num, replacement=True, generator=generator)


def mine_triplets(cache_db: torch.Tensor, cache_q: torch.Tensor,
                  query_idx: torch.Tensor, pos_mask: torch.Tensor,
                  neg_mask: torch.Tensor, neg_cache: torch.Tensor,
                  margin: float, n_neg: int = 10, n_sample: int = 1000,
                  samples: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> MinedTriplets:
    """cache_db (Ndb, D), cache_q (Nq, D), query_idx (B,), pos/neg masks
    (Nq, Ndb) bool, neg_cache (Nq, n_neg) → MinedTriplets on the caches'
    device. ``samples``: the (B, n_sample) negative draw, else drawn from
    ``generator``."""
    dev = cache_db.device
    query_idx = query_idx.to(dev).long()
    qf = cache_q[query_idx]
    pmask = pos_mask[query_idx]
    nmask = neg_mask[query_idx]

    d2 = ((qf * qf).sum(1)[:, None] - 2.0 * qf @ cache_db.t()
          + (cache_db * cache_db).sum(1)[None, :]).clamp_min(0.0)

    inf = torch.tensor(math.inf, device=dev)
    d2_pos = torch.where(pmask, d2, inf)
    pos_idx = d2_pos.argmin(1)
    d_pos = torch.sqrt(d2_pos.gather(1, pos_idx[:, None])[:, 0])
    has_pos = torch.isfinite(d_pos)

    if samples is None:
        samples = _draw_uniform(nmask, n_sample, generator)
    cand = torch.cat([samples.to(dev).long(),
                      neg_cache[query_idx].to(dev).long()], dim=1)
    d2_cand = torch.where(nmask.gather(1, cand), d2.gather(1, cand), inf)

    order = torch.argsort(d2_cand, dim=1, stable=True)
    cand_sorted = cand.gather(1, order)
    d_sorted = torch.sqrt(d2_cand.gather(1, order))
    violating = d_sorted < d_pos[:, None] + math.sqrt(margin)
    rank = violating.long().cumsum(1) - 1
    sel = torch.where(violating & (rank < n_neg), rank,
                      torch.full_like(rank, n_neg))
    neg_idx = _scatter_first(cand_sorted, sel, n_neg)
    n_violating = violating.sum(1)
    neg_valid = (torch.arange(n_neg, device=dev)[None, :]
                 < n_violating.clamp_max(n_neg)[:, None]).float()
    valid = has_pos & (n_violating > 0)
    return MinedTriplets(pos_idx, neg_idx, neg_valid, valid, d_pos)


def mine_other_negative(neg_mask: torch.Tensor, query_idx: torch.Tensor,
                        neg_idx: torch.Tensor,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """The quadruplet loss's 'other negative' per query: a uniformly drawn
    db entry that is a potential negative of the query and not among its
    selected negatives → (B,) on ``neg_mask``'s device."""
    nmask = neg_mask[query_idx.to(neg_mask.device).long()]
    selected = torch.zeros_like(nmask).scatter_(
        1, neg_idx.to(nmask.device).long(), True)
    eligible = nmask & ~selected
    return _draw_uniform(eligible, 1, generator)[:, 0].to(neg_mask.device)


def _scatter_first(cand_sorted: torch.Tensor, sel: torch.Tensor,
                   n_neg: int) -> torch.Tensor:
    """Place the j-th margin-violating candidate at slot j (j < n_neg);
    ``sel == n_neg`` marks a dropped candidate."""
    out = torch.zeros((cand_sorted.shape[0], n_neg + 1),
                      dtype=cand_sorted.dtype, device=cand_sorted.device)
    return out.scatter_(1, sel, cand_sorted)[:, :n_neg]
