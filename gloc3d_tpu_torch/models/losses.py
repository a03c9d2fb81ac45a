"""Metric-learning losses of the triplet trainer.

Port of ``gloc3d_tpu/models/losses.py``:

- ``triplet_margin_loss``: ``nn.TripletMarginLoss(margin, p=2,
  reduction='sum')`` semantics;
- ``training_triplet_loss``: the step loss, per-(query, negative) triplet
  losses over padded negatives, summed and divided by the real negatives;
- ``best_pos_distance``, ``batched_triplet_loss``,
  ``batched_quadruplet_loss``: the PointNetVLAD-style losses (squared
  distances; lazy / min / ignore-zero variants);
- ``pose_loss``: the relative-pose loss of the pose trainer
  (``train/pose.py``).

Distances are ``_l2`` with the eps inside the sqrt (torch
``pairwise_distance``; keeps the gradient finite at 0).
"""

from __future__ import annotations

from typing import Tuple

import torch

from gloc3d_tpu_torch.core.transforms import (
    angle_axis_to_quat, quat_conj, quat_mul, quat_rotate, quat_to_angle_axis,
)


def _l2(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return torch.sqrt(((a - b) ** 2).sum(-1) + eps)


def triplet_margin_loss(anchor: torch.Tensor, positive: torch.Tensor,
                        negative: torch.Tensor, margin: float
                        ) -> torch.Tensor:
    """Σ max(‖a−p‖ − ‖a−n‖ + margin, 0) over the batch."""
    return torch.clamp_min(
        _l2(anchor, positive) - _l2(anchor, negative) + margin, 0.0).sum()


def training_triplet_loss(q: torch.Tensor, pos: torch.Tensor,
                          negs: torch.Tensor, neg_mask: torch.Tensor,
                          margin: float) -> torch.Tensor:
    """q, pos (B, D); negs (B, Nneg, D); neg_mask (B, Nneg) 1.0 for real
    negatives → Σ per-pair triplet loss / max(#real negatives, 1)."""
    d_pos = _l2(q, pos)[:, None]
    d_neg = _l2(q[:, None, :], negs)
    per_pair = torch.clamp_min(d_pos - d_neg + margin, 0.0) * neg_mask
    return per_pair.sum() / torch.clamp_min(neg_mask.sum(), 1.0)


def best_pos_distance(query: torch.Tensor, pos_vecs: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """query (B, D), pos_vecs (B, P, D) → min and max squared distance."""
    d = ((pos_vecs - query[:, None, :]) ** 2).sum(-1)
    return d.amin(1), d.amax(1)


def _reduce(loss: torch.Tensor, lazy: bool, ignore_zero_loss: bool
            ) -> torch.Tensor:
    loss = loss.amax(1) if lazy else loss.sum(1)
    if ignore_zero_loss:
        hard = (loss > 1e-16).to(loss.dtype)
        return loss.sum() / (hard.sum() + 1e-16)
    return loss.mean()


def batched_triplet_loss(q: torch.Tensor, pos: torch.Tensor,
                         negs: torch.Tensor, margin: float,
                         use_min: bool = False, lazy: bool = False,
                         ignore_zero_loss: bool = False) -> torch.Tensor:
    """PointNetVLAD batched triplet loss on squared distances."""
    min_pos, max_pos = best_pos_distance(q, pos)
    positive = min_pos if use_min else max_pos
    d_neg = ((negs - q[:, None, :]) ** 2).sum(-1)
    return _reduce(torch.clamp_min(margin + positive[:, None] - d_neg, 0.0),
                   lazy, ignore_zero_loss)


def batched_quadruplet_loss(q: torch.Tensor, pos: torch.Tensor,
                            negs: torch.Tensor, other_neg: torch.Tensor,
                            m1: float, m2: float, use_min: bool = False,
                            lazy: bool = False,
                            ignore_zero_loss: bool = False) -> torch.Tensor:
    """Triplet loss plus a second margin against ``other_neg`` (B, D), a
    negative far from the query's selected negatives."""
    first = batched_triplet_loss(q, pos, negs, m1, use_min, lazy,
                                 ignore_zero_loss)
    min_pos, max_pos = best_pos_distance(q, pos)
    positive = min_pos if use_min else max_pos
    d_on = ((negs - other_neg[:, None, :]) ** 2).sum(-1)
    second = torch.clamp_min(m2 + positive[:, None] - d_on, 0.0)
    return first + _reduce(second, lazy, ignore_zero_loss)


def pose_loss(pred: torch.Tensor, gt: torch.Tensor,
              angle_scale: float = 1.0) -> torch.Tensor:
    """pred, gt (B, 6) [angle-axis | translation] → angle_scale · mean
    rotation error + mean translation error. The rotation error is the norm
    of the angle-axis of gt⁻¹·pred; the translation error is rotated into
    the gt frame. Where an error is exactly a zero vector (pred = gt) the
    gradient of its norm is 0 here (torch's norm) and NaN in JAX."""
    q_pred = angle_axis_to_quat(pred[:, :3])
    q_gt = angle_axis_to_quat(gt[:, :3])
    dq = quat_mul(quat_conj(q_gt), q_pred)
    dr = torch.linalg.vector_norm(quat_to_angle_axis(dq), dim=-1)
    dt = quat_rotate(quat_conj(q_gt), pred[:, 3:] - gt[:, 3:])
    dt = torch.linalg.vector_norm(dt, dim=-1)
    return angle_scale * dr.mean() + dt.mean()
