"""BatchNorm with ``flax.linen.BatchNorm``'s running-statistics update.

Both frameworks normalise a training batch with its mean and its biased
variance. They differ in what they keep: Flax moves ``batch_stats.var``
toward the biased variance, ``nn.BatchNorm*d`` moves ``running_var`` toward
the unbiased one, n/(n-1) larger. Over the PointNet's 2.9 M rows or a conv's
24·140·80 positions that is ~1e-6; over the context gating's batch of 24
descriptors it is 24/23, 4 %. This module keeps Flax's rule so the port's
running statistics, and hence its eval-mode descriptors, follow the
reference. Momentum 0.1 here is Flax's 0.9 (``new = 0.9·old + 0.1·batch``).

One reduction does both: ``F.batch_norm`` with momentum 1 writes the batch
mean and unbiased variance into two C-element buffers, and the running
statistics move toward those, the variance rescaled by (n-1)/n.

Data-parallel training (``train/trainer.py``, a JAX mesh is a process group
here) splits the batch over ranks, while JAX's replicated step normalises
over the whole batch. ``set_batchnorm_group`` (the counterpart of
``SyncBatchNorm.convert_sync_batchnorm``, which refuses CPU tensors) gives
every BatchNorm of a model a process group; in train mode such a module
normalises with the group's mean and biased variance: each rank's (count,
mean, M2) from ``torch.var_mean`` (fp32, one pass per channel, no E[x²] −
E[x]² cancellation), gathered in rank order and combined in float64 by
Chan's formula, so every rank gets the same bits. Its backward all-reduces
the two channel sums Σdy and Σdy·x̂ that the input gradient needs, as
``SyncBatchNorm`` does; the weight and bias gradients stay the rank's own,
summed by the trainer's gradient all-reduce. Eval mode and a module without
a group are unchanged.

Parameter and buffer names are ``nn.BatchNorm*d``'s, so state dicts and the
Flax bridge (``convert.py``) are unchanged; eval mode is ``nn.BatchNorm``'s.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from gloc3d_tpu_torch.parallel.collectives import all_gather


def _channel_view(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1) if x.dim() == 2 else v.view(1, -1, 1, 1)


def group_moments(group, x: torch.Tensor):
    """Per-channel mean and biased variance (float64) of ``x`` ((R, C) or
    (B, C, H, W)) over every rank's rows, and their count (a float64
    tensor: no host sync): each rank's (count, mean, M2) gathered in rank
    order and combined by Chan's formula, the same arithmetic on every
    rank."""
    dims = [0] if x.dim() == 2 else [0, 2, 3]
    var, mean = torch.var_mean(x, dim=dims, correction=0)
    n = x.numel() // x.shape[1]
    local = torch.stack([torch.full_like(mean, n, dtype=torch.float64),
                         mean.double(), var.double() * n])
    parts = all_gather(group, local)                  # (ranks, 3, C)
    counts, means, m2 = parts[:, 0], parts[:, 1], parts[:, 2]
    total = counts.sum(0)
    g_mean = (counts * means).sum(0) / total
    g_m2 = m2.sum(0) + (counts * (means - g_mean) ** 2).sum(0)
    return g_mean, g_m2 / total, total


class _GroupBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over a process group's rows (see the module
    docstring). Returns y and the group's (mean, biased variance)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        mean, var, total = group_moments(group, x)
        invstd = torch.rsqrt(var + eps).to(x.dtype)
        xhat = (x - _channel_view(x, mean.to(x.dtype))) * _channel_view(
            x, invstd)
        y = xhat
        if weight is not None:
            y = y * _channel_view(x, weight) + _channel_view(x, bias)
        ctx.save_for_backward(xhat, invstd, weight)
        ctx.total, ctx.group = total, group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        xhat, invstd, weight = ctx.saved_tensors
        dims = [0] if xhat.dim() == 2 else [0, 2, 3]
        sum_dy = dy.sum(dims)
        sum_dy_xhat = (dy * xhat).sum(dims)
        sums = torch.cat([sum_dy, sum_dy_xhat])
        dist.all_reduce(sums, group=ctx.group)
        g_dy, g_dy_xhat = sums.chunk(2)
        total = ctx.total.to(dy.dtype)
        scale = invstd if weight is None else invstd * weight
        dx = _channel_view(xhat, scale) * (
            dy - _channel_view(xhat, g_dy / total)
            - xhat * _channel_view(xhat, g_dy_xhat / total))
        if weight is None:
            return dx, None, None, None, None
        return dx, sum_dy_xhat, sum_dy, None, None


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """Per-channel BatchNorm of ``(R, C)`` rows or ``(B, C, H, W)`` maps;
    with ``group`` set (``set_batchnorm_group``), train mode normalises
    over the process group's rows."""

    group = None  # a torch.distributed process group, or None

    def _check_input_dim(self, x: torch.Tensor) -> None:
        if x.dim() not in (2, 4):
            raise ValueError(f"expected (R, C) or (B, C, H, W), got "
                             f"{tuple(x.shape)}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(x)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if self.group is not None:
            y, mean, var = _GroupBatchNorm.apply(x, self.weight, self.bias,
                                                 self.eps, self.group)
            with torch.no_grad():
                self.running_mean.lerp_(mean.to(self.running_mean.dtype),
                                        self.momentum)
                self.running_var.lerp_(var.to(self.running_var.dtype),
                                       self.momentum)
                self.num_batches_tracked += 1
            return y
        # zeros, not empty: momentum 1 still scales the old value by 0
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                         self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var * ((n - 1) / n), self.momentum)
            self.num_batches_tracked += 1
        return y


def set_batchnorm_group(model: nn.Module, group: Optional[object]
                        ) -> nn.Module:
    """Give every ``BatchNorm`` of ``model`` the process group ``group``
    (None: back to the rank's own batch); returns ``model``."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group
    return model
