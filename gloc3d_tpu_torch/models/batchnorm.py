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

Parameter and buffer names are ``nn.BatchNorm*d``'s, so state dicts and the
Flax bridge (``convert.py``) are unchanged; eval mode is ``nn.BatchNorm``'s.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """Per-channel BatchNorm of ``(R, C)`` rows or ``(B, C, H, W)`` maps."""

    def _check_input_dim(self, x: torch.Tensor) -> None:
        if x.dim() not in (2, 4):
            raise ValueError(f"expected (R, C) or (B, C, H, W), got "
                             f"{tuple(x.shape)}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(x)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
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
