"""The two ops of an image encoder's forward that change an activation's
rows: a convolution in a compute dtype and a max-pool.

Each image encoder's forward (``models/vgg.py``, ``models/encoders.py``)
takes them as its ``ops`` argument, ``PLAIN`` by default: both run on the
whole activation. ``parallel/spatial.py`` passes ops that run them on one
rank's band of rows, so the spatial partition runs each encoder's own
forward.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

Tensor = torch.Tensor


class LayerOps(NamedTuple):
    conv: Callable[[nn.Conv2d, Tensor, torch.dtype], Tensor]
    max_pool: Callable[[nn.MaxPool2d, Tensor], Tensor]


def conv(m: nn.Conv2d, x: Tensor, cd: torch.dtype) -> Tensor:
    """``m`` applied in ``cd`` (input, weight and bias rounded to it)."""
    bias = None if m.bias is None else m.bias.to(cd)
    return F.conv2d(x.to(cd), m.weight.to(cd), bias, m.stride, m.padding,
                    groups=m.groups)


def max_pool(m: nn.MaxPool2d, x: Tensor) -> Tensor:
    return m(x)


PLAIN = LayerOps(conv, max_pool)
