"""Spatial partition: one image's forward computed by every rank of a
process group.

Port of ``gloc3d_tpu/parallel/spatial.py``. Bank sharding and data
parallelism split the database and the batch, but a B=1 query still pays
the whole conv stack on one device. Here the (B, H, W, C) activations are
split on their HEIGHT axis over the ranks: rank r holds the rows
[⌊r·h/P⌋, ⌊(r+1)·h/P⌋) of every layer's h-row output (contiguous bands,
uneven where P does not divide h), runs each conv and pool on its band, and
the pooling head's spatial sums are added over the group. JAX writes none
of this: the program is ``model.apply`` with the input sharded on H, and
GSPMD inserts the halo exchanges and the psum. In torch the partition is
written by hand, as the conv and max-pool that every encoder's own forward
takes as its ``ops`` (``models/layer_ops.py``). The images are square, so
a band's rows over every rank are its width at every layer:

- **Halo rows.** Before a conv or pool of kernel k, stride s and padding p
  along H, the rank's output rows [o0, o1) read the input rows
  [o0·s − p, (o1 − 1)·s − p + k). Rows outside the image are the padding
  (zeros before a conv, −inf before a max-pool), rows of another rank are
  fetched from it, whichever rank owns them, not only a neighbour: every
  rank sends the rows of its band that any other rank reads, padded to the
  most any rank sends, in one all-gather (skipped where no rank reads
  another's rows, as for a 1×1 stride-1 conv). The window is a
  concatenation of slices (no index goes to the device); the padding rows
  that both of its ends have become the op's own padding along H, so a
  one-rank group runs each op as the unsharded forward does, on the
  activation itself. Each layer's halo comes from its own kernel, stride and
  padding: VGG16's 3×3/1 convs and 2×2/2 pools, ResNet18's 7×7/2 stem,
  3×3/2 max-pool and 1×1/2 shortcuts, MobileNetV2's depthwise 3×3/2,
  AlexNet's 11×11/4 stem and 3×3/2 pools.
- **Pooling heads.** NetVLAD's two sums over the locations
  (``NetVLAD.sums``) go through one SUM all-reduce; the max head's maxima
  through a MAX all-reduce, the avg head's sums through a SUM all-reduce
  over the global count. Intra-normalisation, flatten, L2 and the FC run on
  the reduced tensors, which every rank holds alike, so every rank returns
  the same descriptors.

The exchange uses only all-gather and all-reduce, which gloo runs on CUDA
tensors as well as NCCL. Results equal the unsharded forward up to the
order of the heads' sums and the convolution algorithm that cuDNN picks
for a band.

The s2s PointPillar path is not spatially partitioned, as in JAX: its conv
stack is small, and it shards on the batch axis (``shard_extraction``).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from gloc3d_tpu_torch.models.descriptor import (
    _AvgPoolHead, _MaxPoolHead, unit_rows,
)
from gloc3d_tpu_torch.models.encoders import (
    AlexNetEncoder, MobileNetV2Encoder, ResNet18Encoder,
)
from gloc3d_tpu_torch.models.netvlad import NetVLAD
from gloc3d_tpu_torch.models.vgg import VGG16Encoder
from gloc3d_tpu_torch.parallel.collectives import all_gather, group_shape
from gloc3d_tpu_torch.parallel.data import require_group

Tensor = torch.Tensor


def _bounds(n: int, world: int) -> Tuple[int, ...]:
    """Band edges of n rows over ``world`` ranks: rank r holds rows
    [edges[r], edges[r + 1])."""
    return tuple(n * r // world for r in range(world + 1))


class _Plan(NamedTuple):
    """One rank's part in a (k, stride, pad) op over h input rows. A
    segment is (first slot, rows) of the all-gathered rows, or (-1, rows)
    of padding."""
    out_rows: int                  # the op's output rows, over every rank
    n_out: int                     # this rank's output rows
    send: Tuple[Tuple[int, int], ...]  # (first local row, rows) others read
    width: int                     # rows each rank sends (the most any does)
    pad: int                       # padding rows the op adds at both ends
    before: Tuple[Tuple[int, int], ...]  # window segments before the band
    after: Tuple[Tuple[int, int], ...]   # and after it
    own: Tuple[int, int]           # the band's local rows [a, b) it reads


def _runs(items, fill=None) -> Tuple[Tuple[int, int], ...]:
    """Consecutive runs of ``items`` as (first, count): ``fill`` entries
    as (-1, count), other entries where each is one more than the last."""
    runs = []
    for v in items:
        if runs and ((v == fill and runs[-1][0] == -1) or (
                v != fill and runs[-1][0] != -1
                and v == runs[-1][0] + runs[-1][1])):
            runs[-1][1] += 1
        else:
            runs.append([-1 if v == fill else v, 1])
    return tuple((a, n) for a, n in runs)


@functools.lru_cache(maxsize=None)
def _plan(h: int, k: int, stride: int, pad: int, world: int, rank: int
          ) -> _Plan:
    out_rows = (h + 2 * pad - k) // stride + 1
    ib, ob = _bounds(h, world), _bounds(out_rows, world)

    def reads(r):
        """Input rows [lo, hi) that rank r's output rows read."""
        if ob[r] == ob[r + 1]:
            return 0, 0
        return ob[r] * stride - pad, (ob[r + 1] - 1) * stride - pad + k

    sends = []
    for q in range(world):
        rows = set()
        for r in range(world):
            if r != q:
                lo, hi = reads(r)
                rows.update(range(max(lo, ib[q]), min(hi, ib[q + 1])))
        sends.append(sorted(rows))
    width = max(len(s) for s in sends)
    slot = {g: q * width + i for q, s in enumerate(sends)
            for i, g in enumerate(s)}
    send = _runs([g - ib[rank] for g in sends[rank]])
    n_out = ob[rank + 1] - ob[rank]
    if n_out == 0:  # run the op on k padding rows, keep none of its output
        return _Plan(out_rows, 0, send, width, 0, ((-1, k),), (), (0, 0))
    lo, hi = reads(rank)
    a, b = max(lo, ib[rank]), min(hi, ib[rank + 1])
    if a >= b:
        a = b = ib[rank]
    # rows outside the image (padding) lie at the window's two ends; as
    # many as both ends have become the op's own padding
    before = [slot.get(g) for g in range(lo, hi) if g < a]
    after = [slot.get(g) for g in range(lo, hi) if g >= b]
    lead = next((i for i, v in enumerate(before) if v is not None),
                len(before))
    trail = next((i for i, v in enumerate(reversed(after)) if v is not None),
                 len(after))
    both = min(lead, trail)
    return _Plan(out_rows, n_out, send, width, both,
                 _runs(before[both:]), _runs(after[:len(after) - both]),
                 (a - ib[rank], b - ib[rank]))


def _like(t: Tensor, x: Tensor) -> Tensor:
    """``t`` in ``x``'s memory format (channels-last activations stay so
    through a concatenation)."""
    if x.is_contiguous(memory_format=torch.channels_last):
        return t.contiguous(memory_format=torch.channels_last)
    return t


def _even(v) -> int:
    """An op's kernel, stride or padding, alike along H and W."""
    h, w = (v, v) if isinstance(v, int) else v
    if h != w:
        raise ValueError(f"the spatial partition takes ops alike along H "
                         f"and W, not {v}")
    return h


class _Rows:
    """The halo exchange and the row-split conv and max-pool over a process
    group: the ``LayerOps`` that the encoders' forwards take. An activation
    is this rank's band (B, C, h_r, W) of a square one, so its rows over
    every rank are its width W at every layer."""

    def __init__(self, group):
        self.group = group
        self.world, self.rank = group_shape(group)

    def window(self, x: Tensor, plan: _Plan, fill: float) -> Tensor:
        """The input rows this rank's output rows read, but the ``plan.pad``
        padding rows at each end, which the op adds itself; other padding
        rows set to ``fill``. Every rank joins the all-gather whenever any
        rank reads another's rows."""
        got = None
        b, c, _, w = x.shape
        if plan.width:
            buf = x.new_zeros((b, c, plan.width, w))
            at = 0
            for first, n in plan.send:
                buf[:, :, at:at + n] = x[:, :, first:first + n]
                at += n
            got = all_gather(self.group, buf).permute(1, 2, 0, 3, 4).reshape(
                b, c, self.world * plan.width, w)
        a, b_ = plan.own
        if not (plan.before or plan.after):
            return x[:, :, a:b_]

        def part(seg):
            first, n = seg
            if first < 0:
                return _like(x.new_full((b, c, n, w), fill), x)
            return _like(got[:, :, first:first + n], x)

        return torch.cat([*map(part, plan.before), x[:, :, a:b_],
                          *map(part, plan.after)], 2)

    def _plan(self, x: Tensor, m: nn.Module) -> _Plan:
        """The plan of the conv or pool ``m`` on the band ``x``."""
        return _plan(x.shape[3], *(_even(v) for v in (
            m.kernel_size, m.stride, m.padding)), self.world, self.rank)

    def conv(self, m: nn.Conv2d, x: Tensor, cd: torch.dtype) -> Tensor:
        """``models/layer_ops.py::conv`` on the band: ``m`` in ``cd``."""
        plan = self._plan(x, m)
        x = self.window(x.to(cd), plan, 0.0)
        bias = None if m.bias is None else m.bias.to(cd)
        y = F.conv2d(x, m.weight.to(cd), bias, m.stride,
                     (plan.pad, m.padding[1]), groups=m.groups)
        return y[:, :, :plan.n_out]

    def max_pool(self, m: nn.MaxPool2d, x: Tensor) -> Tensor:
        plan = self._plan(x, m)
        y = F.max_pool2d(self.window(x, plan, -math.inf), m.kernel_size,
                         m.stride, (plan.pad, _even(m.padding)))
        return y[:, :, :plan.n_out]


_IMAGE_ENCODERS = (VGG16Encoder, AlexNetEncoder, MobileNetV2Encoder,
                   ResNet18Encoder)


def _head(group, pool: nn.Module, feat: Tensor) -> Tensor:
    """The pooling head on this rank's (B, h_r, W, D) features of a square
    (W, W) map, its spatial reductions taken over the group."""
    b = feat.shape[0]
    if isinstance(pool, NetVLAD):
        weighted, a_sum = pool.sums(feat)
        k = weighted.shape[1]
        both = torch.cat([weighted.reshape(b, -1), a_sum], 1)
        dist.all_reduce(both, group=group)
        return pool.finish(both[:, :-k].view(weighted.shape), both[:, -k:])
    if isinstance(pool, _MaxPoolHead):
        v = (feat.float().amax(dim=(1, 2)) if feat.shape[1] else
             feat.new_full((b, feat.shape[-1]), -math.inf, dtype=torch.float32))
        dist.all_reduce(v, op=dist.ReduceOp.MAX, group=group)
        return unit_rows(v)
    if isinstance(pool, _AvgPoolHead):
        v = feat.float().sum(dim=(1, 2))
        dist.all_reduce(v, group=group)
        return unit_rows(v / feat.shape[2] ** 2)
    raise TypeError(f"no spatial partition for the head "
                    f"{type(pool).__name__}")


def spatial_sharded_apply(mesh, model, axis: str = "data"):
    """``fn(images (B, S, S, 3)) -> descriptors (B, D)``: ``model`` (a
    ``DescriptorModel`` with an image encoder) with each image's rows split
    over the ranks of the process group ``mesh`` (None: the default group;
    ``axis`` names JAX's mesh axis, a process group has one). Every rank
    calls ``fn`` with the whole batch (SPMD), runs the encoder's own
    forward on its band of rows with the row-split conv and max-pool, and
    returns the same descriptors as every other rank; they equal
    ``model(images)`` up to the order of the heads' sums. The images are
    square, as BEV images are."""
    group = require_group(mesh, "spatial_sharded_apply")
    if not isinstance(getattr(model, "encoder", None), _IMAGE_ENCODERS):
        raise TypeError("spatial_sharded_apply takes a DescriptorModel with "
                        "an image encoder (vgg16, resnet18, mobilenet, "
                        "alexnet)")
    ops = _Rows(group)

    @torch.no_grad()
    def fn(images) -> Tensor:
        device = next(model.parameters()).device
        images = torch.as_tensor(images, dtype=torch.float32, device=device)
        s = images.shape[1]
        if images.shape[2] != s:
            raise ValueError(f"spatial_sharded_apply takes square images, "
                             f"not {tuple(images.shape[1:3])}")
        lo, hi = _bounds(s, ops.world)[ops.rank:ops.rank + 2]
        return _head(group, model.pool, model.encoder(images[:, lo:hi], ops))

    return fn


def check_divisible(image_size: int, n_devices: int, n_pools: int = 4) -> None:
    """Raise unless every pooled resolution still splits evenly over the mesh
    (uneven slabs force XLA into padded halos with wasted lanes)."""
    h = image_size
    for _ in range(n_pools + 1):
        if h % n_devices != 0:
            raise ValueError(
                f"image height {image_size} does not tile {n_devices} devices "
                f"at every pooling level (failed at {h} rows)"
            )
        h //= 2
