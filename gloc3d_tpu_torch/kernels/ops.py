"""The hand-written kernels as ``torch.library`` custom ops.

``gloc3d::segment_sum_sorted(values, starts)`` (K1, ``segment_sum.py``),
``gloc3d::pillar_bin_sums(features, ids, num_voxels)`` (K2,
``bin_sums.py``; also ``gloc3d::pillar_bin_sums_status``, below) and
``gloc3d::knn_normals(points, ok, k)`` (the ground estimate's k-NN PCA
normals, ``knn_normals.py``) are the only route to each kernel. The
dispatcher picks the implementation from the tensors' device: on CUDA
tensors the hand-written kernel (the wrapper's checks, then its ctypes
launch, counted in ``segment_sum_sorted.launches`` /
``pillar_bin_sums.launches`` / ``knn_normals.launches``, and for K2 the
kernel's own id-range status read back), on CPU tensors the plain version;
any other device has no implementation and raises.
``gloc3d::pillar_bin_sums_status`` is K2 returning its status block
instead of reading it (``bin_sums.py::deferred_status``), for a program
that must not synchronise. Each op also has a fake implementation, which
gives the output shapes from the arguments alone (V from
``starts.shape[-1] - 1`` or from ``num_voxels``; the normals take the
points' shape), so ``torch.export`` and ``torch.compile`` trace the op as
one node: an exported program carries the op and runs the kernel wherever
it is loaded onto a card, never the plain version that the tracing device
happened to run.

A process that only runs an exported program imports this module (which
registers the ops) and nothing of the models or the pipeline.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from gloc3d_tpu_torch.kernels import bin_sums as _bs
from gloc3d_tpu_torch.kernels import knn_normals as _kn
from gloc3d_tpu_torch.kernels import segment_sum as _ss


@torch.library.custom_op("gloc3d::segment_sum_sorted", mutates_args=(),
                         device_types="cpu")
def segment_sum_sorted(values: torch.Tensor,
                       starts: torch.Tensor) -> torch.Tensor:
    return _ss.segment_sum_sorted_plain(values, starts)


@segment_sum_sorted.register_kernel("cuda")
def _segment_sum_sorted_cuda(values, starts):
    _ss._check(values, starts)
    return _ss._launch(values, starts)


@segment_sum_sorted.register_fake
def _segment_sum_sorted_fake(values, starts):
    return values.new_empty(values.shape[:-2] + (
        starts.shape[-1] - 1, values.shape[-1]), dtype=torch.float32)


@torch.library.custom_op("gloc3d::pillar_bin_sums", mutates_args=(),
                         device_types="cpu")
def pillar_bin_sums(features: torch.Tensor, ids: torch.Tensor,
                    num_voxels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return _bs.pillar_bin_sums_plain(features, ids, num_voxels)


@pillar_bin_sums.register_kernel("cuda")
def _pillar_bin_sums_cuda(features, ids, num_voxels):
    _bs._check(features, ids, num_voxels)
    sums, counts, status = _bs._launch(features, ids, num_voxels)
    _bs._check_status(status, ids, num_voxels)
    return sums, counts


@pillar_bin_sums.register_fake
def _pillar_bin_sums_fake(features, ids, num_voxels):
    lead = features.shape[:-2]
    return (features.new_empty(lead + (num_voxels, features.shape[-1]),
                               dtype=torch.float32),
            features.new_empty(lead + (num_voxels,), dtype=torch.float32))


@torch.library.custom_op("gloc3d::pillar_bin_sums_status", mutates_args=(),
                         device_types="cpu")
def pillar_bin_sums_status(features: torch.Tensor, ids: torch.Tensor,
                           num_voxels: int
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    return _bs.pillar_bin_sums_status_plain(features, ids, num_voxels)


@pillar_bin_sums_status.register_kernel("cuda")
def _pillar_bin_sums_status_cuda(features, ids, num_voxels):
    _bs._check(features, ids, num_voxels)
    sums, counts, status = _bs._launch(features, ids, num_voxels)
    return sums, counts, status.clone()


@pillar_bin_sums_status.register_fake
def _pillar_bin_sums_status_fake(features, ids, num_voxels):
    sums, counts = _pillar_bin_sums_fake(features, ids, num_voxels)
    b = math.prod(features.shape[:-2])
    return sums, counts, features.new_empty((b, 4), dtype=torch.int32)


# The k-NN normals run on every aligned path, also where no other of these
# ops runs (the i2i cells): defined through ``torch.library.Library``,
# whose kernels the dispatcher calls as they are, and not through
# ``custom_op``, whose backend wrapper imports ``torch._dynamo`` on the
# first call (2-4 s of a process's set-up). K1 and K2 above still pay that
# import on the s2s paths; defining them the same way, and measuring the
# s2s set-up it saves, is ROADMAP Queue 4's set-up item.
_lib = torch.library.Library("gloc3d", "FRAGMENT")
_lib.define("knn_normals(Tensor points, Tensor ok, int k) -> Tensor")


def _knn_normals_cpu(points, ok, k):
    return _kn.knn_normals_plain(points, ok, k)


def _knn_normals_cuda(points, ok, k):
    _kn._check(points, ok, k)
    return _kn._launch(points, ok, k)


def _knn_normals_fake(points, ok, k):
    return points.new_empty(points.shape)


_lib.impl("knn_normals", _knn_normals_cpu, "CPU")
_lib.impl("knn_normals", _knn_normals_cuda, "CUDA")
torch.library.register_fake("gloc3d::knn_normals", _knn_normals_fake,
                            lib=_lib)
