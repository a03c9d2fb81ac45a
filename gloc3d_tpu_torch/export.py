"""Model export: serialized programs that run without the model code.

Port of ``gloc3d_tpu/export.py``. The reference hands models from Python
to C++ through TorchScript traces (main.py:189-198 save →
loop_detector.h:47-57 load); the JAX package exports StableHLO with
``jax.export``. Here ``torch.export`` traces the eval-mode forward into an
``ExportedProgram`` with the weights inside, and ``torch.export.save``
writes it to bytes; any process reloads it without the model-building
code:

  blob = export_descriptor_model(model, example_points, example_mask)
  fn   = load_exported(blob)          # callable: inputs → descriptors

The kernels are ``torch.library`` custom ops (``kernels/ops.py``), so the
program carries ``gloc3d::pillar_bin_sums`` / ``gloc3d::segment_sum_sorted``
nodes, never the plain version of the tracing device: a program exported
on the CPU and moved to the card by ``load_exported`` launches the CUDA
kernels there. Moving a CPU export onto the card stands in for JAX's
``platforms=("cpu", "tpu")``, the cross-machine half of the hand-off. The
reloading process needs ``gloc3d_tpu_torch.kernels.ops`` (imported here)
to have the ops registered, and nothing of the models or the pipeline.

A program is specialized to its example shapes (B=1 for the query
descriptor, as in JAX). A blob is read only by the torch version that
wrote it: each machine exports its own.
"""

from __future__ import annotations

import io
from typing import Callable

import torch

from gloc3d_tpu_torch.core.device import resolve_device
from gloc3d_tpu_torch.kernels import ops  # noqa: F401  (registers the ops)


class _Function(torch.nn.Module):
    """A plain callable as the module ``torch.export`` takes."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_program(fn: Callable, *example_args
                   ) -> torch.export.ExportedProgram:
    """Trace ``fn`` (a module or a plain callable) on the example inputs,
    without autograd, into an ``ExportedProgram``."""
    module = fn if isinstance(fn, torch.nn.Module) else _Function(fn)
    with torch.no_grad():
        return torch.export.export(module, tuple(example_args))


def export_fn(fn: Callable, *example_args) -> bytes:
    """Serialize ``fn`` specialized to the example shapes → bytes."""
    buf = io.BytesIO()
    torch.export.save(export_program(fn, *example_args), buf)
    return buf.getvalue()


def load_program(blob: bytes, device=None) -> torch.export.ExportedProgram:
    """Deserialize a blob and move its weights and constants onto
    ``device`` (the card unless ``"cpu"`` is given) with
    ``move_to_device_pass``: a traced graph holds device constants that
    ``Module.to`` would not move."""
    from torch.export.passes import move_to_device_pass

    dev = resolve_device(device, "load_exported")
    return move_to_device_pass(torch.export.load(io.BytesIO(blob)), dev)


def load_exported(blob: bytes, device=None) -> Callable:
    """Deserialize an exported function onto ``device`` (the card unless
    ``"cpu"`` is given); returns a callable that takes arrays or tensors,
    moves them there and runs the program without autograd."""
    dev = resolve_device(device, "load_exported")
    module = load_program(blob, dev).module()

    @torch.no_grad()
    def call(*inputs):
        return module(*(torch.as_tensor(x, device=dev) for x in inputs))

    return call


def export_descriptor_model(model: torch.nn.Module, *example_inputs
                            ) -> bytes:
    """Export a DescriptorModel's eval-mode forward (weights inside the
    program) at the example inputs' shapes, on their device. Export the
    model in the ``compute_dtype`` it serves in; the inputs stay fp32."""
    was_training = model.training
    model.eval()
    try:
        return export_fn(model, *example_inputs)
    finally:
        model.train(was_training)


class ExportedDescriptorModel:
    """Model-shaped adapter over a serialized descriptor blob.

    Called like a DescriptorModel (``model(points, mask)`` or
    ``model(images)``) it runs the deserialized program, so a
    GlobalLocalizer serves queries with no model-building code and no
    parameters (``params=None``): the reference's TorchScript → C++
    hand-off without the second language. Wire it up with ``query
    --from-export BLOB``.

    Only the plain forward is supported: the program is specialized to the
    export-time batch shape (B=1 query extraction; ``add_keyframes``
    through it is not supported), and keyword paths (the host-stats
    ``voxel_stats``) need the real model.
    """

    # GlobalLocalizer checks this before taking the host-stats path
    supports_voxel_stats = False

    def __init__(self, blob: bytes, device=None):
        self._blob = blob
        self.device = resolve_device(device, "ExportedDescriptorModel")
        self._call = load_exported(blob, self.device)

    def to(self, device) -> "ExportedDescriptorModel":
        """The adapter on ``device``: itself, or the blob reloaded there."""
        device = torch.device(device)
        if device == self.device or (device.type == self.device.type
                                     and device.index is None):
            return self
        return ExportedDescriptorModel(self._blob, device)

    def eval(self) -> "ExportedDescriptorModel":
        return self

    def __call__(self, *inputs, **kwargs):
        if kwargs:
            raise ValueError(
                "exported models support only the plain forward (got "
                f"kwargs {sorted(kwargs)}); host_stats/voxel_stats paths "
                "need the real model")
        return self._call(*inputs)
