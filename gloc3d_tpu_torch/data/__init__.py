"""Datasets, readers and the native host pass (port of
``gloc3d_tpu/data``); the names load on first use."""

from gloc3d_tpu_torch._lazy import lazy_exports

_EXPORTS = {"TripletDataset": "dataset"}
__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
