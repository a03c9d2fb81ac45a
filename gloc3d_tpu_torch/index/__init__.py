"""The descriptor banks and k-means (port of ``gloc3d_tpu/index``); the
names load on first use."""

from gloc3d_tpu_torch._lazy import lazy_exports

_EXPORTS = {"DescriptorBank": "bank", "kmeans": "kmeans", "IVFBank": "ivf"}
__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
