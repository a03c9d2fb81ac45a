"""The descriptor banks and k-means (port of ``gloc3d_tpu/index``); the
banks load on first use."""

from gloc3d_tpu_torch._lazy import lazy_exports

# ``kmeans`` is the function, as in JAX. Its submodule has the same name, so
# a lazy name would be the submodule once anything had imported it; bound
# here, after the submodule, the function stays (the module imports torch
# only).
from gloc3d_tpu_torch.index.kmeans import kmeans

_EXPORTS = {"DescriptorBank": "bank", "IVFBank": "ivf"}
__all__ = sorted([*_EXPORTS, "kmeans"])
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
