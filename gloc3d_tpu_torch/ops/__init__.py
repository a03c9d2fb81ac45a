"""The device operations (port of ``gloc3d_tpu/ops``); the names load on
first use."""

from gloc3d_tpu_torch._lazy import lazy_exports

_EXPORTS = {"points_to_voxels": "voxelize", "pad_or_trim": "voxelize",
            "scan_to_bev": "bev", "BEVImage": "bev"}
__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
