"""The descriptor models and losses (port of ``gloc3d_tpu/models``); the
names load on first use."""

from gloc3d_tpu_torch._lazy import lazy_exports

_EXPORTS = {"NetVLAD": "netvlad", "GatingContext": "netvlad",
            "init_netvlad_params": "netvlad", "PointPillar": "pointpillar",
            "PointNet": "pointpillar", "PillarBlock": "pointpillar",
            "VGG16Encoder": "vgg", "DescriptorModel": "descriptor",
            "build_model": "descriptor", "losses": "losses"}
__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
