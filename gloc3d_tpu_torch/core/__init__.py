"""SE(2) / SE(3) geometry (port of ``gloc3d_tpu/core``); the names load on
first use."""

from gloc3d_tpu_torch._lazy import lazy_exports

_EXPORTS = {name: "transforms" for name in (
    "Rigid2", "Rigid3", "angle_axis_to_quat", "get_angle", "get_yaw",
    "quat_conj", "quat_from_rpy", "quat_from_two_vectors", "quat_identity",
    "quat_mul", "quat_normalize", "quat_rotate", "quat_to_angle_axis",
    "quat_to_matrix", "matrix_to_quat", "remove_yaw", "rpy_from_quat",
    "project_2d", "embed_3d", "transform_points")}
__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
