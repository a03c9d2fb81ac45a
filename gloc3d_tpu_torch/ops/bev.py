"""BEV image container.

Port of ``gloc3d_tpu/ops/bev.py::BEVImage``. On the host-stats path the BEV
images come from the shared host pass (``data/native.py::
compute_bev_host``, bit-identical to the JAX ``scan_to_bev``); the
on-device ``scan_to_bev`` comes with the aligned slice (ROADMAP Queue 1,
item 10).
"""

from __future__ import annotations

from typing import Any, NamedTuple


class BEVImage(NamedTuple):
    """image (S, S) float32, free = 1.0 and occupied = 0.0, rows = y and
    cols = x; origin_xy (2,) metric coordinate of pixel (0, 0); resolution
    in metres per pixel; num_occupied pixel count. Batched along a leading
    axis where a function says so."""

    image: Any
    origin_xy: Any
    resolution: Any
    num_occupied: Any
