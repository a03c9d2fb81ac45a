"""Multi-sweep 3-D occupancy grid (log-odds), its BEV projection, and the
2-D probability grid the correlative scan matcher searches.

Port of ``gloc3d_tpu/ops/occupancy.py``: Cartographer's HybridGrid +
probability codec + ray inserter + Submap3D (hybrid_grid.h,
probability_values.h, range_data_inserter_3d.cpp, submap_3d.cpp) for the
SLAM-submap case where many sweeps accumulate into one grid. The grid is a
dense origin-centred (X, Y, Z) fp32 log-odds tensor plus a bool ``known``;
a sweep's update is one sort and two scatters:

  hits:   cell = round(p / res), half away from zero; one update per cell
          and sweep (kUpdateMarker, probability_values.h:82);
          log_odds += logit(p_hit), clamped to [logit(.1), logit(.9)].
  misses: the last ``num_free_space_voxels`` equidistant samples of each
          origin → hit ray (range_data_inserter_3d.cpp:27-52, C++
          truncating division); a cell hit in the same sweep takes the hit
          (range_data_inserter_3d.cpp:71-74).

Every state is functional, as in JAX: ``insert_range_data``,
``Submap3D.insert`` and ``ProbabilityGrid2D.apply_odds`` return a new value
and leave the one passed in unchanged. The factories (``create``) run on
the card unless ``device="cpu"`` is passed, and raise without one; every
other function follows its inputs' device.

Where the port differs in form from JAX, and why the result does not:

- JAX drops masked lanes with distinct out-of-bounds ids and
  ``mode="drop"``; torch has no drop mode. Every masked lane goes to one
  trailing slack cell, cut off after the scatter (JAX's own ``apply_odds``
  does the same). A boolean compaction would read the count back to the
  host and change nothing in the result.
- The updates reach distinct cells, so they are written with
  ``index_put_`` (a gather, an add, a store): each real cell gets exactly
  one fp32 add on every device, and the card's log-odds are bit-equal to
  the CPU's. ``known`` is bool, which ``scatter_reduce`` refuses; its max
  with ``True`` is a store of ``True``.
- On the card torch divides by a Python float as a multiplication by its
  reciprocal, which can move a point that lies within an ulp of a cell
  boundary into the next cell. Every ``x / res`` here divides by a 0-dim
  tensor instead (``_fdiv``), an IEEE division on every device.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from gloc3d_tpu_torch.config import BEVConfig
from gloc3d_tpu_torch.core.device import resolve_device
from gloc3d_tpu_torch.core.transforms import quat_rotate, remove_yaw
from gloc3d_tpu_torch.ops.bev import _round_int

Tensor = torch.Tensor


def logit(p: float) -> float:
    return math.log(p / (1.0 - p))


_CLAMP = (logit(0.1), logit(0.9))


def _fdiv(x: Tensor, d: float) -> Tensor:
    """``x / d`` rounded as IEEE division on every device (see the module
    docstring); ``torch.full`` fills on the device, with no host copy."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


class OccupancyGrid3D(NamedTuple):
    """Dense origin-centred voxel grid. Cell (i, j, k) covers the centre
    ((i, j, k) − half) · res."""

    log_odds: Tensor            # (X, Y, Z) float32; 0 == unknown
    known: Tensor               # (X, Y, Z) bool, ever updated
    resolution: float
    half: Tuple[int, int, int]  # index of the origin cell

    @staticmethod
    def create(resolution: float, extent_xy: float, z_min: float,
               z_max: float, device=None) -> "OccupancyGrid3D":
        dev = resolve_device(device, "OccupancyGrid3D.create")
        hx = int(round(extent_xy / resolution))
        nz = int(round((z_max - z_min) / resolution))
        hz = int(round(-z_min / resolution))
        shape = (2 * hx, 2 * hx, nz)
        return OccupancyGrid3D(
            log_odds=torch.zeros(shape, dtype=torch.float32, device=dev),
            known=torch.zeros(shape, dtype=torch.bool, device=dev),
            resolution=resolution,
            half=(hx, hx, hz),
        )

    def probabilities(self) -> Tensor:
        """(X, Y, Z) probabilities; unknown cells read exactly 0."""
        return torch.where(self.known, torch.sigmoid(self.log_odds), 0.0)


def _cells_of(points: Tensor, res: float) -> Tensor:
    """Cell index of metric points: round(p / res) half away from zero, in
    fp32."""
    return _round_int(_fdiv(points, res))


def _first_flags(s: Tensor) -> Tensor:
    """First occurrence of each value of the sorted ``s``."""
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    return first


def _dedupe_ids(ids: Tensor, valid: Tensor, sentinel: int
                ) -> Tuple[Tensor, Tensor]:
    """Sort ids; flag the first occurrence of each valid id."""
    s = torch.sort(torch.where(valid, ids, sentinel)).values
    return s, _first_flags(s) & (s != sentinel)


def _with_slack(x: Tensor) -> Tensor:
    """Flat copy of ``x`` with one trailing slack cell for dropped lanes."""
    return torch.cat([x.reshape(-1), x.new_zeros(1)])


def insert_range_data(
    grid: OccupancyGrid3D,
    points: Tensor,
    mask: Tensor,
    origin: Optional[Tensor] = None,
    hit_probability: float = 0.55,
    miss_probability: float = 0.49,
    max_range: float = 100.0,
    num_free_space_voxels: int = 2,
) -> OccupancyGrid3D:
    """Insert one sweep (points (N, 3), mask (N,)) into the grid.

    Returns beyond ``max_range`` contribute nothing, neither hit nor ray
    (point_cloud_to_range_data, loop_detector.cpp:107-119, and
    FilterRangeDataByMaxRange, submap_3d.cpp:43-52)."""
    res = grid.resolution
    hx, hy, hz = grid.half
    nx, ny, nz = grid.log_odds.shape
    dev = points.device
    n = points.shape[0]
    total = nx * ny * nz
    # huge grids: keys cell·2 + is_miss overflow int32, sort 64-bit
    key_dtype = torch.int32 if 2 * total < 2 ** 31 else torch.int64
    sentinel = torch.iinfo(key_dtype).max
    norm = torch.sqrt(points[:, 0] * points[:, 0] + points[:, 1] * points[:, 1]
                      + points[:, 2] * points[:, 2])
    valid = (mask > 0) & (norm <= max_range)
    if origin is None:
        origin = torch.zeros(3, dtype=points.dtype, device=dev)

    def cell_ids(cells: Tensor) -> Tuple[Tensor, Tensor]:
        cells = cells.to(key_dtype)
        ix, iy, iz = cells[:, 0] + hx, cells[:, 1] + hy, cells[:, 2] + hz
        inb = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
               & (iz >= 0) & (iz < nz))
        return (ix * ny + iy) * nz + iz, inb

    hit_cells = _cells_of(points, res)
    hit_flat, hit_inb = cell_ids(hit_cells)
    origin_cell = _cells_of(origin[None, :], res)[0]
    delta = hit_cells - origin_cell[None, :]                  # (N, 3)
    num_samples = delta.abs().amax(-1)                        # (N,)
    ids, oks = [hit_flat], [valid & hit_inb]
    for k in range(1, num_free_space_voxels + 1):
        pos = num_samples - k                                 # may be < 0
        # C++ integer division truncates toward zero
        q = torch.div(delta * pos[:, None],
                      num_samples.clamp(min=1)[:, None],
                      rounding_mode="trunc")
        flat, inb = cell_ids(origin_cell[None, :] + q)
        ids.append(flat)
        oks.append((pos >= 0) & valid & hit_inb & inb)

    # Key = cell·2 + is_miss: one sort groups the lanes by cell with the
    # hit lane first, so the first lane of each cell both dedupes the
    # sweep and gives hits priority over same-sweep misses.
    is_miss = torch.ones(n * (num_free_space_voxels + 1), dtype=key_dtype,
                         device=dev)
    is_miss[:n] = 0
    keys = torch.where(torch.cat(oks), torch.cat(ids) * 2 + is_miss,
                       sentinel)
    s = torch.sort(keys).values
    cell_sorted = s >> 1
    first = _first_flags(cell_sorted) & (s != sentinel)
    upd = torch.where(first, torch.where((s & 1) == 1,
                                         logit(miss_probability),
                                         logit(hit_probability)), 0.0)
    idx = torch.where(first, cell_sorted, total).long()       # slack: total

    lo = _with_slack(grid.log_odds)
    lo.index_put_((idx,), lo[idx] + upd)
    kn = _with_slack(grid.known)
    kn.index_put_((idx,), first)
    return grid._replace(
        log_odds=lo[:total].clamp_(_CLAMP[0], _CLAMP[1]).view(nx, ny, nz),
        known=kn[:total].view(nx, ny, nz),
    )


def _shift(w: Tensor, s: int) -> Tensor:
    """Offset that centres a w-wide extent in s pixels (crop or pad)."""
    return torch.where(w <= s, (s - w) // 2, -((w - s) // 2))


def project_to_bev(
    grid: OccupancyGrid3D,
    cfg: BEVConfig,
    align_rotation: Optional[Tensor] = None,
    occupied_threshold: float = 0.501,
) -> Tuple[Tensor, Tensor]:
    """The grid as the reference's BEV probability image (submap_3d.cpp:
    238-326): cells with p ≥ threshold, centres rotated by the yaw-free
    alignment, probability summed per (x, y) pixel, a pixel occupied where
    the sum exceeds ``max_probability``, centre-cropped or padded to
    ``cfg.image_size``. Returns (image (S, S) float 0/1, origin_xy (2,))."""
    res = grid.resolution
    s = cfg.image_size
    hx, hy, hz = grid.half
    nx, ny, nz = grid.log_odds.shape
    dev = grid.log_odds.device
    p = grid.probabilities()
    occ = p >= occupied_threshold
    big = 2 ** 30

    if align_rotation is None:
        # The identity maps cell (i, j, k) to pixel (i − hx, j − hy)
        # exactly, so the projection is a z-reduction and a shifted crop.
        prob_sum_xy = torch.where(occ, p, 0.0).sum(2)           # (X, Y)
        occ_xy = occ.any(2)
        any_x, any_y = occ_xy.any(1), occ_xy.any(0)
        has_occ = any_x.any()
        xs = torch.arange(nx, dtype=torch.int64, device=dev) - hx
        ys = torch.arange(ny, dtype=torch.int64, device=dev) - hy
        min_x = torch.where(has_occ, torch.where(any_x, xs, big).amin(), 0)
        max_x = torch.where(has_occ, torch.where(any_x, xs, -big).amax(), 0)
        min_y = torch.where(has_occ, torch.where(any_y, ys, big).amin(), 0)
        max_y = torch.where(has_occ, torch.where(any_y, ys, -big).amax(), 0)
        off_x = _shift(max_x - min_x + 1, s) - min_x
        off_y = _shift(max_y - min_y + 1, s) - min_y
        # image[row, col] = prob_sum_xy[col + hx − off_x, row + hy − off_y],
        # 0 outside the grid (JAX pads the grid and slices; same values)
        ar = torch.arange(s, dtype=torch.int64, device=dev)
        gx, gy = ar + hx - off_x, ar + hy - off_y
        inside = (((gx >= 0) & (gx < nx))[:, None]
                  & ((gy >= 0) & (gy < ny))[None, :])
        sub = prob_sum_xy[gx.clamp(0, nx - 1)[:, None],
                          gy.clamp(0, ny - 1)[None, :]]
        sub = torch.where(inside, sub, 0.0)
        image = torch.where(sub.T > cfg.max_probability, cfg.occupied_value,
                            cfg.free_value).to(torch.float32)
        origin_xy = torch.where(
            has_occ, torch.stack([-off_x, -off_y]).to(torch.float32) * res,
            0.0)
        return image, origin_xy

    ii, jj, kk = torch.meshgrid(
        torch.arange(nx, dtype=torch.int32, device=dev) - hx,
        torch.arange(ny, dtype=torch.int32, device=dev) - hy,
        torch.arange(nz, dtype=torch.int32, device=dev) - hz,
        indexing="ij")
    centers = torch.stack([ii, jj, kk], -1).to(torch.float32) * res
    q = remove_yaw(align_rotation)
    centers = quat_rotate(q[None, None, None, :], centers)
    pix = _cells_of(centers.reshape(-1, 3), res).long()
    occ_flat = occ.reshape(-1)
    min_x = torch.where(occ_flat, pix[:, 0], big).amin()
    min_y = torch.where(occ_flat, pix[:, 1], big).amin()
    max_x = torch.where(occ_flat, pix[:, 0], -big).amax()
    max_y = torch.where(occ_flat, pix[:, 1], -big).amax()
    off_x = _shift(max_x - min_x + 1, s) - min_x
    off_y = _shift(max_y - min_y + 1, s) - min_y
    col = pix[:, 0] + off_x
    row = pix[:, 1] + off_y
    in_img = occ_flat & (col >= 0) & (col < s) & (row >= 0) & (row < s)
    flat = torch.where(in_img, row * s + col, s * s)
    prob_sum = torch.zeros(s * s + 1, dtype=torch.float32, device=dev)
    prob_sum.index_add_(0, flat, torch.where(in_img, p.reshape(-1), 0.0))
    occupied = prob_sum[: s * s] > cfg.max_probability
    image = torch.where(occupied.reshape(s, s), cfg.occupied_value,
                        cfg.free_value).to(torch.float32)
    origin_xy = torch.where(
        occ_flat.any(),
        torch.stack([-off_x, -off_y]).to(torch.float32) * res, 0.0)
    return image, origin_xy


def grid_to_points(
    probs: Tensor, origin_xy: Tensor, resolution: float,
    threshold: float = 0.501, max_points: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    """Occupied grid cells → a virtual 2-D point cloud and its 0/1 mask
    (fast_correlative_scan_matcher_2d.cpp:78-95): every cell with
    p ≥ threshold at its metric centre, occupied cells first in row-major
    order (a stable sort on the flag), H·W rows or ``max_points``."""
    h, w = probs.shape
    dev = probs.device
    occ = (probs >= threshold).reshape(-1)
    rows = torch.arange(h, device=dev).repeat_interleave(w)
    cols = torch.arange(w, device=dev).repeat(h)
    origin_xy = torch.as_tensor(origin_xy, dtype=torch.float32, device=dev)
    pts = torch.stack(
        [origin_xy[0] + cols.to(torch.float32) * resolution,
         origin_xy[1] + rows.to(torch.float32) * resolution], dim=1)
    order = torch.sort((~occ).to(torch.uint8), stable=True).indices
    pts, mask = pts[order], occ[order]
    if max_points is not None:
        pts, mask = pts[:max_points], mask[:max_points]
    return pts, mask.to(torch.float32)


class ProbabilityGrid2D(NamedTuple):
    """Dense 2-D probability grid (grid_2d.{h,cpp}, probability_grid.
    {h,cpp}): log-odds cells, rows = y and cols = x, with the metric
    coordinate of cell (0, 0)'s centre and the resolution."""

    log_odds: Tensor   # (H, W) float32
    known: Tensor      # (H, W) bool
    origin_xy: Tensor  # (2,) float32
    resolution: float

    @staticmethod
    def create(size: int, resolution: float, origin_xy=(0.0, 0.0),
               device=None) -> "ProbabilityGrid2D":
        dev = resolve_device(device, "ProbabilityGrid2D.create")
        return ProbabilityGrid2D(
            torch.zeros((size, size), dtype=torch.float32, device=dev),
            torch.zeros((size, size), dtype=torch.bool, device=dev),
            torch.as_tensor(origin_xy, dtype=torch.float32, device=dev),
            resolution,
        )

    @staticmethod
    def from_bev_image(image: Tensor, origin_xy, resolution: float
                       ) -> "ProbabilityGrid2D":
        """Binary BEV image (free = 1, occupied = 0) → grid with p = 0.9 at
        occupied and 0.1 at free pixels, all known; on the image's device."""
        occ = image < 0.5
        lo = torch.where(occ, _CLAMP[1], _CLAMP[0]).to(torch.float32)
        return ProbabilityGrid2D(
            lo, torch.ones_like(occ),
            torch.as_tensor(origin_xy, dtype=torch.float32,
                            device=image.device),
            resolution,
        )

    def probabilities(self) -> Tensor:
        return torch.where(self.known, torch.sigmoid(self.log_odds), 0.0)

    def apply_odds(self, rows: Tensor, cols: Tensor, valid: Tensor,
                   p_update: float) -> "ProbabilityGrid2D":
        """Odds update at (rows, cols), once per cell and call
        (ApplyLookupTable, probability_grid.cpp:36-79)."""
        h, w = self.log_odds.shape
        inb = valid & (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
        flat = torch.where(inb, rows * w + cols, h * w).to(torch.int32)
        s, first = _dedupe_ids(flat, inb, torch.iinfo(torch.int32).max)
        idx = torch.where(first, s, h * w).long()
        lo = _with_slack(self.log_odds)
        lo.index_put_((idx,), lo[idx] + torch.where(first, logit(p_update),
                                                    0.0))
        kn = _with_slack(self.known)
        kn.index_put_((idx,), first)
        return self._replace(
            log_odds=lo[:-1].clamp_(_CLAMP[0], _CLAMP[1]).view(h, w),
            known=kn[:-1].view(h, w))


class Submap3D(NamedTuple):
    """Dual-resolution submap: a high-res and a low-res occupancy grid fed
    by the same sweeps (submap_3d.cpp:153-176). The high-res grid takes the
    range data filtered to ``high_resolution_max_range``
    (loop_detector.h:115: 100 m), the low-res grid the unfiltered sweep."""

    high: OccupancyGrid3D
    low: OccupancyGrid3D
    num_range_data: int

    @staticmethod
    def create(cfg: BEVConfig, extent_xy: float = 60.0, device=None
               ) -> "Submap3D":
        dev = resolve_device(device, "Submap3D.create")
        return Submap3D(
            high=OccupancyGrid3D.create(cfg.resolution, extent_xy,
                                        cfg.z_min, cfg.z_max, device=dev),
            low=OccupancyGrid3D.create(cfg.low_resolution, extent_xy,
                                       cfg.z_min, cfg.z_max, device=dev),
            num_range_data=0,
        )

    def insert(
        self, points: Tensor, mask: Tensor,
        origin: Optional[Tensor] = None,
        cfg: Optional[BEVConfig] = None,
        high_resolution_max_range: float = 100.0,
    ) -> "Submap3D":
        cfg = cfg or BEVConfig()
        common = dict(
            origin=origin,
            hit_probability=cfg.hit_probability,
            miss_probability=cfg.miss_probability,
            num_free_space_voxels=cfg.num_free_space_voxels,
        )
        return Submap3D(
            high=insert_range_data(
                self.high, points, mask,
                max_range=min(high_resolution_max_range, cfg.max_range),
                **common),
            low=insert_range_data(self.low, points, mask,
                                  max_range=cfg.max_range, **common),
            num_range_data=self.num_range_data + 1,
        )

    def project(self, cfg: BEVConfig,
                align_rotation: Optional[Tensor] = None,
                use_low_resolution: bool = False) -> Tuple[Tensor, Tensor]:
        """BEV image from either grid (the loop detector projects the
        high-res one, loop_detector.cpp:137-142)."""
        grid = self.low if use_low_resolution else self.high
        return project_to_bev(grid, cfg, align_rotation=align_rotation,
                              occupied_threshold=cfg.occupied_threshold)
