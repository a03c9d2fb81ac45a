"""Scan → BEV probability image, on the device.

Port of ``gloc3d_tpu/ops/bev.py``: ``BEVImage``, ``scan_to_bev`` and
``batch_scan_to_bev``. A single sweep of the reference's occupancy insertion
reduces to integer binning: every return's cell ``round(p / res)`` (half
away from zero), one contribution per distinct occupied cell (dedupe by
sort), a pixel occupied iff ≥ 2 distinct cells project into its column
(0.55 each, threshold 0.9), and the image centre-cropped or padded to S×S.
The math is integer after the first rounding, so the result is bit-identical
to the JAX function and to the host pass (``data/native.py::
compute_bev_host``) on the same float inputs.

``batch_scan_to_bev`` bins a whole batch at once; ``scan_to_bev`` is its
one-scan view. With ``align_rotation`` the cell centres are rotated by that
rotation with its yaw removed before projection (the JAX function's second
branch); the serving path aligns the cloud before projection instead and
passes none.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from gloc3d_tpu_torch.core.transforms import quat_rotate, remove_yaw

Tensor = torch.Tensor


class BEVImage(NamedTuple):
    """image (S, S) float32, free = 1.0 and occupied = 0.0, rows = y and
    cols = x; origin_xy (2,) metric coordinate of pixel (0, 0); resolution
    in metres per pixel; num_occupied pixel count. Batched along a leading
    axis where a function says so."""

    image: Any
    origin_xy: Any
    resolution: Any
    num_occupied: Any


def _round_int(x: Tensor) -> Tensor:
    """std::lround semantics: round half away from zero."""
    return torch.where(x >= 0, torch.floor(x + 0.5),
                       torch.ceil(x - 0.5)).to(torch.int32)


def batch_scan_to_bev(points: Tensor, mask: Tensor, cfg,
                      align_rotation: Optional[Tensor] = None) -> BEVImage:
    """(B, N, 3) padded scans + (B, N) mask → batched BEVImage on the
    points' device: image (B, S, S), origin_xy (B, 2), num_occupied (B,).
    ``align_rotation``: optional (B, 4) wxyz quaternions."""
    res = cfg.resolution
    s = cfg.image_size
    b, n, _ = points.shape
    dev = points.device
    norm = torch.sqrt(points[..., 0] * points[..., 0]
                      + points[..., 1] * points[..., 1]
                      + points[..., 2] * points[..., 2])
    valid = (mask > 0) & (norm <= cfg.max_range)

    cell = _round_int(points / res)                    # (B, N, 3)
    half_xy = int(cfg.max_range / res) + 2
    nxy = 2 * half_xy
    z_lo = int(cfg.z_min / res)
    nz = int((cfg.z_max - cfg.z_min) / res) + 2
    if nxy * nxy * nz >= 2 ** 31 - 1:
        raise ValueError(
            f"voxel hash space {nxy}x{nxy}x{nz} overflows int32; shrink "
            "max_range/z extent or raise resolution")
    cx = torch.clamp(cell[..., 0] + half_xy, 0, nxy - 1)
    cy = torch.clamp(cell[..., 1] + half_xy, 0, nxy - 1)
    cz = torch.clamp(cell[..., 2] - z_lo, 0, nz - 1)
    in_z = (cell[..., 2] >= z_lo) & (cell[..., 2] - z_lo < nz)
    valid = valid & in_z
    sentinel = torch.iinfo(torch.int32).max
    vid = (cx * nxy + cy) * nz + cz
    vid = torch.where(valid, vid, sentinel)

    # --- dedupe: one contribution per occupied grid cell ---
    if align_rotation is None:
        # pix == cell exactly without a rotation, so the sorted hash decodes
        # to the projected index (valid rows are never clipped)
        vid_sorted = torch.sort(vid, dim=-1).values
        rem = (vid_sorted // nz).long()
        pix_x = rem // nxy - half_xy
        pix_y = rem % nxy - half_xy
    else:
        vid_sorted, order = torch.sort(vid, dim=-1, stable=True)
        cell_sorted = torch.gather(cell, 1, order[..., None].expand(-1, -1, 3))
        center = cell_sorted.to(points.dtype) * res      # cell centres
        q = remove_yaw(align_rotation)
        center = quat_rotate(q[:, None, :], center)
        pix = _round_int(center / res).long()
        pix_x, pix_y = pix[..., 0], pix[..., 1]
    first = torch.ones_like(vid_sorted, dtype=torch.bool)
    first[:, 1:] = vid_sorted[:, 1:] != vid_sorted[:, :-1]
    occ = first & (vid_sorted != sentinel)

    big = 2 ** 30
    min_x = torch.where(occ, pix_x, big).amin(-1)
    min_y = torch.where(occ, pix_y, big).amin(-1)
    max_x = torch.where(occ, pix_x, -big).amax(-1)
    max_y = torch.where(occ, pix_y, -big).amax(-1)

    # --- centre crop/pad to s×s ---
    def _shift(w):
        return torch.where(w <= s, (s - w) // 2, -((w - s) // 2))

    off_x = _shift(max_x - min_x + 1) - min_x          # dst_col = pix_x + off
    off_y = _shift(max_y - min_y + 1) - min_y
    col = pix_x + off_x[:, None]
    row = pix_y + off_y[:, None]
    in_img = occ & (col >= 0) & (col < s) & (row >= 0) & (row < s)
    flat = torch.where(in_img, row * s + col, s * s)   # overflow bucket s*s
    flat = flat + torch.arange(b, device=dev)[:, None] * (s * s + 1)
    counts = torch.zeros(b * (s * s + 1), dtype=torch.float32, device=dev)
    counts.index_add_(0, flat.reshape(-1), in_img.reshape(-1).float())
    counts = counts.reshape(b, s * s + 1)[:, : s * s]
    occupied = counts * cfg.hit_probability > cfg.max_probability
    image = torch.where(occupied.reshape(b, s, s), cfg.occupied_value,
                        cfg.free_value).float()

    # an empty scan pins its origin to 0 (validity is num_occupied)
    any_occ = occ.any(-1)
    origin_xy = torch.where(
        any_occ[:, None],
        torch.stack([-off_x, -off_y], -1).float() * res, 0.0)
    return BEVImage(image=image, origin_xy=origin_xy,
                    resolution=torch.tensor(res, dtype=torch.float32),
                    num_occupied=occupied.sum(-1).to(torch.int32))


def scan_to_bev(points: Tensor, mask: Tensor, cfg,
                align_rotation: Optional[Tensor] = None) -> BEVImage:
    """One scan (N, 3) + mask (N,) → BEVImage; ``align_rotation`` (4,)."""
    out = batch_scan_to_bev(
        points[None], mask[None], cfg,
        None if align_rotation is None else align_rotation[None])
    return BEVImage(out.image[0], out.origin_xy[0], out.resolution,
                    out.num_occupied[0])
