"""Scan → BEV occupancy image, plain PyTorch.

A single sweep of the reference's occupancy insertion reduces to integer
binning: each return's cell ``round(p / res)`` (half away from zero), one
contribution per distinct occupied cell, a pixel occupied where at least
two distinct cells project into its column (hit probability 0.55 each,
threshold 0.9), and the image centre-cropped or padded to S × S. Free
pixels are 1.0, occupied 0.0; the origin is the metric coordinate of pixel
(0, 0).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _round_int(x: Tensor) -> Tensor:
    return torch.where(x >= 0, torch.floor(x + 0.5),
                       torch.ceil(x - 0.5)).to(torch.int32)


def scan_to_bev(points: Tensor, mask: Tensor, bcfg: dict):
    """(B, N, 3) scans, (B, N) masks → (images (B, S, S), origins (B, 2))."""
    res, s = bcfg["resolution"], bcfg["image_size"]
    b = points.shape[0]
    dev = points.device
    norm = torch.sqrt(points[..., 0] * points[..., 0]
                      + points[..., 1] * points[..., 1]
                      + points[..., 2] * points[..., 2])
    valid = (mask > 0) & (norm <= bcfg["max_range"])
    cell = _round_int(points / res)
    half = int(bcfg["max_range"] / res) + 2
    nxy = 2 * half
    z_lo = int(bcfg["z_min"] / res)
    nz = int((bcfg["z_max"] - bcfg["z_min"]) / res) + 2
    cx = torch.clamp(cell[..., 0] + half, 0, nxy - 1)
    cy = torch.clamp(cell[..., 1] + half, 0, nxy - 1)
    cz = torch.clamp(cell[..., 2] - z_lo, 0, nz - 1)
    valid = valid & (cell[..., 2] >= z_lo) & (cell[..., 2] - z_lo < nz)
    sentinel = torch.iinfo(torch.int32).max
    vid = torch.where(valid, (cx * nxy + cy) * nz + cz, sentinel)
    vid = torch.sort(vid, dim=-1).values
    rem = (vid // nz).long()
    px, py = rem // nxy - half, rem % nxy - half
    first = torch.ones_like(vid, dtype=torch.bool)
    first[:, 1:] = vid[:, 1:] != vid[:, :-1]
    occ = first & (vid != sentinel)

    big = 2 ** 30
    min_x = torch.where(occ, px, big).amin(-1)
    min_y = torch.where(occ, py, big).amin(-1)
    max_x = torch.where(occ, px, -big).amax(-1)
    max_y = torch.where(occ, py, -big).amax(-1)

    def shift(w):
        return torch.where(w <= s, (s - w) // 2, -((w - s) // 2))

    off_x = shift(max_x - min_x + 1) - min_x
    off_y = shift(max_y - min_y + 1) - min_y
    col, row = px + off_x[:, None], py + off_y[:, None]
    inside = occ & (col >= 0) & (col < s) & (row >= 0) & (row < s)
    flat = torch.where(inside, row * s + col, s * s)
    flat = flat + torch.arange(b, device=dev)[:, None] * (s * s + 1)
    counts = torch.zeros(b * (s * s + 1), dtype=torch.float32, device=dev)
    counts.index_add_(0, flat.reshape(-1), inside.reshape(-1).float())
    counts = counts.reshape(b, s * s + 1)[:, : s * s]
    occupied = counts * bcfg["hit_probability"] > bcfg["max_probability"]
    image = torch.where(occupied.reshape(b, s, s), bcfg["occupied_value"],
                        bcfg["free_value"]).float()
    origin = torch.where(occ.any(-1)[:, None],
                         torch.stack([-off_x, -off_y], -1).float() * res,
                         0.0)
    return image, origin
