"""Contour-blob virtual point clouds from BEV probability images.

Port of ``gloc3d_tpu/ops/contour.py``: threshold → 3×3 erosion → 8-connected
components → keep the components whose area lies in (min_area, S²/4) →
every kept pixel centre becomes a metric point. Connected components are
min-label propagation: each occupied pixel starts with its own flat index,
and each sweep min-pools the labels over the 3×3 neighbourhood and then
hops every label to its labelee's label twice (pointer jumping), so a blob
of diameter D converges in O(log D) sweeps.

The min-pools run in float32, as ``-max_pool2d(-x)``: labels are below
S² + 1 ≤ 2²⁴ (checked), so float32 holds every label exactly, on any
device. JAX's ``while_loop`` stops on a device flag; here the host reads the
"changed" flag once every ``SWEEPS_PER_READ`` sweeps. A sweep of converged
labels returns them unchanged, so the extra sweeps of the last group change
nothing, and the labels equal JAX's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from gloc3d_tpu_torch.ops.refine import select_pixels

Tensor = torch.Tensor
SWEEPS_PER_READ = 4


def _min_pool3x3(x: Tensor, pad: bool) -> Tensor:
    """3×3 min over a float (H, W) map; with ``pad`` the border reads +inf
    (the output keeps H × W), else the map must come padded."""
    return -F.max_pool2d(-x[None, None], 3, stride=1,
                         padding=1 if pad else 0)[0, 0]


def erode3x3(binary: Tensor) -> Tensor:
    """3×3 binary erosion with a square element; outside the image reads as
    0, so border pixels erode."""
    return _min_pool3x3(F.pad(binary.to(torch.float32), (1, 1, 1, 1)),
                        pad=False)


def connected_components(occupied: Tensor, num_sweeps: Optional[int] = None
                         ) -> Tensor:
    """8-connected component labels of an (H, W) 0/1 map: (H, W) int32, the
    background H·W, every foreground pixel its component's smallest flat
    index. Sweeps run until nothing changes, or ``num_sweeps`` of them
    (default H·W, past any convergence)."""
    h, w = occupied.shape
    if h * w >= 1 << 24:
        raise ValueError(f"{h}x{w} labels exceed float32's exact integers")
    dev = occupied.device
    fg = occupied > 0.5
    bg = float(h * w)
    idx = torch.arange(h * w, dtype=torch.float32, device=dev).reshape(h, w)
    labels = torch.where(fg, idx, bg)
    cap = num_sweeps if num_sweeps is not None else h * w
    bg_row = torch.tensor([bg], device=dev)

    def jump(lab):
        # follow each label to ITS label (a background row appended)
        flat = torch.cat([lab.reshape(-1), bg_row])
        hopped = flat[lab.reshape(-1).long()].reshape(h, w)
        return torch.where(fg, torch.minimum(lab, hopped), bg)

    done = 0
    while done < cap:
        prev = labels
        for _ in range(min(SWEEPS_PER_READ, cap - done)):
            new = torch.where(fg, torch.minimum(
                labels, _min_pool3x3(labels, pad=True)), bg)
            labels = jump(jump(new))
        done += min(SWEEPS_PER_READ, cap - done)
        if not bool((labels != prev).any()):
            break
    return labels.to(torch.int32)


def component_areas(labels: Tensor) -> Tensor:
    """Pixel count per label (flat length H·W + 1; H·W is the background),
    int32."""
    h, w = labels.shape
    flat = labels.reshape(-1).long()
    return torch.zeros(h * w + 1, dtype=torch.int32,
                       device=labels.device).index_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))


def contour_virtual_cloud(
    image: Tensor,             # (S, S) BEV prob image, free = 1.0
    origin_xy: Tensor,         # (2,) metric coordinate of pixel (0, 0)
    resolution,
    budget: int,
    min_area: int = 100,
    occupied_below: float = 0.5,
    num_sweeps: Optional[int] = None,
    perm: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Virtual metric cloud of the area-filtered occupied blobs: the pixels
    of eroded components with min_area < area < S²/4, taken as
    ``ops/refine.py::bev_to_virtual_points`` takes pixels (the first
    ``budget`` behind ``perm``). Returns ((budget, 2) points, (budget,)
    validity)."""
    s = image.shape[-1]
    occ = erode3x3(image < occupied_below)
    labels = connected_components(occ, num_sweeps)
    pix_area = component_areas(labels)[labels.long()]
    keep = (occ > 0.5) & (pix_area > min_area) & (pix_area < s * s // 4)
    return select_pixels(keep, origin_xy, resolution, budget, perm)
