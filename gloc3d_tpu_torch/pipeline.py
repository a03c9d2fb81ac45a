"""The s2s located query: scan → descriptor → top-k → registration → pose.

Port of ``gloc3d_tpu/pipeline.py::GlobalLocalizer`` for point-cloud scans,
with its two switches:

- ``host_stats=True`` (the port's default; the JAX default is False): the
  port's native host pass (``data/native.py``) computes pillar statistics, the
  counting sort, the per-point rows and the BEV image on the host, and the
  descriptor forward runs on the sorted rows (kernel K1 inside).
- ``host_stats=False``: the all-device extraction. The BEV image
  (``ops/bev.py::batch_scan_to_bev``) and both pillar binnings (kernel K2)
  run on the device.
- ``align_ground=True``: each scan is first gravity-aligned on the device
  (``ops/ground.py::estimate_ground``, one estimate per scan). With host
  stats the aligned floats go back to the host pass; ``locate`` composes
  roll, pitch and dz from the two ground frames with (dx, dy, yaw) from the
  2-D match, or takes the non-aligned composition when the matched keyframe
  has no ground frame (a mixed-mode map).

The device runs the descriptor forward, the bank search and the FFT
registration. BEV keyframe images live on the host as uint8 (the
``host_mirror`` layout) and the candidate stack is uploaded per query.
``locate`` registers the top candidate alone first and falls back to all
top-k only when it fails (``staged_first``, first success wins). The ground
estimator's random draws come from a CPU ``torch.Generator`` seeded by
``seed``, so the same calls draw the same numbers on every device.

Options that other slices port raise ``NotImplementedError`` naming their
ROADMAP item: ``device_keyframes`` / ``host_mirror=False``, the IVF bank,
``refine_icp`` and the image encoders. ``device_sort`` is a TPU-only
strategy that the port leaves out.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from gloc3d_tpu_torch.core.device import resolve_device
from gloc3d_tpu_torch.core.transforms import Rigid3, transform_points
from gloc3d_tpu_torch.data import native
from gloc3d_tpu_torch.eval.registration import compose_6dof
from gloc3d_tpu_torch.index.bank import DescriptorBank
from gloc3d_tpu_torch.ops.bev import BEVImage, batch_scan_to_bev
from gloc3d_tpu_torch.ops.bev_match import MatchResult, match_bev_topk
from gloc3d_tpu_torch.ops.ground import GroundEstimate, estimate_ground


class Keyframe(NamedTuple):
    image: np.ndarray      # (S, S) uint8 BEV occupancy image
    origin_xy: np.ndarray  # (2,) metric origin of pixel (0, 0)
    ground: Optional[Rigid3] = None  # T_lidar→ground (numpy), None if the
                                     # keyframe was ingested unaligned


class LocalizationResult(NamedTuple):
    success: bool
    db_index: int
    pose: Optional[Rigid3]        # query pose in the db keyframe's frame
    candidates: np.ndarray        # (k,) ranked candidate indices
    candidate_dists: np.ndarray   # (k,) descriptor distances²
    match_score: float
    match_xy_yaw: Optional[np.ndarray]


def _not_ported(option: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{option} is not ported yet (ROADMAP Queue 1, {item})")


def _numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _xyzi(points) -> np.ndarray:
    """(B, N, ≥3) scans → (B, N, 4) float32 xyzi rows: the PointNet takes
    14 features, so a 3-column scan gets a zero intensity column."""
    pts = np.asarray(points, np.float32)
    if pts.shape[-1] < 4:
        pad = np.zeros(pts.shape[:-1] + (4 - pts.shape[-1],), np.float32)
        pts = np.concatenate([pts, pad], axis=-1)
    return pts


class GlobalLocalizer:
    """Build-once query-many localization engine (s2s).

    Args:
      cfg: a PipelineConfig (the port's or the JAX package's).
      model: a DescriptorModel (models/descriptor.py).
      params: optional state_dict to load into ``model``.
      host_stats: bin and draw the BEV on the host (default) or on the
        device.
      device: where the model, the bank and the matcher run (default:
        ``cuda``; without a card, pass ``device="cpu"``).
      align_ground: gravity-align scans before BEV / descriptor extraction.
      seed: seed of the ground estimator's draws.
    """

    def __init__(self, cfg, model, params=None, *, host_stats: bool = True,
                 device: Optional[torch.device] = None,
                 align_ground: bool = False, seed: int = 0,
                 device_keyframes: bool = False, host_mirror: bool = True,
                 device_sort: bool = False):
        if device_keyframes or not host_mirror:
            raise _not_ported("device_keyframes / host_mirror=False",
                              "item 9")
        if device_sort:
            raise NotImplementedError(
                "device_sort is a TPU-only binning strategy the port leaves "
                "out (ROADMAP ground rule: port semantics, not TPU "
                "workarounds); host_stats=False bins on the device")
        if cfg.model.encoder != "pointpillar":
            raise _not_ported(f"encoder {cfg.model.encoder!r}", "item 12")
        if cfg.index.backend != "flat":
            raise _not_ported("the IVF bank", "item 13")
        if cfg.match.refine_icp:
            raise _not_ported("match.refine_icp", "item 14")
        self.cfg = cfg
        self.host_stats = host_stats
        self.align_ground = align_ground
        if params is not None:
            model.load_state_dict(params)
        self.device = resolve_device(device, "GlobalLocalizer")
        self.model = model.to(self.device).eval()
        self.bank = DescriptorBank(cfg.index, dim=cfg.index.dim,
                                   device=self.device)
        self.keyframes: List[Keyframe] = []
        self._gen = torch.Generator().manual_seed(seed)

    # ------------------------------------------------------------ extraction
    def _align(self, points: torch.Tensor, mask: torch.Tensor):
        """Per scan: estimate the ground plane and rotate the cloud into the
        gravity-aligned frame, keeping the intensity column. The rotation
        runs in float64 and rounds to fp32, so the card and the CPU give
        the same aligned floats from the same transform. Returns (aligned
        points, GroundEstimate with a leading batch axis)."""
        rows, ests = [], []
        for i in range(points.shape[0]):
            est = estimate_ground(points[i, :, :3], mask[i], self.cfg.ground,
                                  self._gen)
            t64 = Rigid3(est.transform.rotation.double(),
                         est.transform.translation.double())
            xyz = transform_points(t64, points[i, :, :3].double()).float()
            rows.append(torch.cat([xyz, points[i, :, 3:]], dim=-1))
            ests.append(est)
        ground = GroundEstimate(
            Rigid3(torch.stack([e.transform.rotation for e in ests]),
                   torch.stack([e.transform.translation for e in ests])),
            torch.stack([e.plane for e in ests]),
            torch.stack([e.valid for e in ests]),
            torch.stack([e.inlier_fraction for e in ests]))
        return torch.stack(rows), ground

    @torch.no_grad()
    def extract(self, inputs: np.ndarray, mask: np.ndarray):
        """Batched extraction: padded clouds (B, N, ≥3) + mask (B, N) →
        (descriptors (B, D) on the device, BEVImage batch, ground estimates
        or None). The BEV batch is numpy with host stats and on the device
        without."""
        pts = _xyzi(inputs)
        ground = None
        if self.align_ground or not self.host_stats:
            pts_d = torch.from_numpy(pts).to(self.device)
            mask_d = torch.from_numpy(
                np.asarray(mask, np.float32)).to(self.device)
        if self.align_ground:
            pts_d, ground = self._align(pts_d, mask_d)
        if not self.host_stats:
            bev = batch_scan_to_bev(pts_d[..., :3], mask_d, self.cfg.bev)
            return self.model(pts_d, mask_d), bev, ground
        if ground is not None:  # the host pass bins the aligned floats
            pts = pts_d.cpu().numpy()

        vc = self.cfg.voxel
        counts = np.asarray(np.asarray(mask).sum(axis=1), np.int64)
        s_p, s_v, s_i, s_c, s_g, s_s, s_pp = (
            native.compute_voxel_stats_host_sorted(
                pts, counts, vc.xbound, vc.ybound, vc.zbound, crop=False,
                per_point=True))
        # BEV from the ORIGINAL row order (sorted rows are not prefix-padded)
        imgs, origins, nocc = native.compute_bev_host(pts, counts,
                                                      self.cfg.bev)

        def dev(a):
            return torch.from_numpy(a).to(self.device, non_blocking=True)

        desc = self.model(dev(s_p), dev(s_v), voxel_stats=(
            dev(s_i), dev(s_c), dev(s_g), dev(s_s), dev(s_pp)))
        bev = BEVImage(image=imgs, origin_xy=origins,
                       resolution=np.float32(self.cfg.bev.resolution),
                       num_occupied=nocc)
        return desc, bev, ground

    # ------------------------------------------------------------ db build
    def add_keyframes(self, points: np.ndarray, mask: np.ndarray) -> None:
        """Extract and store a batch of database keyframes."""
        desc, bev, ground = self.extract(points, mask)
        self.bank.add(desc)
        imgs = (_numpy(bev.image) * 255.0).astype(np.uint8)
        origins = _numpy(bev.origin_xy)
        for i in range(imgs.shape[0]):
            g = None
            if ground is not None:
                g = Rigid3(_numpy(ground.transform.rotation[i]),
                           _numpy(ground.transform.translation[i]))
            self.keyframes.append(Keyframe(imgs[i], origins[i], g))

    # ------------------------------------------------------------ query
    def detect(self, points: np.ndarray, mask: np.ndarray):
        """Top-k place candidates for a batch of query scans."""
        desc, bev, ground = self.extract(points, mask)
        d2, idx = self.bank.query(desc, k=self.cfg.index.top_k)
        return d2, idx, bev, ground

    @torch.no_grad()
    def _match(self, q_image, q_origin, rows: np.ndarray) -> MatchResult:
        """Register the query against keyframes ``rows`` on the device."""
        stack = torch.from_numpy(np.stack(
            [self.keyframes[i].image for i in rows])).to(self.device)
        origins = torch.from_numpy(np.stack(
            [self.keyframes[i].origin_xy for i in rows])).to(self.device)
        query = BEVImage(
            image=torch.as_tensor(q_image, device=self.device),
            origin_xy=torch.as_tensor(q_origin, device=self.device),
            resolution=self.cfg.bev.resolution,
            num_occupied=None)
        return match_bev_topk(query, stack.float() / 255.0, origins,
                              self.cfg.match,
                              resolution=self.cfg.bev.resolution)

    def _empty_result(self) -> LocalizationResult:
        k = self.cfg.index.top_k
        return LocalizationResult(False, -1, None, np.full(k, -1),
                                  np.full(k, np.inf), 0.0, None)

    def _db_ground(self, db_idx: int) -> Optional[Rigid3]:
        """The db keyframe's ground transform, or None when it was ingested
        without one: ``compose_6dof`` then takes the non-aligned branch."""
        return self.keyframes[db_idx].ground

    def locate(self, points: np.ndarray, mask: np.ndarray
               ) -> LocalizationResult:
        """Full pipeline for ONE query scan (N, ≥3) with mask (N,)."""
        if not self.keyframes:
            return self._empty_result()
        d2, idx, bev, ground = self.detect(points[None], mask[None])
        # a db smaller than top_k returns inf-distance filler candidates:
        # clamp them to a real keyframe (their inf distance ranks them last)
        idx0 = np.clip(idx[0], 0, len(self.keyframes) - 1)
        q_image, q_origin = bev.image[0], bev.origin_xy[0]
        res = None
        if self.cfg.match.staged_first:
            # first success wins: the top candidate usually succeeds, so
            # register it alone and fall back to all top-k only on failure
            res1 = self._match(q_image, q_origin, idx0[:1])
            if bool(res1.success[0]):
                res = res1
        if res is None:
            res = self._match(q_image, q_origin, idx0)
        succ = res.success.cpu().numpy()
        scores = res.score.cpu().numpy()
        if not succ.any():
            return LocalizationResult(False, -1, None, idx0, d2[0],
                                      float(scores.max()), None)
        k_star = int(np.argmax(succ))  # first success in candidate order
        db_idx = int(idx0[k_star])
        xy_yaw = res.xy_yaw[k_star].cpu()
        t_q = t_db = None
        if self.align_ground and ground is not None:
            t_q = Rigid3(ground.transform.rotation[0],
                         ground.transform.translation[0])
            t_db = self._db_ground(db_idx)
        pose = compose_6dof(xy_yaw, t_q, t_db)
        return LocalizationResult(
            True, db_idx,
            Rigid3(pose.rotation.numpy(), pose.translation.numpy()),
            idx0, d2[0], float(scores[k_star]), xy_yaw.numpy())
