"""The s2s located query: scan → descriptor → top-k → registration → pose.

Port of ``gloc3d_tpu/pipeline.py::GlobalLocalizer`` on the host-stats
serving path. The shared native loader (``data/native.py``) computes pillar
statistics, the counting sort, the per-point rows and the BEV image on the
host; the device runs the descriptor forward (kernel K1 inside), the bank
search and the FFT registration. BEV keyframe images live on the host as
uint8 (the ``host_mirror`` layout) and the candidate stack is uploaded per
query. ``locate`` registers the top candidate alone first and falls back to
all top-k only when it fails (``staged_first``, first success wins).

Options that other slices port raise ``NotImplementedError`` naming their
ROADMAP item: on-device binning (``host_stats=False``), ``align_ground``,
``device_keyframes`` / ``locate_fused``, ``device_sort``, the IVF and int8
banks, and ``refine_icp``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from gloc3d_tpu_torch._shared import native
from gloc3d_tpu_torch.core.transforms import Rigid3
from gloc3d_tpu_torch.eval.registration import compose_6dof
from gloc3d_tpu_torch.index.bank import DescriptorBank
from gloc3d_tpu_torch.ops.bev import BEVImage
from gloc3d_tpu_torch.ops.bev_match import MatchResult, match_bev_topk


class Keyframe(NamedTuple):
    image: np.ndarray      # (S, S) uint8 BEV occupancy image
    origin_xy: np.ndarray  # (2,) metric origin of pixel (0, 0)


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


class GlobalLocalizer:
    """Build-once query-many localization engine (s2s, host stats).

    Args:
      cfg: a PipelineConfig (the port's or the JAX package's).
      model: a DescriptorModel (models/descriptor.py).
      params: optional state_dict to load into ``model``.
      device: where the model, the bank and the matcher run (default: the
        model's device).
    """

    def __init__(self, cfg, model, params=None, *, host_stats: bool = True,
                 device: Optional[torch.device] = None,
                 align_ground: bool = False, device_keyframes: bool = False,
                 host_mirror: bool = True, device_sort: bool = False):
        if not host_stats:
            raise _not_ported("host_stats=False (on-device binning, K2)",
                              "item 10")
        if align_ground:
            raise _not_ported("align_ground", "item 10")
        if device_keyframes or not host_mirror:
            raise _not_ported("device_keyframes / host_mirror=False",
                              "item 9")
        if device_sort:
            raise _not_ported("device_sort", "item 10")
        if cfg.model.encoder != "pointpillar":
            raise _not_ported(f"encoder {cfg.model.encoder!r}", "item 12")
        if cfg.index.backend != "flat":
            raise _not_ported("the IVF bank", "item 13")
        if cfg.match.refine_icp:
            raise _not_ported("match.refine_icp", "item 14")
        self.cfg = cfg
        if params is not None:
            model.load_state_dict(params)
        if device is None:
            device = next(model.parameters()).device
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.bank = DescriptorBank(cfg.index, dim=cfg.index.dim,
                                   device=self.device)
        self.keyframes: List[Keyframe] = []

    # ------------------------------------------------------------ extraction
    @torch.no_grad()
    def extract(self, inputs: np.ndarray, mask: np.ndarray):
        """Batched extraction: padded clouds (B, N, ≥3) + mask (B, N) →
        (descriptors (B, D) on the device, host BEVImage batch, None)."""
        vc = self.cfg.voxel
        counts = np.asarray(np.asarray(mask).sum(axis=1), np.int64)
        pts = np.asarray(inputs, np.float32)
        if pts.shape[-1] < 4:  # the host pass expects xyzi rows
            pad = np.zeros(pts.shape[:-1] + (4 - pts.shape[-1],), np.float32)
            pts = np.concatenate([pts, pad], axis=-1)
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
        return desc, bev, None

    # ------------------------------------------------------------ db build
    def add_keyframes(self, points: np.ndarray, mask: np.ndarray) -> None:
        """Extract and store a batch of database keyframes."""
        desc, bev, _ = self.extract(points, mask)
        self.bank.add(desc)
        imgs = (bev.image * 255.0).astype(np.uint8)
        for i in range(imgs.shape[0]):
            self.keyframes.append(Keyframe(imgs[i], bev.origin_xy[i]))

    # ------------------------------------------------------------ query
    def detect(self, points: np.ndarray, mask: np.ndarray):
        """Top-k place candidates for a batch of query scans."""
        desc, bev, ground = self.extract(points, mask)
        d2, idx = self.bank.query(desc, k=self.cfg.index.top_k)
        return d2, idx, bev, ground

    @torch.no_grad()
    def _match(self, q_image: np.ndarray, q_origin: np.ndarray,
               rows: np.ndarray) -> MatchResult:
        """Register the query against keyframes ``rows`` on the device."""
        stack = torch.from_numpy(np.stack(
            [self.keyframes[i].image for i in rows])).to(self.device)
        origins = torch.from_numpy(np.stack(
            [self.keyframes[i].origin_xy for i in rows])).to(self.device)
        query = BEVImage(
            image=torch.from_numpy(q_image).to(self.device),
            origin_xy=torch.from_numpy(q_origin).to(self.device),
            resolution=self.cfg.bev.resolution,
            num_occupied=None)
        return match_bev_topk(query, stack.float() / 255.0, origins,
                              self.cfg.match,
                              resolution=self.cfg.bev.resolution)

    def _empty_result(self) -> LocalizationResult:
        k = self.cfg.index.top_k
        return LocalizationResult(False, -1, None, np.full(k, -1),
                                  np.full(k, np.inf), 0.0, None)

    def locate(self, points: np.ndarray, mask: np.ndarray
               ) -> LocalizationResult:
        """Full pipeline for ONE query scan (N, ≥3) with mask (N,)."""
        if not self.keyframes:
            return self._empty_result()
        d2, idx, bev, _ = self.detect(points[None], mask[None])
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
        xy_yaw = res.xy_yaw[k_star].cpu()
        pose = compose_6dof(xy_yaw)
        return LocalizationResult(
            True, int(idx0[k_star]),
            Rigid3(pose.rotation.numpy(), pose.translation.numpy()),
            idx0, d2[0], float(scores[k_star]), xy_yaw.numpy())
