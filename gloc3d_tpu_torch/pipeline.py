"""The located query: scan or BEV image → descriptor → top-k →
registration → pose.

Port of ``gloc3d_tpu/pipeline.py::GlobalLocalizer``. The model is s2s
(PointPillar on clouds) or i2i (an image encoder, VGG16 by default, on BEV
images). An i2i localizer takes scans, which it projects to BEV images on
the device (``ops/bev.py``) and repeats to 3 channels, or ``(B, S, S, 3)``
BEV probability images straight from disk (free = 1.0) with their origins;
channel 0 of an image is its registration BEV. The switches:

- ``host_stats=False`` (the default, as in the JAX package): the
  all-device extraction. The BEV image (``ops/bev.py::batch_scan_to_bev``)
  and both pillar binnings (kernel K2) run on the device. It is the only
  extraction of an i2i model: ``host_stats`` is dropped for one, as the
  host pass feeds PointPillar alone.
- ``host_stats=True``: the port's native host pass (``data/native.py``)
  computes pillar statistics, the counting sort, the per-point rows and the
  BEV image on the host, and the descriptor forward runs on the sorted rows
  (kernel K1 inside).
- ``align_ground=True``: each scan is first gravity-aligned on the device
  (``ops/ground.py::estimate_ground``, one estimate per scan). With host
  stats the aligned floats go back to the host pass; ``locate`` composes
  roll, pitch and dz from the two ground frames with (dx, dy, yaw) from the
  2-D match, or takes the non-aligned composition when the matched keyframe
  has no ground frame (a mixed-mode map).
- ``device_keyframes=True``: the keyframes' BEV occupancy also lives on the
  device, bit-packed (``(capacity, S, S/8)`` uint8, 72 KB per keyframe at
  768²), and registration gathers its candidates from there by index.
  ``host_mirror=False`` keeps no image on the host at all (``save``
  rebuilds them from the device store).

The device runs the descriptor forward, the bank search and the FFT
registration. Without the device store the keyframe images live on the host
as uint8 and the candidate stack is uploaded per query. ``locate``
registers the top candidate alone first and falls back to all top-k only
when it fails (``staged_first``, first success wins). ``locate_batch`` runs
extraction and search once for a batch of scans; ``locate_fused`` keeps the
search results on the device and reads the host only for the staged
branch. The ground estimator's random draws come from a CPU
``torch.Generator`` seeded by ``seed``, so the same calls draw the same
numbers on every device.

The bank is the flat ``DescriptorBank`` (fp32, or int8 with
``IndexConfig(quantize="int8")``) or, with ``IndexConfig(backend="ivf")``,
the IVF index (``index/ivf.py``, fp32 or int8 cells) behind
``_IVFBankAdapter``; every entry point searches either.

With ``match.refine_icp`` each keyframe also keeps a downsampled scan cloud
(``refine_icp_points`` points, in the BEV frame: the ground frame on an
aligned map), and ``locate``, ``locate_batch`` and ``match_keyframe``
polish an accepted match with 3-D point-to-point ICP (``ops/refine.py``)
seeded by its (dx, dy, yaw), projected back to (dx, dy, yaw).
``match_keyframe`` registers a query against one chosen keyframe, the SLAM
loop's verify step.

Sharding the IVF bank raises ``NotImplementedError`` naming its ROADMAP
item (16). ``device_sort`` is a TPU-only strategy that the port leaves
out, and so are the JAX package's ``row_gather`` and the bucket padding of
``locate_batch``, which only bound XLA shapes.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gloc3d_tpu_torch.core.device import resolve_device
from gloc3d_tpu_torch.core.transforms import (
    Rigid3, quat_from_rpy, quat_to_matrix, transform_points,
)
from gloc3d_tpu_torch.data import native
from gloc3d_tpu_torch.eval.registration import compose_6dof
from gloc3d_tpu_torch.index.bank import DescriptorBank
from gloc3d_tpu_torch.index.ivf import IVFBank
from gloc3d_tpu_torch.models.encoders import is_image_encoder
from gloc3d_tpu_torch.ops.bev import BEVImage, batch_scan_to_bev
from gloc3d_tpu_torch.ops.bev_match import MatchResult, match_bev_topk
from gloc3d_tpu_torch.ops.ground import GroundEstimate, estimate_ground
from gloc3d_tpu_torch.ops.refine import icp_point_to_point


class Keyframe(NamedTuple):
    image: Optional[np.ndarray]      # (S, S) uint8 BEV image (x255);
                                     # None with host_mirror=False
    origin_xy: Optional[np.ndarray]  # (2,) metric origin of pixel (0, 0);
                                     # None when ingested without a mirror
    ground: Optional[Rigid3] = None  # T_lidar→ground (numpy), None if the
                                     # keyframe was ingested unaligned
    cloud: Optional[np.ndarray] = None  # (P, 4) downsampled scan in the BEV
                                        # frame, xyz + validity column
                                        # (kept with match.refine_icp)


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


class _IVFBankAdapter:
    """DescriptorBank-shaped facade over the IVF index (map-scale maps).

    The coarse quantizer needs the descriptors before it can partition, so
    adds are buffered on the host, and the index trains and ingests them on
    the first query after a change (build once, query many). The training
    sample is JAX's: ``RandomState(0).permutation`` of the buffered rows,
    cut to ``ivf_train_sample``; k-means draws from the port's generator
    seeded with 0, so the port's cells differ from JAX's for the same rows
    (maps saved by either package load in the other)."""

    def __init__(self, cfg, dim: int, device: torch.device):
        self.cfg = cfg
        self.dim = dim
        self._ivf = IVFBank(dim=dim, num_cells=cfg.ivf_num_cells,
                            cell_capacity=cfg.ivf_cell_capacity,
                            nprobe=cfg.ivf_nprobe, quantize=cfg.quantize,
                            device=device)
        self._pending: List[np.ndarray] = []
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def add(self, feats) -> None:
        feats = np.atleast_2d(np.asarray(_numpy(feats), np.float32))
        self._pending.append(feats)
        self._size += len(feats)

    def truncate(self, n: int) -> None:
        """Drop rows beyond n; only rows not yet ingested can go."""
        if n < self._size - sum(len(p) for p in self._pending):
            raise ValueError("IVF backend cannot truncate ingested rows")
        drop = self._size - n
        while drop > 0 and self._pending:
            tail = self._pending[-1]
            if len(tail) <= drop:
                drop -= len(tail)
                self._pending.pop()
            else:
                self._pending[-1] = tail[:-drop]
                drop = 0
        self._size = n

    def _flush(self) -> None:
        if not self._pending:
            return
        batch = np.concatenate(self._pending)
        self._pending = []
        if self._ivf.centroids is None:
            sample = batch[np.random.RandomState(0).permutation(len(batch))[
                : self.cfg.ivf_train_sample]]
            self._ivf.train(sample, torch.Generator().manual_seed(0))
        self._ivf.add(batch)

    def _limit(self, exclude_recent: bool) -> Optional[int]:
        # ids are insertion order: the SLAM window hides the newest rows
        return (self._size - self.cfg.num_exclude_recent if exclude_recent
                else None)

    def query_device(self, queries, k: Optional[int] = None,
                     exclude_recent: bool = False):
        self._flush()
        return self._ivf.query_device(queries, k or self.cfg.top_k,
                                      exclude_after=self._limit(
                                          exclude_recent))

    def query(self, queries, k: Optional[int] = None,
              exclude_recent: bool = False):
        self._flush()
        return self._ivf.query(queries, k or self.cfg.top_k,
                               exclude_after=self._limit(exclude_recent))

    def shard(self, mesh) -> None:
        raise _not_ported("sharding the IVF bank", "item 16")

    def save(self, path: str) -> None:
        self._flush()
        self._ivf.save(path)

    @classmethod
    def load(cls, path: str, cfg, device: torch.device
             ) -> "_IVFBankAdapter":
        adapter = cls.__new__(cls)
        adapter.cfg = cfg
        adapter._ivf = IVFBank.load(path, device=device)
        adapter.dim = adapter._ivf.dim
        adapter._pending = []
        adapter._size = len(adapter._ivf)
        return adapter


def _xyzi(points) -> np.ndarray:
    """(B, N, ≥3) scans → (B, N, 4) float32 xyzi rows: the PointNet takes
    14 features, so a 3-column scan gets a zero intensity column."""
    pts = np.asarray(points, np.float32)
    if pts.shape[-1] < 4:
        pad = np.zeros(pts.shape[:-1] + (4 - pts.shape[-1],), np.float32)
        pts = np.concatenate([pts, pad], axis=-1)
    return pts


def _pack_bits(images: torch.Tensor) -> torch.Tensor:
    """(B, S, S) BEV images (free = 1.0) → (B, S, S//8) uint8 occupancy
    bitmaps: a bit is set where the pixel is occupied (< 0.5, the matcher's
    own threshold, so the packing loses nothing the matcher reads), little-
    endian within each byte, as the JAX package packs them."""
    occ = (images < 0.5).to(torch.uint8)
    b, s, _ = occ.shape
    w = torch.tensor([1 << i for i in range(8)], dtype=torch.uint8,
                     device=images.device)
    return (occ.reshape(b, s, s // 8, 8) * w).sum(-1).to(torch.uint8)


def _unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """(K, S, S//8) uint8 bitmaps → (K, S, S) float BEV images (occupied =
    0.0, free = 1.0)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    k, s, sb, _ = bits.shape
    return 1.0 - bits.reshape(k, s, sb * 8).float()


def _one(points, mask, origin):
    """One query (and its mask or origin) as a batch of one."""
    return (points[None], None if mask is None else mask[None],
            None if origin is None else np.asarray(origin)[None])


def _stack(results: List[MatchResult]) -> MatchResult:
    """Per-query MatchResults (K lanes each) → one with a leading query
    axis."""
    return MatchResult(*(torch.stack(x) for x in zip(*results)))


def _splice_staged(res1: MatchResult, res2: MatchResult,
                   failed: np.ndarray, b: int, k: int) -> MatchResult:
    """The (b, k) MatchResult of a staged batch on the host: the stage-1
    top-candidate lanes (res1: (b, 1)) and, for the queries in ``failed``,
    the stage-2 lanes over all k candidates (res2: (len(failed), k)).
    The other queries' untested lanes read zeros (success False), which
    first-success-wins never consults."""

    def leaf(l1, l2):
        l1, l2 = _numpy(l1), _numpy(l2)
        out = np.zeros((b, k) + l1.shape[2:], l1.dtype)
        out[:, :1] = l1
        out[failed] = l2[: len(failed)]
        return out

    return MatchResult(*(leaf(a, c) for a, c in zip(res1, res2)))


class GlobalLocalizer:
    """Build-once query-many localization engine (s2s or i2i).

    Args:
      cfg: a PipelineConfig (the port's or the JAX package's).
      model: a DescriptorModel (models/descriptor.py).
      params: optional state_dict to load into ``model``.
      host_stats: bin and draw the BEV on the host, or on the device
        (default); ignored for an image encoder.
      device: where the model, the bank and the matcher run (default:
        ``cuda``; without a card, pass ``device="cpu"``).
      align_ground: gravity-align scans before BEV / descriptor extraction.
      seed: seed of the ground estimator's draws.
      device_keyframes: keep the keyframes' BEV occupancy on the device,
        bit-packed, and gather registration candidates from there.
      host_mirror: also keep each keyframe's image and origin on the host
        (default); False needs ``device_keyframes``.
    """

    def __init__(self, cfg, model, params=None, *, host_stats: bool = False,
                 device: Optional[torch.device] = None,
                 align_ground: bool = False, seed: int = 0,
                 device_keyframes: bool = False, host_mirror: bool = True,
                 device_sort: bool = False):
        if not host_mirror and not device_keyframes:
            raise ValueError("host_mirror=False requires device_keyframes")
        if device_sort:
            raise NotImplementedError(
                "device_sort is a TPU-only binning strategy the port leaves "
                "out (ROADMAP ground rule: port semantics, not TPU "
                "workarounds); host_stats=False bins on the device")
        self.cfg = cfg
        self.i2i = is_image_encoder(cfg.model.encoder)
        self.host_stats = host_stats and not self.i2i
        self.align_ground = align_ground
        self.device_keyframes = device_keyframes
        self.host_mirror = host_mirror
        if params is not None:
            model.load_state_dict(params)
        self.device = resolve_device(device, "GlobalLocalizer")
        self.model = model.to(self.device).eval()
        if cfg.index.backend == "ivf":
            self.bank = _IVFBankAdapter(cfg.index, cfg.index.dim,
                                        self.device)
        else:
            self.bank = DescriptorBank(cfg.index, dim=cfg.index.dim,
                                       device=self.device)
        self.keyframes: List[Keyframe] = []
        self._kf_store: Optional[torch.Tensor] = None    # (cap, S, S//8) u8
        self._kf_origins: Optional[torch.Tensor] = None  # (cap, 2) fp32
        self._kf_cap = 0
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

    def _default_origins(self, n: int) -> np.ndarray:
        """Scan-centred origins for images given without theirs."""
        half = self.cfg.bev.image_size / 2.0 * self.cfg.bev.resolution
        return np.full((n, 2), -half, np.float32)

    def _extract_images(self, images, origins):
        """i2i on BEV probability images (B, S, S, 3), free = 1.0: the
        descriptor, and channel 0 as the registration BEV."""
        if origins is None:
            origins = self._default_origins(len(images))
        images = torch.as_tensor(np.asarray(images, np.float32),
                                 device=self.device)
        img2d = images[..., 0]
        bev = BEVImage(
            image=img2d,
            origin_xy=torch.as_tensor(np.asarray(origins, np.float32),
                                      device=self.device),
            resolution=np.float32(self.cfg.bev.resolution),
            num_occupied=(img2d < 0.5).sum(dim=(1, 2)).int())
        return self.model(images), bev, None

    @torch.no_grad()
    def extract(self, inputs: np.ndarray, mask: Optional[np.ndarray] = None,
                origins: Optional[np.ndarray] = None):
        """Batched extraction → (descriptors (B, D) on the device, BEVImage
        batch, ground estimates or None). Inputs are padded clouds
        (B, N, ≥3) with mask (B, N), or, for an image encoder, BEV
        probability images (B, S, S, 3) with ``origins`` (B, 2), each
        image's pixel-(0, 0) metric coordinate (scan-centred by default).
        The BEV batch is numpy with host stats and on the device
        without."""
        if np.ndim(inputs) == 4:
            if not self.i2i:
                raise ValueError("BEV image inputs need an image encoder; "
                                 f"this model's is {self.cfg.model.encoder!r}")
            return self._extract_images(inputs, origins)
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
            if self.i2i:  # the BEV, repeated to 3 channels, is the input
                desc = self.model(bev.image[..., None].repeat(1, 1, 1, 3))
            else:
                desc = self.model(pts_d, mask_d)
            return desc, bev, ground
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
    def add_keyframes(self, points: np.ndarray,
                      mask: Optional[np.ndarray] = None,
                      origins: Optional[np.ndarray] = None) -> None:
        """Extract and store a batch of database keyframes: scans with
        their masks, or BEV images with their origins."""
        desc, bev, ground = self.extract(points, mask, origins)
        self.bank.add(desc)
        if self.device_keyframes:
            self._store_keyframes(bev.image, bev.origin_xy,
                                  offset=len(self.keyframes))
        n_new = len(bev.origin_xy)
        imgs = origins = None
        if self.host_mirror:
            imgs = (_numpy(bev.image) * 255.0).astype(np.uint8)
            origins = _numpy(bev.origin_xy)
        if ground is not None:
            rot = _numpy(ground.transform.rotation)
            trans = _numpy(ground.transform.translation)
        clouds = self._query_clouds(points, mask, ground)
        for i in range(n_new):
            self.keyframes.append(Keyframe(
                imgs[i] if imgs is not None else None,
                origins[i] if origins is not None else None,
                Rigid3(rot[i], trans[i]) if ground is not None else None,
                None if clouds is None else np.concatenate(
                    [clouds[0][i], clouds[1][i][:, None]], 1)))

    def _ensure_kf_capacity(self, n_needed: int, s: int) -> None:
        """Room for ``n_needed`` rows in the device store: 1024 rows at
        first, doubling."""
        if self._kf_store is None:
            cap = 1024
            while cap < n_needed:
                cap *= 2
            self._kf_store = torch.zeros((cap, s, s // 8), dtype=torch.uint8,
                                         device=self.device)
            self._kf_origins = torch.zeros((cap, 2), dtype=torch.float32,
                                           device=self.device)
            self._kf_cap = cap
        while self._kf_cap < n_needed:
            self._kf_cap *= 2
            for name in ("_kf_store", "_kf_origins"):
                old = getattr(self, name)
                grown = old.new_zeros((self._kf_cap,) + old.shape[1:])
                grown[: old.shape[0]] = old
                setattr(self, name, grown)

    def _store_keyframes(self, images, origins, offset: int) -> None:
        """Write a batch of BEV images (B, S, S), bit-packed, and their
        origins into the device store at row ``offset``."""
        images = torch.as_tensor(images, dtype=torch.float32,
                                 device=self.device)
        n = images.shape[0]
        self._ensure_kf_capacity(offset + n, images.shape[-1])
        self._kf_store[offset : offset + n] = _pack_bits(images)
        self._kf_origins[offset : offset + n] = torch.as_tensor(
            origins, dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------ ICP polish
    def _downsample_cloud(self, points: np.ndarray, mask: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Uniform-stride subsample of the valid points to the ICP budget."""
        budget = self.cfg.match.refine_icp_points
        pts = np.asarray(points)[..., :3]
        valid_idx = np.nonzero(np.asarray(mask) > 0)[0]
        take = valid_idx[
            np.linspace(0, len(valid_idx) - 1,
                        min(budget, max(len(valid_idx), 1))).astype(int)
        ] if len(valid_idx) else np.zeros(0, int)
        out = np.zeros((budget, 3), np.float32)
        out[: len(take)] = pts[take]
        v = np.zeros(budget, np.float32)
        v[: len(take)] = 1.0
        return out, v

    def _query_clouds(self, points, masks, ground):
        """Downsampled clouds of a batch of scans for the ICP polish, in the
        BEV frame (moved into the ground frame on an aligned map, in float64
        as ``_align`` moves the scans): ((B, P, 3), (B, P)) numpy, or None
        when refinement is off or the inputs are images or have no mask."""
        if (not self.cfg.match.refine_icp or masks is None
                or np.ndim(points) != 3):
            return None
        clouds, valids = [], []
        for q in range(len(points)):
            xyz, v = self._downsample_cloud(points[q], masks[q])
            if self.align_ground and ground is not None:
                t64 = Rigid3(ground.transform.rotation[q].double().cpu(),
                             ground.transform.translation[q].double().cpu())
                xyz = transform_points(
                    t64, torch.from_numpy(xyz).double()).float().numpy()
            clouds.append(xyz)
            valids.append(v)
        return np.stack(clouds), np.stack(valids)

    @torch.no_grad()
    def _refine_icp(self, q_cloud, q_valid, db_cloud, db_valid,
                    xy_yaw) -> np.ndarray:
        """3-D ICP polish of an accepted match on the device: the query's
        cloud onto the keyframe's, both in their BEV frames, seeded with
        (dx, dy, yaw); the refined transform projected back to
        (dx, dy, atan2(r10, r00))."""
        m = self.cfg.match

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device)

        xy_yaw = dev(xy_yaw)
        z = torch.zeros((), device=self.device)
        init = Rigid3(quat_from_rpy(z, z, xy_yaw[2]),
                      torch.stack([xy_yaw[0], xy_yaw[1], z]))
        res = icp_point_to_point(
            dev(q_cloud), dev(q_valid), dev(db_cloud), dev(db_valid), init,
            iterations=m.refine_icp_iters,
            max_corr_dist=m.refine_icp_max_corr)
        r = quat_to_matrix(res.transform.rotation)
        return _numpy(torch.stack([
            res.transform.translation[0], res.transform.translation[1],
            torch.atan2(r[1, 0], r[0, 0])]))

    def _maybe_refine(self, q_cloud, q_valid, db_idx: int, xy_yaw):
        """``xy_yaw`` polished against keyframe ``db_idx``'s cloud, or as it
        is when refinement is off or either side has no cloud."""
        if not self.cfg.match.refine_icp or q_cloud is None:
            return xy_yaw
        kf = self.keyframes[db_idx]
        if kf.cloud is None:
            return xy_yaw
        return self._refine_icp(q_cloud, q_valid, kf.cloud[:, :3],
                                kf.cloud[:, 3], xy_yaw)

    # ------------------------------------------------------------ query
    def detect(self, points: np.ndarray, mask: Optional[np.ndarray] = None,
               origins: Optional[np.ndarray] = None):
        """Top-k place candidates for a batch of query scans or images."""
        desc, bev, ground = self.extract(points, mask, origins)
        d2, idx = self.bank.query(desc, k=self.cfg.index.top_k)
        return d2, idx, bev, ground

    def _candidates(self, rows):
        """Keyframes ``rows`` (numpy or a device tensor of indices) as a
        float image stack (K, S, S) and origins (K, 2) on the device: one
        gather of packed rows from the device store, or the host mirror's
        images uploaded."""
        if self._kf_store is not None:
            rows = torch.as_tensor(rows, dtype=torch.long,
                                   device=self.device)
            return (_unpack_bits(self._kf_store.index_select(0, rows)),
                    self._kf_origins.index_select(0, rows))
        stack = torch.from_numpy(np.stack(
            [self.keyframes[i].image for i in rows])).to(self.device)
        origins = torch.from_numpy(np.stack(
            [self.keyframes[i].origin_xy for i in rows])).to(self.device)
        return stack.float() / 255.0, origins

    @torch.no_grad()
    def _match(self, q_image, q_origin, rows) -> MatchResult:
        """Register the query against keyframes ``rows`` on the device."""
        images, origins = self._candidates(rows)
        query = BEVImage(
            image=torch.as_tensor(q_image, device=self.device),
            origin_xy=torch.as_tensor(q_origin, device=self.device),
            resolution=self.cfg.bev.resolution,
            num_occupied=None)
        return match_bev_topk(query, images, origins, self.cfg.match,
                              resolution=self.cfg.bev.resolution)

    def _staged(self, q_image, q_origin, rows) -> MatchResult:
        """First success wins: the top candidate usually succeeds, so with
        ``staged_first`` register it alone (reading its success on the
        host) and fall back to all of ``rows`` only when it fails."""
        if self.cfg.match.staged_first:
            res1 = self._match(q_image, q_origin, rows[:1])
            if bool(res1.success[0]):
                return res1
        return self._match(q_image, q_origin, rows)

    def _empty_result(self) -> LocalizationResult:
        k = self.cfg.index.top_k
        return LocalizationResult(False, -1, None, np.full(k, -1),
                                  np.full(k, np.inf), 0.0, None)

    def _db_ground(self, db_idx: int) -> Optional[Rigid3]:
        """The db keyframe's ground transform, or None when it was ingested
        without one: ``compose_6dof`` then takes the non-aligned branch."""
        return self.keyframes[db_idx].ground

    def _result(self, res: MatchResult, idx0: np.ndarray, d2: np.ndarray,
                ground, q: int = 0, clouds=None) -> LocalizationResult:
        """Query ``q``'s LocalizationResult from its registration lanes
        (candidate order ``idx0``): the first success wins, polished with
        ICP against its keyframe when ``clouds`` (``_query_clouds``) holds
        the query's."""
        succ = _numpy(res.success)
        scores = _numpy(res.score)
        if not succ.any():
            return LocalizationResult(False, -1, None, idx0, d2,
                                      float(scores.max()), None)
        k_star = int(np.argmax(succ))
        db_idx = int(idx0[k_star])
        xy_yaw = _numpy(res.xy_yaw)[k_star]
        if clouds is not None:
            xy_yaw = self._maybe_refine(clouds[0][q], clouds[1][q], db_idx,
                                        xy_yaw)
        xy_yaw = torch.as_tensor(xy_yaw)
        t_q = t_db = None
        if self.align_ground and ground is not None:
            t_q = Rigid3(ground.transform.rotation[q],
                         ground.transform.translation[q])
            t_db = self._db_ground(db_idx)
        pose = compose_6dof(xy_yaw, t_q, t_db)
        return LocalizationResult(
            True, db_idx,
            Rigid3(pose.rotation.numpy(), pose.translation.numpy()),
            idx0, d2, float(scores[k_star]), xy_yaw.numpy())

    def locate(self, points: np.ndarray, mask: Optional[np.ndarray] = None,
               origin: Optional[np.ndarray] = None) -> LocalizationResult:
        """Full pipeline for ONE query: a scan (N, ≥3) with mask (N,), or a
        BEV image (S, S, 3) with its origin (2,)."""
        if not self.keyframes:
            return self._empty_result()
        d2, idx, bev, ground = self.detect(*_one(points, mask, origin))
        # a db smaller than top_k returns inf-distance filler candidates:
        # clamp them to a real keyframe (their inf distance ranks them last)
        idx0 = np.clip(idx[0], 0, len(self.keyframes) - 1)
        res = self._staged(bev.image[0], bev.origin_xy[0], idx0)
        return self._result(res, idx0, d2[0], ground, clouds=(
            self._query_clouds(*_one(points, mask, None)[:2], ground)))

    def locate_batch(self, points: np.ndarray,
                     masks: Optional[np.ndarray] = None,
                     origins: Optional[np.ndarray] = None
                     ) -> List[LocalizationResult]:
        """Localize B query scans (B, N, ≥3) with masks (B, N), or B BEV
        images (B, S, S, 3) with origins (B, 2): extraction and the bank
        search run once for the batch. With ``staged_first``,
        stage 1 registers every query's top candidate and stage 2 all top-k
        candidates of the queries that failed stage 1, spliced back by
        lane. Each result equals ``locate``'s on the same scan."""
        if not self.keyframes:
            return [self._empty_result() for _ in range(len(points))]
        d2, idx, bev, ground = self.detect(points, masks, origins)
        b, k = idx.shape
        idx = np.clip(idx, 0, len(self.keyframes) - 1)

        def match(q, rows):
            return self._match(bev.image[q], bev.origin_xy[q], rows)

        if self.cfg.match.staged_first:
            res = _stack([match(q, idx[q, :1]) for q in range(b)])
            failed = np.flatnonzero(~_numpy(res.success)[:, 0])
            if failed.size:
                res = _splice_staged(
                    res, _stack([match(q, idx[q]) for q in failed]),
                    failed, b, k)
        else:
            res = _stack([match(q, idx[q]) for q in range(b)])
        clouds = self._query_clouds(points, masks, ground)
        return [self._result(MatchResult(*(x[q] for x in res)), idx[q],
                             d2[q], ground, q, clouds) for q in range(b)]

    def locate_fused(self, points: np.ndarray,
                     mask: Optional[np.ndarray] = None,
                     origin: Optional[np.ndarray] = None
                     ) -> LocalizationResult:
        """``locate`` for ONE query, a scan or a BEV image (S, S, 3), with
        the search results kept on the device: the top-k ids are clamped
        there and the candidates gathered from the device keyframe store by
        them, so the host reads only the staged branch's success and the
        final lanes. Host stats, all-device, aligned and image extraction
        as the localizer is built; the search runs on the flat bank (fp32
        or int8) or the IVF index, whose device copy of the cells is
        uploaded once per change of the map. Results equal ``locate``'s.
        Needs ``device_keyframes=True`` and a built store;
        ``match.refine_icp`` is not supported."""
        if not self.keyframes:
            return self._empty_result()
        if self._kf_store is None:
            raise RuntimeError("locate_fused requires device_keyframes=True"
                               " and a built store")
        if self.cfg.match.refine_icp:
            raise RuntimeError("locate_fused does not compose with "
                               "match.refine_icp (use locate)")
        desc, bev, ground = self.extract(*_one(points, mask, origin))
        d2, idx = self.bank.query_device(desc, k=self.cfg.index.top_k)
        rows = idx[0].clamp(0, max(len(self.bank) - 1, 0))
        res = self._staged(bev.image[0], bev.origin_xy[0], rows)
        idx0 = np.clip(_numpy(idx[0]).astype(np.int32), 0,
                       len(self.keyframes) - 1)
        return self._result(res, idx0, _numpy(d2[0]), ground)

    # ------------------------------------------------------------ persistence
    def save(self, out_dir: str) -> None:
        """Write the built map to ``out_dir``, in the JAX package's format:
        ``bank.npz``, ``keyframes.npz`` (``images`` uint8 0/255,
        ``origins``, ``ground_q`` / ``ground_t`` when any keyframe has a
        ground frame, and ``clouds`` when every keyframe has an ICP cloud)
        and ``config.json``. With ``host_mirror=False`` the images are
        rebuilt from the device store, 256 rows at a time."""
        os.makedirs(out_dir, exist_ok=True)
        self.bank.save(os.path.join(out_dir, "bank.npz"))
        n = len(self.keyframes)
        if self.host_mirror:
            images = np.stack([k.image for k in self.keyframes])
            origins = np.stack([k.origin_xy for k in self.keyframes])
        else:
            s = self._kf_store.shape[1]
            images = np.empty((n, s, s), np.uint8)
            for i in range(0, n, 256):
                chunk = _unpack_bits(self._kf_store[i : min(i + 256, n)])
                images[i : i + 256] = _numpy((chunk * 255.0).to(torch.uint8))
            origins = _numpy(self._kf_origins[:n])
        kw = dict(images=images, origins=origins)
        if any(k.ground is not None for k in self.keyframes):
            kw["ground_q"] = np.stack([k.ground.rotation
                                       for k in self.keyframes])
            kw["ground_t"] = np.stack([k.ground.translation
                                       for k in self.keyframes])
        if all(k.cloud is not None for k in self.keyframes):
            kw["clouds"] = np.stack([k.cloud for k in self.keyframes])
        np.savez(os.path.join(out_dir, "keyframes.npz"), **kw)
        with open(os.path.join(out_dir, "config.json"), "w") as f:
            f.write(self.cfg.to_json())

    def load(self, out_dir: str) -> None:
        """Restore a map written by ``save`` (of either package) into this
        localizer: the bank, the keyframes (with their ICP clouds where
        the map has them) and, with ``device_keyframes``, the device store
        (repacked 256 rows at a time)."""
        path = os.path.join(out_dir, "bank.npz")
        if self.cfg.index.backend == "ivf":
            self.bank = _IVFBankAdapter.load(path, self.cfg.index,
                                             self.device)
        else:
            self.bank = DescriptorBank.load(path, device=self.device)
        kf = np.load(os.path.join(out_dir, "keyframes.npz"))
        images, origins = kf["images"], kf["origins"]
        has_ground = "ground_q" in kf
        clouds = kf["clouds"] if "clouds" in kf else None
        self.keyframes = [
            Keyframe(images[i] if self.host_mirror else None, origins[i],
                     Rigid3(kf["ground_q"][i], kf["ground_t"][i])
                     if has_ground else None,
                     None if clouds is None else clouds[i])
            for i in range(len(images))]
        if self.device_keyframes:
            for i in range(0, len(images), 256):
                self._store_keyframes(
                    images[i : i + 256].astype(np.float32) / 255.0,
                    origins[i : i + 256], offset=i)

    def match_keyframe(self, points: Optional[np.ndarray] = None,
                       mask: Optional[np.ndarray] = None,
                       origin: Optional[np.ndarray] = None,
                       db_index: int = 0, *, bev=None,
                       ground=None) -> LocalizationResult:
        """Register ONE query, a scan (N, ≥3) with mask (N,) or a BEV image
        (S, S, 3) with its origin, against the CHOSEN keyframe ``db_index``:
        the SLAM loop's verify step after ``bank.detect_loop`` names a
        candidate. The matcher, the ICP polish and the 6-DoF composition
        are ``locate``'s, without the bank search; the result's candidates
        are ``[db_index]`` with a nan distance. ``bev`` / ``ground`` from an
        earlier ``extract`` of the same query skip a second extraction; the
        polish needs the scan itself (``points`` and ``mask``)."""
        if not 0 <= db_index < len(self.keyframes):
            raise IndexError(
                f"db_index {db_index} outside [0, {len(self.keyframes)})")
        if bev is None:
            if points is None:
                raise ValueError("match_keyframe needs points or bev=")
            _, bev, ground = self.extract(*_one(points, mask, origin))
        cand = np.array([db_index])
        res = self._match(bev.image[0], bev.origin_xy[0], cand)
        clouds = (self._query_clouds(*_one(points, mask, None)[:2], ground)
                  if points is not None else None)
        return self._result(res, cand, np.array([np.nan]), ground,
                            clouds=clouds)
