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
  (``ops/ground.py::estimate_ground_batch``, one call for the batch). With
  host stats the aligned floats go back to the host pass; ``locate`` composes
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
as uint8 and the candidate stacks are uploaded per batch. ``locate``
registers the top candidate alone first and falls back to all top-k only
when it fails (``staged_first``, first success wins). ``locate_batch`` runs
extraction and search once for a batch of scans, and registration once per
stage: every query's top candidate in one call, then all top-k candidates
of the queries that failed in one more (``match_bev_topk`` over B queries ×
K candidates); ``locate`` is its batch of one. ``locate_fused`` is one
device program a query, as JAX jits it (``_fused_program``; on a card a
captured CUDA graph), with the full branch of ``staged_first`` a second
program that runs only when the top candidate failed (``_fused_full``,
JAX's ``lax.cond``): the host uploads the query and fetches one packed
result, two when stage 2 ran. The ground estimator's random draws come
from a CPU ``torch.Generator`` seeded by ``seed``, so the same calls draw
the same numbers on every device.

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

``shard_bank`` spreads the bank over the ranks of a ``torch.distributed``
process group (a JAX mesh, ``parallel/sharding.py``): the flat bank's rows
(``ShardedBank``) or the IVF index's cells (``index/ivf.py::ShardedIVF``).
Every rank then runs the localizer on the same calls (SPMD); ``locate``,
``locate_batch``, ``detect``, ``add_keyframes`` and ``save`` work on a
sharded bank, ``locate_fused`` refuses one. ``shard_extraction`` splits
each extraction whose batch the group's size divides over the ranks (data
parallelism, ``parallel/data.py``): rank r extracts rows [r·B/P,
(r+1)·B/P) with no collective in the forward, and the descriptors, BEV
images and ground estimates are gathered in rank order, so every rank
returns the whole batch, as JAX returns a global array; other batches run
unsharded on every rank. An aligned extraction draws every scan's ground
samples ahead, in the sequential order (``ops/ground.py::
batch_ground_draws``), so each scan gets the unsharded call's draws and the
generator ends in its state. ``shard_keyframes`` spreads the device
keyframe store over a group's ranks: global row i lives on rank i mod P at local row i // P, so
the rows stay where they are when the capacity doubles, and each rank
holds ⌈capacity/P⌉ rows. A candidate gather is one all-reduce of the B·K
requested rows, each written by the one rank that owns it into zeros, so
registration reads the same bytes as from the unsharded store.
``shard_spatial`` runs every image extraction as the spatial partition
(``parallel/spatial.py``): each rank computes the encoder on its band of
image rows, and every rank gets the whole batch's descriptors; for images
it wins over ``shard_extraction``, as in JAX.

``device_sort=True`` (PointPillar, all-device path; off by default, as in
JAX) bins each extraction by sorting: one packed-key pillar sort and the
pillar statistics on the device (``ops/voxelize.py::
device_pillar_sort_stats``, kernel K1), then the host-stats forward on the
sorted rows (K1 again for the feature mean), in place of K2's two
binnings; ``host_stats`` wins over it. Every entry point that extracts
takes it, ``shard_extraction``'s ranks too. The bucket padding of JAX's
``locate_batch`` only bounds XLA's shapes and stays out.
"""

from __future__ import annotations

import itertools
import os
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gloc3d_tpu_torch import profiling
from gloc3d_tpu_torch.core.device import device_constant, resolve_device
from gloc3d_tpu_torch.core.transforms import (
    Rigid3, quat_from_rpy, quat_rotate, quat_to_matrix, transform_points,
)
from gloc3d_tpu_torch.data import native
from gloc3d_tpu_torch.eval.registration import compose_6dof
from gloc3d_tpu_torch.index.bank import DescriptorBank, search
from gloc3d_tpu_torch.index.ivf import IVFBank, ShardedIVF, ivf_search
from gloc3d_tpu_torch.kernels import bin_sums, segment_sum
from gloc3d_tpu_torch.models.encoders import is_image_encoder
from gloc3d_tpu_torch.ops.bev import BEVImage, batch_scan_to_bev
from gloc3d_tpu_torch.ops.bev_match import MatchResult, match_bev_topk
from gloc3d_tpu_torch.ops.ground import (
    GroundEstimate, batch_ground_draws, estimate_ground_batch, triplets_from,
)
from gloc3d_tpu_torch.ops.refine import icp_point_to_point
from gloc3d_tpu_torch.ops.voxelize import device_pillar_sort_stats
from gloc3d_tpu_torch.parallel.data import (
    gather_host, gather_rows, require_group, shard_rows,
)
from gloc3d_tpu_torch.parallel.collectives import (
    broadcast_rank0, group_shape,
)
from gloc3d_tpu_torch.parallel.sharding import ShardedBank
from gloc3d_tpu_torch.parallel.spatial import (
    check_divisible, spatial_sharded_apply,
)


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


def _numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _read(x) -> np.ndarray:
    """``_numpy`` on a located query's path: a tensor's copy is a ``wait``
    span (on a card, a host synchronisation)."""
    if isinstance(x, torch.Tensor):
        return profiling.to_host(x).numpy()
    return np.asarray(x)


class _ShardedBankAdapter:
    """DescriptorBank-shaped facade over the ``ShardedBank``, so that the
    localizer's API (``add_keyframes``, SLAM ``exclude_recent`` queries,
    ``truncate``, ``save``) keeps working after ``shard_bank``."""

    sharded = True

    def __init__(self, inner: ShardedBank, cfg):
        self._inner = inner
        self.cfg = cfg
        self.dim = inner.dim
        self.mesh = inner.mesh

    def __len__(self) -> int:
        return len(self._inner)

    def add(self, feats) -> None:
        self._inner.add(feats)

    def query(self, queries, k: Optional[int] = None,
              exclude_recent: bool = False):
        exclude_after = (len(self._inner) - self.cfg.num_exclude_recent
                         if exclude_recent else None)
        return self._inner.query(queries, k or self.cfg.top_k,
                                 exclude_after=exclude_after)

    def truncate(self, n: int) -> None:
        self._inner.truncate(min(n, len(self._inner)))

    def save(self, path: str) -> None:
        """The flat ``bank.npz`` an unsharded ``DescriptorBank`` reloads
        (the rows gathered from every rank, dequantized in int8 mode): rank
        0 writes, every rank returns after a barrier."""
        rows = self._inner.to_host()
        if group_shape(self.mesh)[1] == 0:
            np.savez(path, bank=rows, dim=self.dim, cfg=self.cfg.to_json())
        dist.barrier(group=self.mesh)


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

    @property
    def sharded(self) -> bool:
        return isinstance(self._ivf, ShardedIVF)

    @property
    def mesh(self):
        return self._ivf.mesh

    def _train(self) -> None:
        """Fit the quantizer on a sample of the buffered rows, once."""
        if self._ivf.centroids is not None or not self._pending:
            return
        batch = np.concatenate(self._pending)
        sample = batch[np.random.RandomState(0).permutation(len(batch))[
            : self.cfg.ivf_train_sample]]
        self._ivf.train(sample, torch.Generator().manual_seed(0))

    def _flush(self) -> None:
        if not self._pending:
            return
        self._train()
        batch = np.concatenate(self._pending)
        self._pending = []
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
        """Spread the cells over the ranks of ``mesh`` (``ShardedIVF``);
        queries keep the unsharded results. An index trained here takes
        rank 0's centroids on every rank before it ingests the buffered
        rows: k-means on the card may end in other bits on each rank."""
        if self._ivf.centroids is None and self._pending:
            self._train()
            broadcast_rank0(mesh, self._ivf.centroids)
        self._flush()
        if self._ivf.centroids is None:
            raise RuntimeError("cannot shard an untrained/empty IVF index")
        self._ivf = ShardedIVF(mesh, self._ivf)

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
    w = device_constant([1 << i for i in range(8)], torch.uint8,
                        images.device)
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


def _splice_staged(res1: MatchResult, res2: MatchResult,
                   failed: np.ndarray, b: int, k: int) -> MatchResult:
    """The (b, k) MatchResult of a staged batch on the host: the stage-1
    top-candidate lanes (res1: (b, 1)) and, for the queries in ``failed``,
    the stage-2 lanes over all k candidates (res2: (len(failed), k)).
    The other queries' untested lanes read zeros (success False), which
    first-success-wins never consults."""

    def leaf(l1, l2):
        l1, l2 = _read(l1), _read(l2)
        out = np.zeros((b, k) + l1.shape[2:], l1.dtype)
        out[:, :1] = l1
        out[failed] = l2[: len(failed)]
        return out

    return MatchResult(*(leaf(a, c) for a, c in zip(res1, res2)))


def _packed(parts) -> Tuple[torch.Tensor, tuple]:
    """Named tensors (fp32, integer or bool) as one int32 tensor, fp32
    bit-cast and the others converted, and its layout: a program's results
    come to the host in one copy, bit for bit."""
    words, layout = [], []
    for name, t in parts:
        kind = ("f" if t.dtype == torch.float32
                else "b" if t.dtype == torch.bool else "i")
        flat = t.reshape(-1)
        words.append(flat.view(torch.int32) if kind == "f"
                     else flat.to(torch.int32))
        layout.append((name, tuple(t.shape), kind))
    return torch.cat(words), tuple(layout)


def _unpacked(words: np.ndarray, layout) -> dict:
    """``_packed``'s tensors back from its words on the host, by name."""
    out, at = {}, 0
    for name, shape, kind in layout:
        n = int(np.prod(shape))
        w = words[at:at + n].reshape(shape)
        out[name] = (w.view(np.float32) if kind == "f"
                     else w.astype(bool) if kind == "b" else w)
        at += n
    return out


def _host_ground(rotation, translation) -> GroundEstimate:
    """A query's ground transform from its host copy, as numpy (its other
    fields are not read after the program)."""
    return GroundEstimate(
        Rigid3(np.asarray(rotation)[None], np.asarray(translation)[None]),
        None, None, None)


def _launches(field: str) -> Tuple[int, int]:
    """K1's and K2's counts ``field`` (captured or replayed launches)."""
    return (getattr(segment_sum.segment_sum_sorted, field),
            getattr(bin_sums.pillar_bin_sums, field))


class _FusedEager:
    """``locate_fused``'s two programs run as they are (the CPU; a program
    with a gloo collective): ``first(query)`` uploads the query, runs
    ``_fused_program`` and fetches its packed result in one copy;
    ``second()`` runs ``_fused_full`` on the first's carry."""

    def __init__(self, loc, variant: str, bank, store):
        self.loc, self.variant = loc, variant
        self.bank, self.store = bank, store

    def first(self, query) -> dict:
        with profiling.span("stage"):
            *q, sizes = [torch.from_numpy(np.ascontiguousarray(a)).to(
                self.loc.device) for a in query]
        with profiling.span("replay"):
            words, layout, self.carry, self.k2 = self.loc._fused_program(
                self.variant, q, self.bank, sizes, self.store)
        return _unpacked(_read(words), layout)

    def second(self) -> dict:
        with profiling.span("replay"):
            words, layout = _packed(zip(
                MatchResult._fields,
                self.loc._fused_full(*self.carry, self.store)))
        return _unpacked(_read(words), layout)


class _FusedGraphs:
    """``locate_fused``'s two programs captured as CUDA graphs that share
    one memory pool: ``_fused_program`` and, with ``staged_first``,
    ``_fused_full`` on its carry. ``first(query)`` copies the query into
    the static input buffers through pinned staging, replays the program
    and fetches its packed result in one copy; ``second()`` replays the
    full branch and fetches once more. Before capture both programs run
    once on a side stream, so that cuFFT's plans, the int8 GEMM's
    workspace, the device constants and the allocator are settled.

    The kernels' wrappers count a capture's launches in ``.captured``;
    each replay adds the launches it recorded to ``.replayed`` (K1's and
    K2's), which ``launches`` does not see. ``k2`` holds the K2 launches'
    (status, ids, V) from the capture, their buffers kept alive with the
    graphs, so a fault reads the replay's ids. ``marks`` and
    ``full_marks`` hold the device spans' timing events that each capture
    recorded (``profiling.graph_marks``): the fetches read them."""

    def __init__(self, loc, key, variant: str, query, bank, store):
        self.key = key
        dev = loc.device
        self.inputs = [torch.empty(a.shape, dtype=torch.from_numpy(
            np.asarray(a)).dtype, device=dev) for a in query]
        self.staging = [torch.empty(t.shape, dtype=t.dtype).pin_memory()
                        for t in self.inputs]
        self.stage(query)
        *q, sizes = self.inputs
        staged = loc.cfg.match.staged_first
        stream = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            _, _, carry, _ = loc._fused_program(variant, q, bank, sizes,
                                                store)
            if staged:
                loc._fused_full(*carry, store)
        stream.wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        before = _launches("captured")
        self.program = torch.cuda.CUDAGraph()
        with profiling.graph_marks() as self.marks, torch.cuda.graph(
                self.program, pool=pool):
            self.words, self.layout, carry, self.k2 = loc._fused_program(
                variant, q, bank, sizes, store)
        mid = _launches("captured")
        self.program_launches = (mid[0] - before[0], mid[1] - before[1])
        self.full = None
        if staged:
            self.full = torch.cuda.CUDAGraph()
            with profiling.graph_marks() as self.full_marks, torch.cuda.graph(
                    self.full, pool=pool):
                self.full_words, self.full_layout = _packed(zip(
                    MatchResult._fields, loc._fused_full(*carry, store)))
        profiling.count_capture()
        after = _launches("captured")
        self.full_launches = (after[0] - mid[0], after[1] - mid[1])
        self.carry = carry  # the full branch's inputs: the program's outputs

    def stage(self, query) -> None:
        """The query's arrays into the static inputs, through pinned
        memory (asynchronous copies; the previous call's fetch has
        synchronised, so the staging buffers are free)."""
        with profiling.span("stage"):
            for buf, pin, a in zip(self.inputs, self.staging, query):
                pin.numpy()[...] = a
                buf.copy_(pin, non_blocking=True)

    def launch(self, query) -> None:
        """Stage the query and replay the program: no synchronisation."""
        self.stage(query)
        with profiling.span("replay"):
            self.program.replay()
        _count_replay(self.program_launches)

    def fetch(self) -> dict:
        """The program's packed result on the host: one copy, after which
        the replay's device spans are read."""
        out = _unpacked(_read(self.words), self.layout)
        profiling.read_marks(self.marks)
        return out

    def first(self, query) -> dict:
        self.launch(query)
        return self.fetch()

    def launch_full(self) -> None:
        with profiling.span("replay"):
            self.full.replay()
        _count_replay(self.full_launches)

    def fetch_full(self) -> dict:
        out = _unpacked(_read(self.full_words), self.full_layout)
        profiling.read_marks(self.full_marks)
        return out

    def second(self) -> dict:
        self.launch_full()
        return self.fetch_full()


# the device spans of a registration stage: the candidates' gather from the
# store, then the matcher; stage 1 registers the top candidate, the full
# stage all K
_STAGE1 = ("store_gather", "register")
_STAGE_FULL = ("store_gather_full", "register_full")


def _count_replay(launches: Tuple[int, int]) -> None:
    segment_sum.segment_sum_sorted.replayed += launches[0]
    bin_sums.pillar_bin_sums.replayed += launches[1]


class GlobalLocalizer:
    """Build-once query-many localization engine (s2s or i2i).

    Args:
      cfg: a PipelineConfig (the port's or the JAX package's).
      model: a DescriptorModel (models/descriptor.py), or an
        ``export.py::ExportedDescriptorModel`` (weights inside the
        program; ``params`` stays None, B=1 queries only).
      params: optional state_dict to load into ``model``.
      host_stats: bin and draw the BEV on the host, or on the device
        (default); ignored for an image encoder and an exported model.
      device: where the model, the bank and the matcher run (default:
        ``cuda``; without a card, pass ``device="cpu"``).
      align_ground: gravity-align scans before BEV / descriptor extraction.
      seed: seed of the ground estimator's draws.
      device_keyframes: keep the keyframes' BEV occupancy on the device,
        bit-packed, and gather registration candidates from there.
      host_mirror: also keep each keyframe's image and origin on the host
        (default); False needs ``device_keyframes``.
      device_sort: on the all-device path, bin by a device pillar sort and
        K1 instead of K2 (PointPillar only; ``host_stats`` wins).
    """

    def __init__(self, cfg, model, params=None, *, host_stats: bool = False,
                 device: Optional[torch.device] = None,
                 align_ground: bool = False, seed: int = 0,
                 device_keyframes: bool = False, host_mirror: bool = True,
                 device_sort: bool = False):
        if not host_mirror and not device_keyframes:
            raise ValueError("host_mirror=False requires device_keyframes")
        self.cfg = cfg
        self.i2i = is_image_encoder(cfg.model.encoder)
        # an exported model (export.py) runs the plain forward only
        self.host_stats = (host_stats and not self.i2i
                           and getattr(model, "supports_voxel_stats", True))
        self.device_sort = (device_sort
                            and cfg.model.encoder == "pointpillar"
                            and getattr(model, "supports_voxel_stats", True))
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
        self._kf_cap = 0          # the store's rows over every rank
        self._kf_mesh = None      # the process group of shard_keyframes
        self._gen = torch.Generator().manual_seed(seed)
        self._dp = None  # the process group of shard_extraction
        self._spatial = None  # the forward of shard_spatial
        self._spatial_mesh = None  # and its process group

    # ------------------------------------------------------------ extraction
    def _align(self, points: torch.Tensor, mask: torch.Tensor, draws=None):
        """Estimate every scan's ground plane in one call of the batched
        estimator and rotate the clouds into the gravity-aligned frame,
        keeping the intensity column. The rotation runs in float64 and
        rounds to fp32, so the card and the CPU give the same aligned
        floats from the same transform. ``draws``: (priority (B, N), a
        batched triplet sampler), else the B scans' draws from the
        localizer's generator in the order of one-scan calls, uploaded in
        one copy. Returns (aligned points, GroundEstimate with a leading
        batch axis)."""
        if draws is None:
            b, n = points.shape[:2]
            with profiling.span("draws"):
                prio, uni = batch_ground_draws(b, n, self.cfg.ground,
                                               self._gen)
                both = torch.cat([prio, uni.reshape(b, -1)], 1).to(
                    points.device)
            draws = (both[:, :n], triplets_from(both[:, n:].reshape(
                uni.shape)))
        with profiling.device_span("ground", self.device):
            ground = estimate_ground_batch(
                points[..., :3], mask, self.cfg.ground, priority=draws[0],
                sample_triplets=draws[1])
            q64 = ground.transform.rotation.double()[:, None]
            t64 = ground.transform.translation.double()[:, None]
            xyz = (quat_rotate(q64, points[..., :3].double()) + t64).float()
            return torch.cat([xyz, points[..., 3:]], dim=-1), ground

    def _default_origins(self, n: int) -> np.ndarray:
        """Scan-centred origins for images given without theirs."""
        half = self.cfg.bev.image_size / 2.0 * self.cfg.bev.resolution
        return np.full((n, 2), -half, np.float32)

    def _extract_images(self, images, origins):
        """i2i on BEV probability images (B, S, S, 3), free = 1.0: the
        descriptor, and channel 0 as the registration BEV."""
        if origins is None:
            origins = self._default_origins(len(images))
        return self._images_forward(
            torch.as_tensor(np.asarray(images, np.float32),
                            device=self.device),
            torch.as_tensor(np.asarray(origins, np.float32),
                            device=self.device)) + (None,)

    def _images_forward(self, images: torch.Tensor, origins: torch.Tensor):
        """(descriptors, BEVImage) of images (B, S, S, 3) and their origins
        (B, 2) on the device: channel 0 is the registration BEV."""
        img2d = images[..., 0]
        bev = BEVImage(
            image=img2d, origin_xy=origins,
            resolution=np.float32(self.cfg.bev.resolution),
            num_occupied=(img2d < 0.5).sum(dim=(1, 2)).int())
        forward = self.model if self._spatial is None else self._spatial
        with profiling.device_span("encoder", self.device):
            return forward(images), bev

    @torch.no_grad()
    def extract(self, inputs: np.ndarray, mask: Optional[np.ndarray] = None,
                origins: Optional[np.ndarray] = None):
        """Batched extraction → (descriptors (B, D) on the device, BEVImage
        batch, ground estimates or None). Inputs are padded clouds
        (B, N, ≥3) with mask (B, N), or, for an image encoder, BEV
        probability images (B, S, S, 3) with ``origins`` (B, 2), each
        image's pixel-(0, 0) metric coordinate (scan-centred by default).
        The BEV batch is numpy with host stats and on the device
        without. After ``shard_extraction`` a batch the group's size
        divides is extracted data-parallel, with the same result; after
        ``shard_spatial`` images take the spatial partition instead."""
        spatial = self._spatial is not None and np.ndim(inputs) == 4
        if (self._dp is not None and not spatial
                and len(inputs) % dist.get_world_size(self._dp) == 0):
            return self._extract_sharded(inputs, mask, origins)
        return self._extract(inputs, mask, origins)

    def _extract_sharded(self, inputs, mask, origins):
        """``extract`` over the ranks of ``shard_extraction``'s group: this
        rank's rows, then every output gathered in rank order."""
        mesh, b = self._dp, len(inputs)
        rows = shard_rows(b, mesh)
        draws = None
        if np.ndim(inputs) == 4:
            if origins is None:
                origins = self._default_origins(b)
        elif self.align_ground:  # every scan's draws, in the unsharded order
            prio, uni = batch_ground_draws(b, np.shape(inputs)[1],
                                           self.cfg.ground, self._gen)
            draws = (prio[rows], triplets_from(uni[rows]))
        desc, bev, ground = self._extract(
            inputs[rows], None if mask is None else mask[rows],
            None if origins is None else np.asarray(origins)[rows], draws)

        def gather(x):
            if isinstance(x, torch.Tensor):
                return gather_rows(mesh, x)
            return gather_host(mesh, x, self.device)

        bev = BEVImage(gather(bev.image), gather(bev.origin_xy),
                       bev.resolution, gather(bev.num_occupied))
        if ground is not None:
            ground = GroundEstimate(
                Rigid3(gather(ground.transform.rotation),
                       gather(ground.transform.translation)),
                gather(ground.plane), gather(ground.valid),
                gather(ground.inlier_fraction))
        return gather(desc), bev, ground

    def _extract(self, inputs, mask=None, origins=None, draws=None):
        """``extract`` on this process alone; ``draws`` as in ``_align``."""
        if np.ndim(inputs) == 4:
            if not self.i2i:
                raise ValueError("BEV image inputs need an image encoder; "
                                 f"this model's is {self.cfg.model.encoder!r}")
            return self._extract_images(inputs, origins)
        pts = _xyzi(inputs)
        if not self.host_stats:
            return self._extract_device(*self._upload(pts, mask), draws)
        ground = None
        if self.align_ground:  # the host pass bins the aligned floats
            pts_d, ground = self._aligned(*self._upload(pts, mask), draws)
            pts = pts_d.cpu().numpy()
        stats, imgs, origins, nocc = self._host_pass(pts, mask)
        desc = self._stats_forward([
            torch.from_numpy(a).to(self.device, non_blocking=True)
            for a in stats])
        bev = BEVImage(image=imgs, origin_xy=origins,
                       resolution=np.float32(self.cfg.bev.resolution),
                       num_occupied=nocc)
        return desc, bev, ground

    def _upload(self, pts: np.ndarray, mask):
        """Scans (B, N, 4) and masks (B, N) on the device, fp32."""
        with profiling.span("stage"):
            return (torch.from_numpy(pts).to(self.device),
                    torch.from_numpy(np.asarray(mask, np.float32)).to(
                        self.device))

    def _aligned(self, pts_d, mask_d, draws):
        # _align(points, mask) is the seam that tests/test_torch_i2i.py
        # replays JAX's draws through
        return (self._align(pts_d, mask_d) if draws is None
                else self._align(pts_d, mask_d, draws))

    def _extract_device(self, pts_d: torch.Tensor, mask_d: torch.Tensor,
                        draws=None):
        """The all-device extraction of scans (B, N, 4) with masks (B, N)
        on the device: the ground alignment (``draws`` as in ``_align``),
        the BEV image and the descriptors, with no host read."""
        ground = None
        if self.align_ground:
            pts_d, ground = self._aligned(pts_d, mask_d, draws)
        with profiling.device_span("bev", self.device):
            bev = batch_scan_to_bev(pts_d[..., :3], mask_d, self.cfg.bev)
        with profiling.device_span("encoder", self.device):
            if self.i2i:  # the BEV, repeated to 3 channels, is the input
                desc = self.model(bev.image[..., None].repeat(1, 1, 1, 3))
            elif self.device_sort:  # the host pass's contract, on the device
                vc = self.cfg.voxel
                ps, vs, ids, starts, counts, cents = device_pillar_sort_stats(
                    pts_d, mask_d, vc.xbound, vc.ybound, vc.zbound)
                desc = self.model(ps, vs,
                                  voxel_stats=(ids, counts, cents, starts))
            else:
                desc = self.model(pts_d, mask_d)
        return desc, bev, ground

    def _host_pass(self, pts: np.ndarray, mask):
        """The native host pass of scans (B, N, 4): the seven arrays of the
        sorted pillar statistics, and the BEV images, origins and occupied
        counts (from the ORIGINAL row order: sorted rows are not
        prefix-padded)."""
        vc = self.cfg.voxel
        counts = np.asarray(np.asarray(mask).sum(axis=1), np.int64)
        stats = native.compute_voxel_stats_host_sorted(
            pts, counts, vc.xbound, vc.ybound, vc.zbound, crop=False,
            per_point=True)
        return (stats,) + tuple(native.compute_bev_host(pts, counts,
                                                        self.cfg.bev))

    def _stats_forward(self, stats):
        """Descriptors from the host pass's seven arrays on the device."""
        s_p, s_v, s_i, s_c, s_g, s_s, s_pp = stats
        with profiling.device_span("encoder", self.device):
            return self.model(s_p, s_v,
                              voxel_stats=(s_i, s_c, s_g, s_s, s_pp))

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

    def _kf_shape(self) -> Tuple[int, int]:
        """(ranks, this rank) of the device store: (1, 0) unsharded."""
        if self._kf_mesh is None:
            return 1, 0
        return group_shape(self._kf_mesh)

    def _local_rows(self, cap: int) -> int:
        """This rank's rows of a ``cap``-row store: rows i ≡ rank mod P."""
        return -(-cap // self._kf_shape()[0])

    def _ensure_kf_capacity(self, n_needed: int, s: int) -> None:
        """Room for ``n_needed`` rows in the device store: 1024 rows at
        first, doubling (each rank of a sharded store grows its own part;
        no row moves)."""
        if self._kf_store is None:
            cap = 1024
            while cap < n_needed:
                cap *= 2
            self._kf_store = torch.zeros((self._local_rows(cap), s, s // 8),
                                         dtype=torch.uint8,
                                         device=self.device)
            self._kf_origins = torch.zeros((self._local_rows(cap), 2),
                                           dtype=torch.float32,
                                           device=self.device)
            self._kf_cap = cap
        while self._kf_cap < n_needed:
            self._kf_cap *= 2
            for name in ("_kf_store", "_kf_origins"):
                old = getattr(self, name)
                grown = old.new_zeros((self._local_rows(self._kf_cap),)
                                      + old.shape[1:])
                grown[: old.shape[0]] = old
                setattr(self, name, grown)

    def _store_keyframes(self, images, origins, offset: int) -> None:
        """Write a batch of BEV images (B, S, S), bit-packed, and their
        origins into the device store at row ``offset``: on a sharded
        store, each rank the rows it owns."""
        images = torch.as_tensor(images, dtype=torch.float32,
                                 device=self.device)
        n = images.shape[0]
        self._ensure_kf_capacity(offset + n, images.shape[-1])
        world, rank = self._kf_shape()
        first = (rank - offset) % world  # the batch's first row owned here
        lo = (offset + first) // world
        mine = slice(first, n, world)
        m = len(range(first, n, world))
        self._kf_store[lo : lo + m] = _pack_bits(images[mine])
        self._kf_origins[lo : lo + m] = torch.as_tensor(
            origins, dtype=torch.float32, device=self.device)[mine]

    def _gather_store(self, rows: torch.Tensor, store):
        """Packed rows and origins of the global rows ``rows`` (a device
        tensor, the same on every rank) from a sharded store (this rank's
        (rows, origins)): each rank writes the rows it owns into zeros, and
        one SUM all-reduce of the bytes gives every rank the rows bit for
        bit."""
        world, rank = self._kf_shape()
        k, s = rows.shape[0], store[0].shape[1]
        local = torch.where(rows % world == rank, rows // world, -1)
        nb = s * (s // 8)
        found = torch.cat([
            store[0].index_select(0, local.clamp(min=0)).view(k, nb),
            store[1].index_select(0, local.clamp(min=0)).view(
                torch.uint8)], 1)
        both = torch.where((local >= 0)[:, None], found, 0)
        dist.all_reduce(both, group=self._kf_mesh)
        return (both[:, :nb].view(k, s, s // 8),
                both[:, nb:].contiguous().view(torch.float32))

    def _store_rows(self, rows, store=None):
        """Packed rows (K, S, S/8) and origins (K, 2) of the device store
        (``store``: its (rows, origins), by default the localizer's) at the
        global indices ``rows`` (numpy or a device tensor)."""
        if store is None:
            store = (self._kf_store, self._kf_origins)
        rows = torch.as_tensor(rows, dtype=torch.long, device=store[0].device)
        if self._kf_mesh is not None:
            return self._gather_store(rows, store)
        return store[0].index_select(0, rows), store[1].index_select(0, rows)

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
        with profiling.device_span("search", self.device):
            d2, idx = self.bank.query(desc, k=self.cfg.index.top_k)
        return d2, idx, bev, ground

    def shard_bank(self, mesh=None) -> None:
        """Spread the descriptor bank over the ranks of the process group
        ``mesh`` (None: the default group), after the db build. Flat
        backend: its rows (``ShardedBank``, capacity ``max(capacity,
        ranks)``, fp32 or int8 as configured; an int8 bank is re-quantized
        from its dequantized rows, as JAX does). IVF backend: its cells
        (``ShardedIVF``). Every rank calls it, and then every query, with
        the same arguments; results equal the unsharded bank's."""
        if isinstance(self.bank, _IVFBankAdapter):
            self.bank.shard(mesh)
            return
        if not isinstance(self.bank, DescriptorBank):
            raise TypeError(
                "shard_bank migrates a flat DescriptorBank or an IVF "
                f"backend; current backend is {type(self.bank).__name__}")
        world, _ = group_shape(mesh)
        sharded = ShardedBank(mesh, dim=self.bank.dim,
                              capacity=max(self.bank._capacity, world),
                              quantize=self.cfg.index.quantize,
                              device=self.device)
        if len(self.bank):
            sharded.add(self.bank.data)
        self.bank = _ShardedBankAdapter(sharded, self.cfg.index)

    def shard_extraction(self, mesh=None, axis: str = "data") -> None:
        """Extract data-parallel over the ranks of the process group
        ``mesh`` (None: the default group): every later ``extract``,
        ``add_keyframes``, ``detect`` or ``locate_batch`` whose batch the
        group's size divides splits it over the ranks, each running the
        whole forward on its rows, and gathers the results, so every rank
        gets the unsharded call's. Every rank makes the same calls (SPMD).
        Composes with ``shard_bank``, which spreads the query side.
        (``axis`` names JAX's mesh axis; a process group has one.)"""
        self._dp = require_group(mesh, "shard_extraction")

    def shard_keyframes(self, mesh=None, axis: str = "data") -> None:
        """Spread the device keyframe store over the ranks of the process
        group ``mesh`` (None: the default group): rank r keeps the rows
        i ≡ r mod P, ⌈capacity/P⌉ of them (module docstring). Needs
        ``device_keyframes=True`` and a built store. Every rank calls it,
        and then every query, add, save and load, with the same arguments
        (SPMD); results equal the unsharded store's bit for bit. Composes
        with ``shard_bank`` and ``shard_extraction``. (``axis`` names
        JAX's mesh axis; a process group has one.)"""
        if not self.device_keyframes or self._kf_store is None:
            raise RuntimeError(
                "shard_keyframes requires device_keyframes=True and a "
                "built store")
        if self._kf_mesh is not None:
            raise RuntimeError("the keyframe store is already sharded")
        group = require_group(mesh, "shard_keyframes")
        world, rank = group_shape(group)
        local = -(-self._kf_cap // world)
        for name in ("_kf_store", "_kf_origins"):
            whole = getattr(self, name)
            part = whole.new_zeros((local,) + whole.shape[1:])
            mine = whole[rank::world]
            part[: mine.shape[0]] = mine
            setattr(self, name, part)
        self._kf_mesh = group

    def shard_spatial(self, mesh=None, axis: str = "data") -> None:
        """Run every image extraction (``extract``, ``add_keyframes``,
        ``detect`` and the located queries on (B, S, S, 3) images) as the
        spatial partition over the ranks of the process group ``mesh``
        (None: the default group): each rank computes the encoder on its
        band of image rows, the heads' sums are added over the group, and
        every rank gets the whole batch's descriptors
        (``parallel/spatial.py``). For images it takes the place of
        ``shard_extraction``. Image encoders only, and the image size must
        split evenly over the ranks at every pooling level
        (``check_divisible``). Every rank makes the same calls (SPMD)."""
        if self.cfg.model.encoder == "pointpillar":
            raise ValueError(
                "shard_spatial applies to image (i2i) encoders; the s2s "
                "pillar path shards on the batch axis (shard_extraction)")
        group = require_group(mesh, "shard_spatial")
        check_divisible(self.cfg.bev.image_size, group_shape(group)[0])
        self._spatial = spatial_sharded_apply(group, self.model, axis)
        self._spatial_mesh = group

    def _candidates(self, rows):
        """Keyframes ``rows`` (numpy or a device tensor of indices, any
        shape, e.g. (B, K)) as a float image stack rows.shape + (S, S) and
        origins rows.shape + (2,) on the device: one gather of packed rows
        from the device store, or the host mirror's images stacked and
        uploaded at once."""
        if self._kf_store is not None:
            rows = torch.as_tensor(rows, dtype=torch.long,
                                   device=self.device)
            packed, origins = self._store_rows(rows.reshape(-1))
            images = _unpack_bits(packed)
            return (images.reshape(rows.shape + images.shape[1:]),
                    origins.reshape(rows.shape + (2,)))
        rows = np.asarray(rows)
        stack = np.stack([self.keyframes[i].image for i in rows.reshape(-1)])
        origins = np.stack([self.keyframes[i].origin_xy
                            for i in rows.reshape(-1)])
        stack = torch.from_numpy(stack.reshape(rows.shape + stack.shape[1:]))
        return (stack.to(self.device).float() / 255.0,
                torch.from_numpy(origins.reshape(rows.shape + (2,))).to(
                    self.device))

    @torch.no_grad()
    def _match(self, q_images, q_origins, rows, spans=_STAGE1
               ) -> MatchResult:
        """Register B queries (BEV images (B, S, S), origins (B, 2)) against
        the keyframes ``rows`` (B, K) on the device in one call → (B, K)
        lanes; ``spans`` names the gather's and the matcher's device
        spans."""
        with profiling.device_span(spans[0], self.device):
            images, origins = self._candidates(rows)
        query = BEVImage(
            image=torch.as_tensor(q_images, device=self.device),
            origin_xy=torch.as_tensor(q_origins, device=self.device),
            resolution=self.cfg.bev.resolution,
            num_occupied=None)
        with profiling.device_span(spans[1], self.device):
            return match_bev_topk(query, images, origins, self.cfg.match,
                                  resolution=self.cfg.bev.resolution)

    def _register(self, q_images, q_origins, rows) -> MatchResult:
        """First success wins, for B queries against their candidates
        ``rows`` (B, K) (``locate`` and ``locate_batch``): the top candidate
        usually succeeds, so with ``staged_first`` register every query's
        top candidate in one call, read the B successes on the host (one
        synchronisation, which picks the failed set's shape), and register
        all K candidates of exactly the queries that failed in one more,
        spliced back by lane (B, K); without it, one call over all (B, K).
        ``locate_fused`` takes the same two stages as two programs
        (``_fused_program``, ``_fused_full``) and reads stage 1's success
        in its one fetch. Every rank of a sharded store makes the same
        calls: the failed set comes from the same lanes."""
        if not self.cfg.match.staged_first:
            return self._match(q_images, q_origins, rows, _STAGE_FULL)
        res1 = self._match(q_images, q_origins, rows[:, :1])
        failed = np.flatnonzero(~_read(res1.success)[:, 0])
        if not failed.size:
            return res1
        profiling.count("stage2_runs", failed.size)
        res2 = self._match(q_images[failed], q_origins[failed], rows[failed],
                           _STAGE_FULL)
        return _splice_staged(res1, res2, failed, *rows.shape)

    def _staged(self, q_image, q_origin, rows) -> MatchResult:
        """``_register`` for one query (S, S), (2,) and its candidates (K,):
        its lanes."""
        res = self._register(q_image[None], q_origin[None], rows[None])
        return MatchResult(*(x[0] for x in res))

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
        succ = _read(res.success)
        scores = _read(res.score)
        if not succ.any():
            return LocalizationResult(False, -1, None, idx0, d2,
                                      float(scores.max()), None)
        k_star = int(np.argmax(succ))
        db_idx = int(idx0[k_star])
        xy_yaw = _read(res.xy_yaw)[k_star]
        if clouds is not None:
            xy_yaw = self._maybe_refine(clouds[0][q], clouds[1][q], db_idx,
                                        xy_yaw)
        xy_yaw = torch.as_tensor(xy_yaw)
        t_q = t_db = None
        if self.align_ground and ground is not None:
            t_q = Rigid3(_read(ground.transform.rotation[q]),
                         _read(ground.transform.translation[q]))
            t_db = self._db_ground(db_idx)
        pose = compose_6dof(xy_yaw, t_q, t_db)
        return LocalizationResult(
            True, db_idx,
            Rigid3(pose.rotation.numpy(), pose.translation.numpy()),
            idx0, d2, float(scores[k_star]), xy_yaw.numpy())

    def locate(self, points: np.ndarray, mask: Optional[np.ndarray] = None,
               origin: Optional[np.ndarray] = None) -> LocalizationResult:
        """Full pipeline for ONE query: a scan (N, ≥3) with mask (N,), or a
        BEV image (S, S, 3) with its origin (2,). ``locate_batch`` of one."""
        return self.locate_batch(*_one(points, mask, origin))[0]

    def locate_batch(self, points: np.ndarray,
                     masks: Optional[np.ndarray] = None,
                     origins: Optional[np.ndarray] = None
                     ) -> List[LocalizationResult]:
        """Localize B query scans (B, N, ≥3) with masks (B, N), or B BEV
        images (B, S, S, 3) with origins (B, 2): extraction and the bank
        search run once for the batch, and registration once per stage
        (``_register``): with ``staged_first``, stage 1 registers every
        query's top candidate and stage 2 all top-k candidates of the
        queries that failed stage 1, spliced back by lane. Each result
        equals ``locate``'s on the same scan."""
        with profiling.entry("locate_batch", len(points)):
            if not self.keyframes:
                return [self._empty_result() for _ in range(len(points))]
            d2, idx, bev, ground = self.detect(points, masks, origins)
            # a db smaller than top_k returns inf-distance filler
            # candidates: clamp them to a real keyframe (their inf distance
            # ranks them last)
            idx = np.clip(idx, 0, len(self.keyframes) - 1)
            res = self._register(bev.image, bev.origin_xy, idx)
            with profiling.span("compose"):
                clouds = self._query_clouds(points, masks, ground)
                return [self._result(MatchResult(*(x[q] for x in res)),
                                     idx[q], d2[q], ground, q, clouds)
                        for q in range(len(idx))]

    def locate_fused(self, points: np.ndarray,
                     mask: Optional[np.ndarray] = None,
                     origin: Optional[np.ndarray] = None
                     ) -> LocalizationResult:
        """``locate`` for ONE query, a scan or a BEV image (S, S, 3), as one
        device program (``_fused_program``, JAX's jitted
        ``_locate_fused_impl`` and its two variants): extraction, the bank
        search, the candidates clamped and gathered from the device
        keyframe store, and stage 1 of ``staged_first``. The host uploads
        the query and fetches one packed result; only when the top
        candidate failed does a second program (``_fused_full``, the full
        branch of JAX's ``lax.cond``) register all K candidates, with one
        more fetch. On a card both are CUDA graphs (``_FusedGraphs``),
        captured on the first call and again whenever the model, the
        configuration, the TF32 flags or the storage of the bank, the IVF
        cells or the store change; the bank's and the store's sizes are
        inputs, so adds that fit need no capture. A capture or replay that
        fails raises (torch's allocator then holds device memory it does
        not reuse: restart the process). The one exception, by rule: a
        program that would run a collective over a gloo group (a store
        sharded over gloo, the spatial forward of an image query over
        gloo), which CUDA cannot capture, runs eagerly, as every program
        does on the CPU.

        The host keeps JAX's host work: the native host pass of the host
        stats variant (with its alignment as a program of its own and one
        fetch when aligned), the aligned variant's ground draws from the
        localizer's generator, the IVF flush and upload, and the 6-DoF
        composition. K2's id-range status words come back with the result
        and raise ``ValueError`` there. Host stats, all-device (scatter or
        ``device_sort``), aligned and image extraction as the localizer is
        built; the flat bank (fp32 or int8) or the IVF index. Results equal
        ``locate``'s. Needs ``device_keyframes=True`` and a built store;
        ``match.refine_icp`` and a sharded bank are not supported."""
        with profiling.entry("locate_fused", 1):
            return self._locate_fused(points, mask, origin)

    def _locate_fused(self, points, mask, origin) -> LocalizationResult:
        if not self.keyframes:
            return self._empty_result()
        if self._kf_store is None:
            raise RuntimeError("locate_fused requires device_keyframes=True"
                               " and a built store")
        if self.cfg.match.refine_icp:
            raise RuntimeError("locate_fused does not compose with "
                               "match.refine_icp (use locate)")
        if getattr(self.bank, "sharded", False):
            raise RuntimeError("locate_fused does not search a sharded bank "
                               "(shard_bank); use locate or locate_batch")
        out, full, ground = self._fused_run(points, mask, origin)
        with profiling.span("compose"):
            return self._fused_result(out, full, ground)

    def _fused_run(self, points, mask=None, origin=None, captured=None):
        """``locate_fused`` up to the result: (stage 1's host dict, the full
        branch's or None, the host stats variant's ground or None). The
        programs run captured as the rule of ``_fused_captures`` says, or as
        ``captured`` says (the eager run that a captured one is held to)."""
        variant = self._fused_variant(points)
        query, ground = self._fused_query(variant, points, mask, origin)
        query += (np.array([len(self.bank), len(self.keyframes)], np.int32),)
        bank = self._fused_bank()
        store = (self._kf_store, self._kf_origins)
        if captured is None:
            captured = self._fused_captures(variant)
        if captured:
            run = self._fused_graphs_for(variant, query, bank, store)
        else:
            run = _FusedEager(self, variant, bank, store)
        out = run.first(query)
        bin_sums.check_deferred(
            [out[f"k2_status{i}"] for i in range(len(run.k2))], run.k2)
        stage2 = self.cfg.match.staged_first and not out["success"][0]
        if stage2:
            profiling.count("stage2_runs")
        return out, run.second() if stage2 else None, ground

    def _fused_variant(self, points) -> str:
        """Which program a query takes: ``images``, ``host stats`` (aligned
        or not), ``aligned`` (all-device) or ``device``."""
        if np.ndim(points) == 3:
            return "images"
        if self.host_stats:
            return "host stats"
        return "aligned" if self.align_ground else "device"

    def _fused_query(self, variant: str, points, mask=None, origin=None):
        """The host side before the program: the query as the program's
        input arrays (numpy), and the ground estimate of the aligned host
        stats variant, whose alignment is a program of its own with one
        fetch of the aligned scan and its transform (else None)."""
        if variant == "images":
            org = self._default_origins(1) if origin is None else origin
            return (np.asarray(points, np.float32)[None],
                    np.asarray(org, np.float32).reshape(1, 2)), None
        pts = _xyzi(np.asarray(points)[None])
        mask = np.asarray(mask, np.float32)[None]
        if variant == "device":
            return (pts, mask), None
        if variant == "aligned":  # the draws _align would take
            with profiling.span("draws"):
                prio, uni = batch_ground_draws(1, pts.shape[1],
                                               self.cfg.ground, self._gen)
                return (pts, mask, prio.numpy(), uni.numpy()), None
        ground = None
        if self.align_ground:  # _align's draws, uploaded without a sync
            with profiling.span("draws"):
                prio, uni = batch_ground_draws(1, pts.shape[1],
                                               self.cfg.ground, self._gen)
            pts_d, mask_d, prio, uni = (self._staged_upload(a) for a in (
                pts, mask, prio.numpy(), uni.numpy()))
            pts_d, est = self._aligned(pts_d, mask_d,
                                       (prio, triplets_from(uni)))
            host = profiling.to_host(torch.cat([
                pts_d.reshape(-1), est.transform.rotation.reshape(-1),
                est.transform.translation.reshape(-1)]))
            n = pts_d.numel()
            pts = host[:n].reshape(pts_d.shape).numpy()
            ground = _host_ground(host[n:n + 4], host[n + 4:n + 7])
        stats, imgs, origins, _ = self._host_pass(pts, mask)
        return tuple(stats) + (imgs, origins), ground

    def _staged_upload(self, a: np.ndarray) -> torch.Tensor:
        """``a`` on the device, copied from pinned memory on a card (an
        asynchronous copy: no synchronisation)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _fused_bank(self) -> tuple:
        """The bank's arrays as the program searches them: the flat bank at
        full capacity, or the IVF index flushed and its cells uploaded."""
        if isinstance(self.bank, _IVFBankAdapter):
            self.bank._flush()
            return self.bank._ivf.search_arrays()
        return self.bank.arrays()

    def _fused_program(self, variant: str, query, bank: tuple,
                       sizes: torch.Tensor, store):
        """ONE device program for a located query: the extraction of the
        uploaded ``query`` (``variant``), the top-k search of ``bank``
        with rows from ``sizes[0]`` (the bank's size, a device int32) on
        masked, the candidates clamped below the bank's and the store's
        (``sizes[1]``) sizes, gathered from ``store`` and registered: the
        top candidate alone with ``staged_first`` (the full branch is
        ``_fused_full``), else all K. Static shapes and no host read: K2's
        status words come out with the results (``bin_sums.
        deferred_status``). Returns (int32 words, their layout, the
        (q_image, q_origin, rows) that ``_fused_full`` takes, K2's
        launches)."""
        with bin_sums.deferred_status() as k2:
            desc, q_image, q_origin, ground = self._fused_extract(variant,
                                                                  query)
        k = self.cfg.index.top_k
        with profiling.device_span("search", self.device):
            if len(bank) == 5:
                d2, idx = ivf_search(bank, desc.float(), k,
                                     self.bank._ivf.nprobe)
            else:
                d2, idx = search(bank, desc.float(), k, sizes[0])
        last = (torch.minimum(sizes[0], sizes[1]) - 1).clamp_min(0)
        rows = torch.minimum(idx[0].clamp_min(0), last)
        if self.cfg.match.staged_first:
            res = self._fused_match(q_image, q_origin, rows[:1], store)
        else:
            res = self._fused_full(q_image, q_origin, rows, store)
        parts = [("d2", d2[0]), ("idx", idx[0])]
        parts += zip(MatchResult._fields, res)
        if ground is not None:
            parts += [("ground_q", ground.transform.rotation[0]),
                      ("ground_t", ground.transform.translation[0])]
        parts += [(f"k2_status{i}", st) for i, (st, _, _) in enumerate(k2)]
        words, layout = _packed(parts)
        return words, layout, (q_image, q_origin, rows), k2

    def _fused_extract(self, variant: str, query):
        """(descriptor (1, D), query BEV (S, S), its origin (2,), ground
        estimate or None) of the uploaded query."""
        if variant == "images":
            desc, bev = self._images_forward(*query)
            return desc, bev.image[0], bev.origin_xy[0], None
        if variant == "host stats":
            *stats, imgs, origins = query
            return self._stats_forward(stats), imgs[0], origins[0], None
        draws = None
        if variant == "aligned":
            draws = (query[2], triplets_from(query[3]))
        desc, bev, ground = self._extract_device(query[0], query[1], draws)
        return desc, bev.image[0], bev.origin_xy[0], ground

    def _fused_match(self, q_image, q_origin, rows, store) -> MatchResult:
        """Stage 1 of ``staged_first``: ``_fused_register`` of the top
        candidate ``rows`` (1,)."""
        return self._fused_register(q_image, q_origin, rows, store, _STAGE1)

    def _fused_register(self, q_image, q_origin, rows, store, spans
                        ) -> MatchResult:
        """The query (S, S), (2,) against the store's rows ``rows`` (R,)
        → (R,) lanes, as ``_match`` registers a batch of one; ``spans``
        names the gather's and the matcher's device spans."""
        with profiling.device_span(spans[0], self.device):
            packed, origins = self._store_rows(rows, store)
            images = _unpack_bits(packed)
        query = BEVImage(image=q_image[None], origin_xy=q_origin[None],
                         resolution=self.cfg.bev.resolution,
                         num_occupied=None)
        with profiling.device_span(spans[1], self.device):
            res = match_bev_topk(query, images[None], origins[None],
                                 self.cfg.match,
                                 resolution=self.cfg.bev.resolution)
        return MatchResult(*(x[0] for x in res))

    def _fused_full(self, q_image, q_origin, rows, store) -> MatchResult:
        """The full branch of ``staged_first`` (JAX's ``full(_)`` of its
        ``lax.cond``): the query against all K candidates ``rows`` → (K,)
        lanes; run only when stage 1 failed (or as the only stage without
        ``staged_first``)."""
        return self._fused_register(q_image, q_origin, rows, store,
                                    _STAGE_FULL)

    def _fused_captures(self, variant: str) -> bool:
        """Whether ``locate_fused`` runs its programs as CUDA graphs: on a
        card, unless the program would run a collective over a gloo group
        (the sharded store's gather; the spatial forward of an image
        query), which CUDA cannot capture."""
        if self.device.type != "cuda":
            return False
        groups = [self._kf_mesh]
        if variant == "images":
            groups.append(self._spatial_mesh)
        return not any(g is not None and dist.get_backend(g) == "gloo"
                       for g in groups)

    def _fused_key(self, variant: str, query, bank, store) -> tuple:
        """What a captured program bakes in: the variant, the configuration,
        the model and forward objects and the addresses of the model's
        tensors, the query's shapes, the TF32 flags, and the address and
        shape of every bank, IVF and store tensor."""
        tensors = [t for t in bank + store if t is not None]
        weights = ()
        if isinstance(self.model, torch.nn.Module):
            weights = tuple(t.data_ptr() for t in itertools.chain(
                self.model.parameters(), self.model.buffers()))
        return (variant, self.cfg, self.model, weights, self._spatial,
                self._kf_mesh, tuple((a.shape, a.dtype.str) for a in query),
                tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                      for t in tensors),
                torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)

    def _fused_graphs_for(self, variant: str, query, bank, store
                          ) -> "_FusedGraphs":
        """The captured programs for this state, captured anew (the stale
        ones freed first) when their key changed."""
        key = self._fused_key(variant, query, bank, store)
        graphs = getattr(self, "_fused_graphs", None)
        if graphs is None or graphs.key != key:
            self._fused_graphs = None
            self._fused_graphs = _FusedGraphs(self, key, variant, query,
                                              bank, store)
        return self._fused_graphs

    def _fused_result(self, out: dict, full: Optional[dict],
                      ground) -> LocalizationResult:
        """The LocalizationResult from the host copy alone: stage 1's lanes
        or, when it failed, the full branch's; the aligned program's ground
        transform, or the one of the host stats variant's alignment."""
        lanes = out if full is None else full
        res = MatchResult(*(lanes[f] for f in MatchResult._fields))
        if "ground_q" in out:
            ground = _host_ground(out["ground_q"], out["ground_t"])
        idx0 = np.clip(out["idx"], 0, len(self.keyframes) - 1)
        return self._result(res, idx0, out["d2"], ground)

    # ------------------------------------------------------------ persistence
    def save(self, out_dir: str) -> None:
        """Write the built map to ``out_dir``, in the JAX package's format:
        ``bank.npz``, ``keyframes.npz`` (``images`` uint8 0/255,
        ``origins``, ``ground_q`` / ``ground_t`` when any keyframe has a
        ground frame, and ``clouds`` when every keyframe has an ICP cloud)
        and ``config.json``. With ``host_mirror=False`` the images are
        rebuilt from the device store, 256 rows at a time. With a sharded
        bank or store, or after ``shard_extraction`` or ``shard_spatial``,
        every rank calls it; rank 0 writes the files (a sharded bank or
        store gathered first, on every rank), and every rank returns after
        a barrier."""
        os.makedirs(out_dir, exist_ok=True)
        sharded = getattr(self.bank, "sharded", False)
        mesh = next((g for g in (self.bank.mesh if sharded else None,
                                 self._kf_mesh, self._dp, self._spatial_mesh)
                     if g is not None), None)
        rank0 = mesh is None or group_shape(mesh)[1] == 0
        if sharded or rank0:  # a sharded bank gathers on every rank
            self.bank.save(os.path.join(out_dir, "bank.npz"))
        if rank0 or self._kf_mesh is not None:  # so does a sharded store
            images, origins = self._map_images()
        if rank0:
            self._save_map(out_dir, images, origins)
        if mesh is not None:
            dist.barrier(group=mesh)

    def _map_images(self) -> Tuple[np.ndarray, np.ndarray]:
        """Every keyframe's uint8 image (0/255) and origin: the host
        mirror's, or rebuilt from the device store."""
        n = len(self.keyframes)
        if self.host_mirror:
            return (np.stack([k.image for k in self.keyframes]),
                    np.stack([k.origin_xy for k in self.keyframes]))
        s = self._kf_store.shape[1]
        images = np.empty((n, s, s), np.uint8)
        origins = np.empty((n, 2), np.float32)
        for i in range(0, n, 256):
            packed, org = self._store_rows(np.arange(i, min(i + 256, n)))
            images[i : i + 256] = _numpy(
                (_unpack_bits(packed) * 255.0).to(torch.uint8))
            origins[i : i + 256] = _numpy(org)
        return images, origins

    def _save_map(self, out_dir: str, images: np.ndarray,
                  origins: np.ndarray) -> None:
        """``keyframes.npz`` and ``config.json`` of ``save``."""
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
        res = self._match(bev.image[:1], bev.origin_xy[:1], cand[None])
        res = MatchResult(*(x[0] for x in res))
        clouds = (self._query_clouds(*_one(points, mask, None)[:2], ground)
                  if points is not None else None)
        return self._result(res, cand, np.array([np.nan]), ground,
                            clouds=clouds)
