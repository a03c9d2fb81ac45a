"""Typed configuration for the port: its own copy of the JAX package's
``gloc3d_tpu/config.py``, with the same dataclasses, field names, defaults
and presets, so a config written by either package loads in the other.

The reference scatters configuration between 28 argparse flags (main.py:42-84)
and hard-coded C++ constants (loop_detector.h:97-117,
range_data_inserter_3d.cpp:58-61, fast_correlative_scan_matcher_2d.h:43-52).
Here everything lives in one tree of frozen dataclasses so a pipeline run is
fully described by a single ``PipelineConfig`` value that hashes/compares and
can be serialized to JSON.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Tuple


# feature width of each image encoder (models/encoders.py of the JAX package)
ENCODER_DIMS = {"alexnet": 256, "vgg16": 512, "mobilenet": 320,
                "resnet18": 512}


def _asdict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        return {f.name: _asdict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_asdict(v) for v in obj]
    return obj


@dataclasses.dataclass(frozen=True)
class _Base:
    def to_dict(self) -> dict:
        return _asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d):
        # PEP 563: field annotations are strings; resolve to real types.
        import typing

        hints = typing.get_type_hints(cls)
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            t = hints.get(f.name, f.type)
            if isinstance(t, type) and dataclasses.is_dataclass(t):
                v = t.from_dict(v)
            elif isinstance(v, list):
                v = tuple(v)
            kw[f.name] = v
        return cls(**kw)

    @classmethod
    def from_json(cls, s: str):
        return cls.from_dict(json.loads(s))


@dataclasses.dataclass(frozen=True)
class BEVConfig(_Base):
    """Fused scan → BEV probability-image projection.

    Mirrors the reference constants: resolution 0.2 m / 0.5 m, max insert
    range 100 m (loop_detector.h:115-117), hit/miss odds 0.55/0.49
    (range_data_inserter_3d.cpp:58-61), probability clamp [0.1, 0.9]
    (probability_values.h:64-65), occupied-voxel threshold 0.501
    (submap_3d.cpp:256), binarization prob_sum > 0.9 (submap_3d.cpp:312-324),
    and the 768×768 center crop/pad with 255 fill (i2i_util.py:23-24, 53-91).
    """

    resolution: float = 0.2          # high-res grid, meters/voxel
    low_resolution: float = 0.5      # low-res grid (Submap3D's second grid,
                                     # submap_3d.cpp:153-159 / loop_detector.h:117)
    max_range: float = 100.0         # meters; beyond → "miss" ray
    hit_probability: float = 0.55
    miss_probability: float = 0.49
    min_probability: float = 0.1     # probability clamp lower bound
    max_probability: float = 0.9     # clamp upper bound == binarization threshold
    occupied_threshold: float = 0.501  # voxels below are not projected
    image_size: int = 768            # output H == W
    free_value: float = 1.0          # free/unknown pixel (reference: uint8 255)
    occupied_value: float = 0.0      # occupied pixel (reference: uint8 0)
    num_free_space_voxels: int = 2   # ray free-space samples (range_data_inserter_3d.cpp:75)
    max_points: int = 131072         # static point-budget per scan (pad/trim)
    z_min: float = -40.0             # static z-extent for voxel hashing
    z_max: float = 62.0


@dataclasses.dataclass(frozen=True)
class VoxelConfig(_Base):
    """PointPillar voxelization bounds — (min, max, step) per axis.

    Reference: gen_libtorch_pointpillar.py:28-30 (KITTI s2s defaults).
    """

    xbound: Tuple[float, float, float] = (-35.0, 35.0, 0.5)
    ybound: Tuple[float, float, float] = (-20.0, 20.0, 0.5)
    zbound: Tuple[float, float, float] = (-10.0, 10.0, 20.0)
    max_points: int = 122480         # KITTI pad size (kitti_s2s.py:224)

    @property
    def grid_size(self) -> Tuple[int, int, int]:
        return (
            int(round((self.xbound[1] - self.xbound[0]) / self.xbound[2])),
            int(round((self.ybound[1] - self.ybound[0]) / self.ybound[2])),
            int(round((self.zbound[1] - self.zbound[0]) / self.zbound[2])),
        )


@dataclasses.dataclass(frozen=True)
class ModelConfig(_Base):
    """Descriptor extractor: encoder + pooling.

    encoder: image encoders 'vgg16' (512-ch) | 'alexnet' (256) |
    'mobilenet' (320) | 'resnet18' (512) consume 768×768×3 BEV images
    (main.py:519-564), or 'pointpillar' (s2s, raw padded clouds → 128-ch
    BEV feature map).
    pooling: 'netvlad_fc' | 'netvlad' | 'max' | 'avg' (main.py:574-618).
    """

    encoder: str = "pointpillar"
    pooling: str = "netvlad_fc"
    num_clusters: int = 64           # main.py:80
    encoder_dim: int = 128           # pointpillar: 128; vgg16: 512
    vladv2: bool = False
    gating: bool = False
    normalize_input: bool = True
    compute_dtype: str = "bfloat16"  # conv compute dtype on the MXU
    param_dtype: str = "float32"
    fold_bn: bool = False            # serving: BN folded into conv weights
                                     # (models/fold.py::fold_batch_norm)
    vgg_pack_width: bool = True      # vgg16: width-pair-packed first block
                                     # (models/vgg.py::PackedPairConv; same
                                     # params, bf16-tolerance equal, ~1.25×)


@dataclasses.dataclass(frozen=True)
class IndexConfig(_Base):
    """Descriptor bank + top-k query.

    top_k 20, feature dim, exclude-recent 30 / rebuild-period 30 SLAM-mode
    semantics from loop_detector.h:97-103 and loop_detector.cpp:62-81.
    """

    dim: int = 128
    top_k: int = 20
    metric_dist_threshold: float = 0.8   # loop accept gate (loop_detector.h:99)
    num_exclude_recent: int = 30
    rebuild_period: int = 30
    capacity: int = 8192                 # static bank capacity (grows by doubling)
    backend: str = "flat"                # "flat" (exact) | "ivf" (map-scale)
    quantize: str = "none"               # "none" (fp32) | "int8": per-row
                                         # symmetric int8 codes + exact fp32
                                         # norms — 4× less HBM per query at
                                         # map scale, int8 MXU matmul
                                         # (beyond-reference scaling mode)
    ivf_num_cells: int = 256             # IVF coarse-quantizer cells
    ivf_cell_capacity: int = 256         # rows per cell (doubles on overflow)
    ivf_nprobe: int = 8                  # cells scored per query
    ivf_train_sample: int = 65536        # quantizer training sample size


@dataclasses.dataclass(frozen=True)
class GroundConfig(_Base):
    """Ground-plane estimation (roll/pitch/z).

    Reference: ground_estimator.cpp — 20 m candidate radius (:202), k=10 NN
    normals (:78), 18×10° pitch-angle histogram keeping near-vertical bins
    (:82-124), RANSAC plane with 0.1 m inlier distance (:26).
    """

    candidate_radius: float = 20.0
    num_candidates: int = 4096       # subsample budget for normal estimation
    knn: int = 10
    num_bins: int = 18               # 10° pitch bins
    vertical_lo: int = 4             # bins in (vertical_lo, vertical_hi) are rejected
    vertical_hi: int = 13
    ransac_iters: int = 256
    inlier_threshold: float = 0.1
    fixed_lidar_height: float = 1.73  # KITTI db-side fixed height (global_registration.cpp:1219)


@dataclasses.dataclass(frozen=True)
class MatchConfig(_Base):
    """BEV registration matcher.

    The reference matches with SURF + FLANN + RANSAC partial-affine
    (loop_detector.cpp:192-288). The TPU-native matcher is an exhaustive
    rotation × translation correlation search (the capability the reference
    also has as FastCorrelativeScanMatcher2D / TestGridMatch,
    global_registration.cpp:778-840), run coarse-to-fine as batched FFT
    correlation. Output contract is unchanged: (dx, dy, yaw) metric transform
    q→db plus a confidence score and accept gate.
    """

    num_rotations: int = 120         # coarse yaw bins over 360°
    refine_rotations: int = 11       # fine bins around the coarse argmax
    refine_span_deg: float = 6.0     # fine search half-window = span/2
    coarse_downsample: int = 4       # coarse stage resolution divisor
    coarse_rot_downsample: int = 0   # extra pooling for the rotation-argmax
                                     # correlation only (0 → coarse_downsample;
                                     # 8 quarters the per-candidate coarse FFT
                                     # cost; the coarse stage's sole output is
                                     # θ_coarse, so shift precision is free)
    coarse_mode: str = "stack"       # θ_coarse estimator: "stack" = rotation
                                     # stack × FFT correlation (exact dense
                                     # search); "fm" = Fourier-Mellin angular
                                     # signature (translation-invariant |F|
                                     # polar correlation, 180°-disambiguated
                                     # by a 2-rotation check) — no rotation
                                     # stack at all, ~2× faster staged
    fm_theta_bins: int = 180         # fm angular bins over [0, π) (1° each)
    fine_downsample: int = 1         # fine stage divisor (2 halves cost 4x at
                                     # 2x the grid step — still << the 1 m gate)
    fine_pad_px: int = 192           # fine FFT zero-pad at full res (pad_f =
                                     # good_fft_size(S/g + this/g)); sets the
                                     # alias-free translation window ≈
                                     # (fine_pad_px − 2·drift)·res ≈ 30 m at
                                     # defaults — ≥ the 20 m posDistThr
                                     # candidate radius with margin
    fine_argmax_downsample: int = 0  # two-stage fine (0/1 = off): run the
                                     # δ-fan + its yaw-argmax at an EXTRA
                                     # ÷this (4× cheaper fan at 2), then
                                     # score/pose the winning δ with one
                                     # full-θ query rotation against the
                                     # unrotated db at the fine grid — exact
                                     # peak, same score semantics, per-
                                     # candidate correlation volume ÷rf
    fine_top_f: int = 0              # register only the F best candidates by
                                     # coarse score in the batched fallback
                                     # (0 = all, exact first-success-wins);
                                     # serving preset uses 4 — candidates the
                                     # coarse stage ranks last essentially
                                     # never pass the fine gate
    min_score: float = 0.22          # normalized-correlation accept gate
    min_overlap_pixels: int = 64     # minimum occupied-pixel overlap
    overlap_norm: bool = False       # masked NCC: normalize each shift by the
                                     # occupancy masses INSIDE the overlap
                                     # region (low-overlap pairs score by
                                     # their overlap quality, not their
                                     # overlap fraction); ~3x fine-stage cost
    staged_first: bool = True        # locate(): register the top candidate
                                     # alone first (first-success-wins; the
                                     # common case costs 1/top_k the matcher
                                     # work), batch the rest only on failure
    min_peak_ratio: float = 0.0      # optional extra gate on peak sharpness
                                     # (MatchResult.ratio); 0 disables. True
                                     # matches peak uniquely (ratio ≳ 1.1);
                                     # structurally-similar negatives
                                     # correlate diffusely (≲ 1.08 measured)
    image_size: int = 768
    refine_icp: bool = False         # 3-D point-to-point ICP polish of
    # accepted matches in locate / locate_batch / match_keyframe: each
    # keyframe keeps a downsampled scan cloud, and the query's cloud is
    # registered onto it from the match's (dx, dy, yaw), the result
    # projected back to (dx, dy, yaw). Scans only (no cloud for image
    # inputs); locate_fused refuses it. Off by default, as in the JAX
    # package (its refinement study, RESULTS.md round 5, measured on a TPU).
                                     # (global_registration.cpp:1388-1398 role)
    refine_icp_points: int = 4096    # points per downsampled scan cloud
    refine_icp_iters: int = 10
    refine_icp_max_corr: float = 1.0  # correspondence gate, meters


@dataclasses.dataclass(frozen=True)
class MeshConfig(_Base):
    """Device-mesh / sharding layout (new capability, SURVEY.md §2.3)."""

    data_axis: str = "data"
    num_devices: int = 0             # 0 → use all available


@dataclasses.dataclass(frozen=True)
class TrainConfig(_Base):
    """Triplet training; hyperparameters follow main.py:53-58, 630-645."""

    optimizer: str = "sgd"           # 'sgd' | 'adam' (main.py:630-641: ADAM
                                     # is plain Adam(lr) — no weight decay,
                                     # no StepLR; SGD gets momentum+wd+step)
    lr: float = 1e-4
    momentum: float = 0.9
    weight_decay: float = 1e-3
    lr_step: int = 5                 # StepLR epochs
    lr_gamma: float = 0.5
    epochs: int = 30
    margin: float = 0.1              # triplet margin is sqrt(margin) (main.py:644)
    batch_size: int = 2              # triplets per step
    n_neg: int = 10
    cache_refresh_rate: int = 1000
    eval_every: int = 1
    patience: int = 10
    seed: int = 123
    pos_dist_thr: float = 20.0       # positives radius, meters (kitti_i2i.py:195)
    nontriv_pos_dist: float = 10.0   # nontrivial-positive radius (i2i_util.py:233)
    neg_dist_thr: float = 20.0       # negatives must be farther than this
    n_neg_sample: int = 1000         # negatives sampled per query before mining
    augment_yaw: bool = False        # random z-rotation of query scans per step
                                     # (s2s only) — trains heading invariance;
                                     # an addition beyond the reference
    host_stats: bool = False         # s2s: per-pillar stats + counting sort on
                                     # the host (the serving fast path) for
                                     # train steps and cache refreshes — no
                                     # device scatters in fwd, exact row-gather
                                     # backward (pallas_scatter.py::
                                     # segment_sum_sorted_grad). Same math as
                                     # the all-device step modulo float
                                     # reassociation (tests/
                                     # test_train_hoststats.py)


@dataclasses.dataclass(frozen=True)
class PipelineConfig(_Base):
    bev: BEVConfig = BEVConfig()
    voxel: VoxelConfig = VoxelConfig()
    model: ModelConfig = ModelConfig()
    index: IndexConfig = IndexConfig()
    ground: GroundConfig = GroundConfig()
    match: MatchConfig = MatchConfig()
    mesh: MeshConfig = MeshConfig()
    train: TrainConfig = TrainConfig()

    @staticmethod
    def i2i(encoder: str = "vgg16") -> "PipelineConfig":
        """i2i preset: an image encoder on 768×768 BEV images; descriptor
        dim follows the encoder's feature width (main.py:519-564)."""
        dim = ENCODER_DIMS[encoder]
        c = PipelineConfig()
        return c.replace(
            model=c.model.replace(encoder=encoder, encoder_dim=dim),
            index=c.index.replace(dim=dim),
        )

    @staticmethod
    def s2s() -> "PipelineConfig":
        """s2s preset: PointPillar on raw clouds, 128-d descriptors."""
        return PipelineConfig()

    def fast_match(self, fm: bool = False) -> "PipelineConfig":
        """Serving-matcher preset: the registration latency levers measured
        in RESULTS.md round 3 — fine stage at ÷2 (0.4 m grid, still ≪ the
        1 m success gate), θ-argmax correlation at ÷8, and fine
        registration only for the 4 best candidates by coarse score.
        fm=True additionally swaps the coarse rotation stack for the
        Fourier-Mellin angular-signature estimator (coarse_mode='fm').
        The fine stage is two-staged (fine_argmax_downsample=2): the yaw
        argmax runs another ÷2 down, then the winner is scored/posed at the
        fine grid with one full-θ rotation.
        Exact first-success-wins parity needs the defaults instead."""
        return self.replace(match=self.match.replace(
            fine_downsample=2, coarse_rot_downsample=8, fine_top_f=4,
            fine_argmax_downsample=2,
            coarse_mode="fm" if fm else "stack",
        ))
