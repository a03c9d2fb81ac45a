"""ctypes bridge to the port's host pass (``native/scan_loader.cpp``).

The host-stats path bins and pillar-sorts each padded scan, and draws its
BEV image, on the host: ``compute_voxel_stats_host_sorted`` and
``compute_bev_host``, with the semantics and outputs of their counterparts
in the JAX package's ``data/native.py``. The library builds with g++ at
first use, into ``gloc3d_tpu_torch/_build/`` (git-ignored), under a name
that carries a hash of the source, the flags and the host CPU's features,
so an edited source or another machine rebuilds and concurrent builds never
load a half-written file.

There is no numpy fallback: this pass is the hot path of the host-stats
query, and a build or load failure raises instead of running ten times
slower unnoticed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "scan_loader.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
             "-shared", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_GRID = [ctypes.c_float, ctypes.c_float, ctypes.c_int64] * 3


def _cpu_flags() -> bytes:
    """The host CPU's feature flags: ``-march=native`` builds for them, so a
    library built on one machine is not loaded on another."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((ln for ln in f if ln.startswith(b"flags")), b"")
    except OSError:
        return platform.processor().encode()


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()
                                + _cpu_flags()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libscanloader_{digest}.so")


def load_library() -> ctypes.CDLL:
    """Build the library if needed, load it and set its argtypes once.
    Raises RuntimeError when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            try:
                proc = subprocess.run([CXX, *CXX_FLAGS, SOURCE, "-o", tmp],
                                      capture_output=True, text=True,
                                      timeout=300)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise RuntimeError(f"cannot build {SOURCE}: {e}") from e
            if proc.returncode != 0:
                raise RuntimeError(f"{CXX} failed on {SOURCE}:\n"
                                   f"{proc.stderr}")
            os.replace(tmp, so)
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            raise RuntimeError(f"cannot load {so}: {e}") from e
        lib.compute_voxel_stats_sorted.restype = ctypes.c_int
        lib.compute_voxel_stats_sorted.argtypes = (
            [_f32p, _i64p, ctypes.c_int64] + _GRID + [ctypes.c_int]
            + [_f32p, _f32p, _i32p, _f32p, _f32p, _i32p, _f32p,
               ctypes.c_int64, ctypes.c_int])
        lib.compute_bev_batch.restype = ctypes.c_int
        lib.compute_bev_batch.argtypes = [
            _f32p, _i64p, ctypes.c_int64,
            ctypes.c_float, ctypes.c_int64, ctypes.c_float,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            _f32p, _f32p, _i32p, ctypes.c_int64, ctypes.c_int]
        _lib = lib
        return _lib


def _grid(bound) -> int:
    return int(round((bound[1] - bound[0]) / bound[2]))


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def compute_voxel_stats_host_sorted(
    points: np.ndarray, counts: np.ndarray,
    xbound, ybound, zbound,
    crop: bool = False, max_points: Optional[int] = None,
    num_threads: int = 8, per_point: bool = False,
):
    """Host pillar statistics + counting sort of padded scans.

    Args:
      points: (B, N, 4) padded scans; counts: (B,) real rows per scan
        (valid rows first).
      crop: drop points outside the voxelizer-valid set (only pillar 0's
        count and centroid change).
      max_points: output row budget (defaults to N).
      per_point: also return the per-point (count, centroid) rows.

    Returns (points (B, M, 4) pillar-SORTED, valid (B, M), ids (B, M)
    int32, raw_counts (B, V), centroids (B, V, 3), starts (B, V+1) int32),
    plus pp (B, M, 4) with ``per_point=True``: the model's ``voxel_stats``
    ``(ids, raw_counts, centroids, starts[, pp])``.
    """
    lib = load_library()
    b, n, _ = points.shape
    m = int(max_points or n)
    nx, ny, nz = _grid(xbound), _grid(ybound), _grid(zbound)
    n_vox = nx * ny * nz
    out_p = np.zeros((b, m, 4), np.float32)
    out_v = np.zeros((b, m), np.float32)
    out_i = np.zeros((b, m), np.int32)
    out_c = np.zeros((b, n_vox), np.float32)
    out_g = np.zeros((b, n_vox, 3), np.float32)
    out_s = np.zeros((b, n_vox + 1), np.int32)
    out_pp = np.zeros((b, m, 4), np.float32) if per_point else None
    pts = np.ascontiguousarray(points, np.float32)
    cnt = np.ascontiguousarray(counts, np.int64)
    rc = lib.compute_voxel_stats_sorted(
        _ptr(pts, _f32p), _ptr(cnt, _i64p), b,
        xbound[0], xbound[2], nx, ybound[0], ybound[2], ny,
        zbound[0], zbound[2], nz, int(crop),
        _ptr(out_p, _f32p), _ptr(out_v, _f32p), _ptr(out_i, _i32p),
        _ptr(out_c, _f32p), _ptr(out_g, _f32p), _ptr(out_s, _i32p),
        None if out_pp is None else _ptr(out_pp, _f32p), m, num_threads)
    if rc != 0:
        raise RuntimeError(f"compute_voxel_stats_sorted returned {rc}")
    out = (out_p, out_v, out_i, out_c, out_g, out_s)
    return out + (out_pp,) if per_point else out


def compute_bev_host(points: np.ndarray, counts: np.ndarray, bev_cfg,
                     num_threads: int = 8):
    """Host scan → BEV probability images (``ops/bev.py::scan_to_bev``
    semantics, single-sweep fast path, no ground alignment).

    points: (B, N, ≥3) padded scans; counts: (B,) real rows.
    Returns (images (B, S, S) float32 free=1/occupied=0, origins (B, 2),
    num_occupied (B,) int32), bit-equal to the device version.
    """
    lib = load_library()
    b, n, _ = points.shape
    s = bev_cfg.image_size
    res = bev_cfg.resolution
    half_xy = int(bev_cfg.max_range / res) + 2
    z_lo = int(bev_cfg.z_min / res)
    nz = int((bev_cfg.z_max - bev_cfg.z_min) / res) + 2
    cols = min(points.shape[-1], 4)
    pts4 = np.zeros((b, n, 4), np.float32)
    pts4[..., :cols] = points[..., :cols]
    cnt = np.ascontiguousarray(counts, np.int64)
    imgs = np.empty((b, s, s), np.float32)
    origins = np.empty((b, 2), np.float32)
    nocc = np.empty((b,), np.int32)
    rc = lib.compute_bev_batch(
        _ptr(pts4, _f32p), _ptr(cnt, _i64p), b,
        res, s, bev_cfg.max_range, z_lo, nz, half_xy,
        bev_cfg.hit_probability, bev_cfg.max_probability,
        bev_cfg.occupied_value, bev_cfg.free_value,
        _ptr(imgs, _f32p), _ptr(origins, _f32p), _ptr(nocc, _i32p),
        n, num_threads)
    if rc != 0:
        raise RuntimeError(f"compute_bev_batch returned {rc}")
    return imgs, origins, nocc
