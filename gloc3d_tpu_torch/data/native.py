"""ctypes bridge to the port's host pass (``native/scan_loader.cpp``).

The port's copy of the JAX package's ``data/native.py``, with the same
semantics and bit-equal outputs:

- the file loaders: ``load_scan_batch`` decodes KITTI, nuScenes or NCLT
  scan files into one padded batch with per-file counts,
  ``load_scan_batch_pillar_sorted`` also pillar-sorts each scan, and
  ``load_scan_batch_voxel_stats`` also computes its pillar statistics;
- the host-stats path's passes over already-decoded scans:
  ``compute_voxel_stats_host_sorted`` (pillar statistics, the counting sort
  and the per-point rows) and ``compute_bev_host`` (the BEV image), with
  ``compute_voxel_stats_host`` (statistics, rows unsorted);
- numpy references the tests hold the library to: ``sort_points_by_pillar``
  and ``per_point_stats_table``.

The library builds with g++ at first use, into ``gloc3d_tpu_torch/_build/``
(git-ignored), under a name that carries a hash of the source, the flags
and the host CPU's features, so an edited source or another machine
rebuilds and concurrent builds never load a half-written file.

There is no numpy fallback: the host pass is the hot path of the host-stats
query and of a db build from disk, and a build or load failure raises
instead of running ten times slower unnoticed. A file that cannot be read
raises ``OSError`` naming it; a truncated file decodes its whole records.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

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
_FMT = {"kitti": 0, "nuscenes": 1, "nclt": 2}


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
        files = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int]
        scans = [_f32p, _i64p, ctypes.c_int64, ctypes.c_int64]
        stats_out = [_f32p, _f32p, _i32p, _f32p, _f32p]
        lib.compute_voxel_stats_sorted.restype = ctypes.c_int
        lib.compute_voxel_stats_sorted.argtypes = (
            scans + _GRID + [ctypes.c_int] + stats_out
            + [_i32p, _f32p, ctypes.c_int64, ctypes.c_int])
        lib.compute_voxel_stats.restype = ctypes.c_int
        lib.compute_voxel_stats.argtypes = (
            scans + _GRID + [ctypes.c_int] + stats_out
            + [ctypes.c_int64, ctypes.c_int])
        lib.load_scan_batch.restype = ctypes.c_int
        lib.load_scan_batch.argtypes = files + [
            _f32p, ctypes.c_int64, _i64p, ctypes.c_int]
        lib.load_scan_batch_pillar_sorted.restype = ctypes.c_int
        lib.load_scan_batch_pillar_sorted.argtypes = files + _GRID + [
            _f32p, _f32p, _i32p, _i32p, _i64p, ctypes.c_int64, ctypes.c_int]
        lib.load_scan_batch_voxel_stats.restype = ctypes.c_int
        lib.load_scan_batch_voxel_stats.argtypes = (
            files + _GRID + [ctypes.c_int] + stats_out
            + [_i64p, ctypes.c_int64, ctypes.c_int])
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


def _grid_args(xbound, ybound, zbound):
    """(xmin, xstep, nx, ymin, ystep, ny, zmin, zstep, nz) and V."""
    dims = [_grid(b) for b in (xbound, ybound, zbound)]
    args = [a for b, n in zip((xbound, ybound, zbound), dims)
            for a in (b[0], b[2], n)]
    return args, dims[0] * dims[1] * dims[2]


def _c_paths(paths: Sequence[str]):
    return (ctypes.c_char_p * len(paths))(
        *[os.fsencode(p) for p in paths])


def _raise_unread(paths: Sequence[str], counts: np.ndarray) -> None:
    """OSError naming the files the loader could not read (count -1)."""
    bad = [str(paths[i]) for i in np.flatnonzero(counts < 0)]
    raise OSError(f"the scan loader could not read {len(bad)} file(s): "
                  + ", ".join(bad[:5]) + (" ..." if len(bad) > 5 else ""))


def load_scan_batch(paths: List[str], fmt: str, max_points: int,
                    num_threads: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Decode scan files → ((B, max_points, 4) float32 padded with zeros,
    (B,) int64 counts of the points decoded, at most ``max_points`` each).
    ``fmt`` is "kitti", "nuscenes" or "nclt". Raises OSError naming any
    file that cannot be read."""
    lib = load_library()
    b = len(paths)
    out = np.zeros((b, max_points, 4), np.float32)
    counts = np.zeros((b,), np.int64)
    rc = lib.load_scan_batch(_c_paths(paths), b, _FMT[fmt], _ptr(out, _f32p),
                             max_points, _ptr(counts, _i64p), num_threads)
    if rc != 0:
        _raise_unread(paths, counts)
    return out, counts


def masks_from_counts(counts: np.ndarray, max_points: int) -> np.ndarray:
    """(B, max_points) float32 validity masks from per-scan counts."""
    return (np.arange(max_points)[None, :] < counts[:, None]).astype(
        np.float32)


def sort_points_by_pillar(points: np.ndarray, counts: np.ndarray,
                          xbound, ybound, zbound):
    """Numpy reference of the loader's pillar sort.

    Returns (points_sorted (B, P, 4), valid (B, P), pillar_ids (B, P),
    starts (B, V+1)). Padding and out-of-bounds points alias to pillar 0
    (the reference's voxel-0 quirks, ops/voxelize.py)."""
    b, p, _ = points.shape
    nx, ny, nz = _grid(xbound), _grid(ybound), _grid(zbound)
    v = nx * ny * nz
    out_p = np.zeros_like(points)
    out_v = np.zeros((b, p), np.float32)
    out_i = np.zeros((b, p), np.int32)
    out_s = np.zeros((b, v + 1), np.int32)
    for bi in range(b):
        n = int(counts[bi])
        coords = np.trunc(
            (points[bi, :, :3] - [xbound[0], ybound[0], zbound[0]])
            / [xbound[2], ybound[2], zbound[2]]
        ).astype(np.int64)
        ids = coords[:, 0] * ny * nz + coords[:, 1] * nz + coords[:, 2]
        oob = ((coords < 0).any(1) | (coords[:, 0] >= nx)
               | (coords[:, 1] >= ny) | (coords[:, 2] >= nz))
        ids = np.where(oob, 0, ids).astype(np.int32)
        ids[n:] = 0
        order = np.argsort(ids, kind="stable")
        out_p[bi] = points[bi, order]
        out_v[bi] = (order < n).astype(np.float32)
        out_i[bi] = ids[order]
        out_s[bi] = np.searchsorted(out_i[bi], np.arange(v + 1), side="left")
    return out_p, out_v, out_i, out_s


def load_scan_batch_pillar_sorted(paths: List[str], fmt: str,
                                  xbound, ybound, zbound, max_points: int,
                                  num_threads: int = 8):
    """Decode and pillar-sort scan files in one threaded pass: the rows
    each pillar's segment sum reads are contiguous
    (ops/voxelize.py::points_to_voxels_presorted).

    Returns (points (B, M, 4) sorted, valid (B, M), ids (B, M) int32,
    starts (B, V+1) int32), as ``sort_points_by_pillar`` of
    ``load_scan_batch``'s output. Raises OSError naming any file that
    cannot be read."""
    lib = load_library()
    b = len(paths)
    grid, v = _grid_args(xbound, ybound, zbound)
    points = np.zeros((b, max_points, 4), np.float32)
    valid = np.zeros((b, max_points), np.float32)
    ids = np.zeros((b, max_points), np.int32)
    starts = np.zeros((b, v + 1), np.int32)
    counts = np.zeros((b,), np.int64)
    rc = lib.load_scan_batch_pillar_sorted(
        _c_paths(paths), b, _FMT[fmt], *grid,
        _ptr(points, _f32p), _ptr(valid, _f32p), _ptr(ids, _i32p),
        _ptr(starts, _i32p), _ptr(counts, _i64p), max_points, num_threads)
    if rc != 0:
        _raise_unread(paths, counts)
    return points, valid, ids, starts


def _stats_outputs(b: int, m: int, v: int):
    return (np.zeros((b, m, 4), np.float32), np.zeros((b, m), np.float32),
            np.zeros((b, m), np.int32), np.zeros((b, v), np.float32),
            np.zeros((b, v, 3), np.float32))


def _stats_ptrs(outs):
    return [_ptr(a, k) for a, k in zip(outs, (_f32p, _f32p, _i32p, _f32p,
                                              _f32p))]


def compute_voxel_stats_host(points: np.ndarray, counts: np.ndarray,
                             xbound, ybound, zbound, crop: bool = False,
                             max_points: Optional[int] = None,
                             num_threads: int = 8):
    """Host pillar statistics of padded scans, rows in their order.

    What ``points_to_voxels`` derives with its first device scatter: raw
    per-pillar counts (padding included at pillar 0) and centroids.

    Args:
      points: (B, N, 4) padded scans; counts: (B,) real rows per scan.
      crop: drop points outside the voxelizer-valid set (only pillar 0's
        count and centroid change).
      max_points: output row budget (defaults to N).

    Returns (points (B, M, 4), valid (B, M), ids (B, M) int32,
    raw_counts (B, V), centroids (B, V, 3)).
    """
    lib = load_library()
    b, n, _ = points.shape
    m = int(max_points or n)
    grid, v = _grid_args(xbound, ybound, zbound)
    outs = _stats_outputs(b, m, v)
    pts = np.ascontiguousarray(points, np.float32)
    cnt = np.ascontiguousarray(counts, np.int64)
    rc = lib.compute_voxel_stats(_ptr(pts, _f32p), _ptr(cnt, _i64p), b, n,
                                 *grid, int(crop), *_stats_ptrs(outs), m,
                                 num_threads)
    if rc != 0:
        raise RuntimeError(f"compute_voxel_stats returned {rc}")
    return outs


def per_point_stats_table(points, valid, ids, raw_counts, centroids,
                          xbound, ybound, zbound) -> np.ndarray:
    """Per-point (count, centroid xyz) rows: the device gather
    ``table[ids]`` of ops/voxelize.py::points_to_voxels_hoststats, in
    numpy (the library's sorted pass emits the same rows with
    ``per_point=True``). Pillar 0's count column reports the VALID
    in-bounds point count (the device's masked recount); every other
    pillar reports its raw count."""
    lo = np.asarray([xbound[0], ybound[0], zbound[0]], np.float32)
    step = np.asarray([xbound[2], ybound[2], zbound[2]], np.float32)
    grid = np.asarray([_grid(b_) for b_ in (xbound, ybound, zbound)],
                      np.int64)
    coords = np.trunc(
        (points[..., :3].astype(np.float32) - lo) / step).astype(np.int64)
    inb = np.all((coords >= 0) & (coords < grid), axis=-1)
    valid0 = np.sum((ids == 0) & (valid > 0) & inb, axis=-1)  # (B,)
    ppv = raw_counts.copy()
    ppv[:, 0] = valid0
    table = np.concatenate([ppv[..., None], centroids], axis=-1)  # (B, V, 4)
    return np.take_along_axis(
        table, ids[..., None].astype(np.int64), axis=1).astype(np.float32)


def load_scan_batch_voxel_stats(paths: List[str], fmt: str,
                                xbound, ybound, zbound, max_points: int,
                                crop: bool = False, num_threads: int = 8):
    """Decode scan files and compute their pillar statistics in one
    threaded pass: ``compute_voxel_stats_host`` of the decoded scans (a
    file may hold up to 4 x ``max_points`` rows before the crop). Raises
    OSError naming any file that cannot be read."""
    lib = load_library()
    b = len(paths)
    grid, v = _grid_args(xbound, ybound, zbound)
    outs = _stats_outputs(b, max_points, v)
    decoded = np.zeros((b,), np.int64)
    rc = lib.load_scan_batch_voxel_stats(
        _c_paths(paths), b, _FMT[fmt], *grid, int(crop), *_stats_ptrs(outs),
        _ptr(decoded, _i64p), max_points, num_threads)
    if rc != 0:
        _raise_unread(paths, decoded)
    return outs


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
    grid, n_vox = _grid_args(xbound, ybound, zbound)
    outs = _stats_outputs(b, m, n_vox)
    out_s = np.zeros((b, n_vox + 1), np.int32)
    out_pp = np.zeros((b, m, 4), np.float32) if per_point else None
    pts = np.ascontiguousarray(points, np.float32)
    cnt = np.ascontiguousarray(counts, np.int64)
    rc = lib.compute_voxel_stats_sorted(
        _ptr(pts, _f32p), _ptr(cnt, _i64p), b, n, *grid, int(crop),
        *_stats_ptrs(outs), _ptr(out_s, _i32p),
        None if out_pp is None else _ptr(out_pp, _f32p), m, num_threads)
    if rc != 0:
        raise RuntimeError(f"compute_voxel_stats_sorted returned {rc}")
    out = outs + (out_s,)
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
