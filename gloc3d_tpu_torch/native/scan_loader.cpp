// Host pass of the port: threaded decoding of LiDAR scan files into padded
// batches (optionally pillar-sorted, or with pillar statistics), pillar
// statistics with a counting sort over already-decoded scans, and the BEV
// probability image, threaded over the scans of a batch.
//
// The port's own copy of the JAX package's native scan loader
// (native/scan_loader.cpp), with the same arithmetic, so both give
// bit-equal outputs. The file loaders also report, per file, the points
// decoded or -1, so that the caller can name a file that failed. Built with
// g++ into a plain-C shared library and loaded with ctypes by
// gloc3d_tpu_torch/data/native.py.

#include <algorithm>
#include <atomic>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

template <typename F>
void for_each_scan(int64_t num_scans, int num_threads, F&& body) {
  std::atomic<int64_t> next(0);
  if (num_threads < 1) num_threads = 1;
  std::vector<std::thread> workers;
  workers.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) {
    workers.emplace_back([&]() { body(next); });
  }
  for (auto& w : workers) w.join();
}

// Decodes one file into out (max_points, 4), pre-zeroed by the caller: KITTI
// stride-4 / nuScenes stride-5 float32 rows (x, y, z, intensity[, ring]),
// or NCLT packed records (3x uint16 x, y, z at 5 mm, offset -100 m, then
// uint8 intensity and laser id). Returns the points written (<= max_points,
// whole records only), or -1 when the file cannot be opened or read.
int64_t decode_file(const char* path, int fmt, float* out, int64_t max_points) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  const int64_t bytes = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);

  int64_t n = 0;
  if (fmt == 0 || fmt == 1) {  // KITTI stride-4 / nuScenes stride-5 float32
    const int stride = (fmt == 0) ? 4 : 5;
    const int64_t count = bytes / (stride * (int64_t)sizeof(float));
    std::vector<float> buf(count * stride);
    if (std::fread(buf.data(), sizeof(float), buf.size(), f) !=
        buf.size()) {
      std::fclose(f);
      return -1;
    }
    n = count < max_points ? count : max_points;
    for (int64_t i = 0; i < n; ++i) {
      out[i * 4 + 0] = buf[i * stride + 0];
      out[i * 4 + 1] = buf[i * stride + 1];
      out[i * 4 + 2] = buf[i * stride + 2];
      out[i * 4 + 3] = buf[i * stride + 3];
    }
  } else if (fmt == 2) {  // NCLT packed: 3x uint16 (x,y,z) + 2x uint8 (i,l)
    const int64_t count = bytes / 8;
    std::vector<uint8_t> buf(count * 8);
    if (std::fread(buf.data(), 1, buf.size(), f) != buf.size()) {
      std::fclose(f);
      return -1;
    }
    n = count < max_points ? count : max_points;
    constexpr float kScale = 0.005f;
    constexpr float kOffset = -100.0f;
    for (int64_t i = 0; i < n; ++i) {
      const uint8_t* r = &buf[i * 8];
      uint16_t xs, ys, zs;
      std::memcpy(&xs, r + 0, 2);
      std::memcpy(&ys, r + 2, 2);
      std::memcpy(&zs, r + 4, 2);
      out[i * 4 + 0] = xs * kScale + kOffset;
      out[i * 4 + 1] = ys * kScale + kOffset;
      out[i * 4 + 2] = zs * kScale + kOffset;
      out[i * 4 + 3] = (float)r[6];
    }
  } else {
    std::fclose(f);
    return -1;
  }
  std::fclose(f);
  return n;
}

// ---------------------------------------------------------------------------
// Pillar statistics, EXACTLY ops/voxelize.py::points_to_voxels:
//   * trunc-toward-zero binning; a point within one voxel below the grid
//     minimum truncates to bin 0 and is treated as valid;
//   * padding rows and out-of-bounds points alias to pillar 0: they add 1 to
//     pillar 0's raw count and their (possibly zero) xyz to its centroid sum;
//   * centroid[v] = xyz_sum[v] / max(raw_count[v], 1).
// With crop=1, points outside the voxelizer-valid set are dropped before
// padding.
void voxel_stats_one(
    const float* pts_in, int64_t n_in,  // decoded points, n_in real rows
    float xmin, float xstep, int64_t nx,
    float ymin, float ystep, int64_t ny,
    float zmin, float zstep, int64_t nz,
    int crop,
    float* points_out,    // (max_points, 4) pre-zeroed
    float* valid_out,     // (max_points,) pre-zeroed
    int32_t* ids_out,     // (max_points,) pre-zeroed
    float* counts_out,    // (V,) pre-zeroed
    float* centroids_out, // (V, 3) pre-zeroed (used as xyz sums, then divided)
    int64_t max_points,
    int64_t* valid0_out) {  // # real IN-BOUNDS rows in pillar 0
  const int64_t v = nx * ny * nz;
  int64_t w = 0;       // rows written
  int64_t valid0 = 0;  // real rows truly binned at cell (0, 0, 0)
  for (int64_t p = 0; p < n_in && w < max_points; ++p) {
    const float* r = pts_in + p * 4;
    const float fx = (r[0] - xmin) / xstep;
    const float fy = (r[1] - ymin) / ystep;
    const float fz = (r[2] - zmin) / zstep;
    // trunc toward zero, matching torch .int()
    const int64_t cx = (int64_t)fx, cy = (int64_t)fy, cz = (int64_t)fz;
    const bool oob = cx < 0 || cx >= nx || cy < 0 || cy >= ny ||
                     cz < 0 || cz >= nz;
    if (crop && oob) continue;
    const int32_t id = oob ? 0 : (int32_t)(cx * ny * nz + cy * nz + cz);
    if (!oob && id == 0) ++valid0;
    std::memcpy(points_out + w * 4, r, 4 * sizeof(float));
    valid_out[w] = 1.0f;
    ids_out[w] = id;
    counts_out[id] += 1.0f;
    centroids_out[id * 3 + 0] += r[0];
    centroids_out[id * 3 + 1] += r[1];
    centroids_out[id * 3 + 2] += r[2];
    ++w;
  }
  // padding rows alias to pillar 0: +1 count each, zero xyz contribution
  counts_out[0] += (float)(max_points - w);
  for (int64_t cell = 0; cell < v; ++cell) {
    const float d = counts_out[cell] > 1.0f ? counts_out[cell] : 1.0f;
    centroids_out[cell * 3 + 0] /= d;
    centroids_out[cell * 3 + 1] /= d;
    centroids_out[cell * 3 + 2] /= d;
  }
  *valid0_out = valid0;
}

// One scan: stats + counting sort (+ the per-point stats rows). pp, when
// non-null, receives per sorted row the 4-vector the device would otherwise
// gather from the stats table (ops/voxelize.py::points_to_voxels_hoststats):
// the pillar's point count (pillar 0 reports its VALID in-bounds count,
// matching the device's masked recount) and its centroid.
void sorted_stats_one(
    const float* pts_in, int64_t n_in,
    float xmin, float xstep, int64_t nx,
    float ymin, float ystep, int64_t ny,
    float zmin, float zstep, int64_t nz,
    int crop,
    float* po, float* vo, int32_t* io,
    float* co, float* go, int32_t* so,
    float* pp,  // nullable (max_points, 4)
    int64_t max_points,
    std::vector<float>& tmp_p, std::vector<float>& tmp_v,
    std::vector<int32_t>& tmp_i, std::vector<int32_t>& cursor) {
  const int64_t v = nx * ny * nz;
  std::fill(tmp_p.begin(), tmp_p.end(), 0.0f);
  std::fill(tmp_v.begin(), tmp_v.end(), 0.0f);
  std::fill(tmp_i.begin(), tmp_i.end(), 0);
  int64_t valid0 = 0;
  voxel_stats_one(
      pts_in, n_in, xmin, xstep, nx, ymin, ystep, ny, zmin, zstep, nz, crop,
      tmp_p.data(), tmp_v.data(), tmp_i.data(), co, go, max_points, &valid0);
  // starts from the (padding-inclusive) raw counts
  so[0] = 0;
  for (int64_t c = 0; c < v; ++c) so[c + 1] = so[c] + (int32_t)co[c];
  std::memcpy(cursor.data(), so, v * sizeof(int32_t));
  int64_t w = 0;  // count real rows to place padding after them
  for (; w < max_points && tmp_v[w] > 0.0f; ++w) {
    const int32_t id = tmp_i[w];
    const int32_t pos = cursor[id]++;
    std::memcpy(po + pos * 4, &tmp_p[w * 4], 4 * sizeof(float));
    vo[pos] = 1.0f;
    io[pos] = id;
  }
  for (int64_t p = w; p < max_points; ++p) {  // padding → pillar 0 tail
    const int32_t pos = cursor[0]++;
    std::memset(po + pos * 4, 0, 4 * sizeof(float));
    vo[pos] = 0.0f;
    io[pos] = 0;
  }
  if (!pp) return;
  for (int64_t p = 0; p < max_points; ++p) {
    const int32_t id = io[p];
    pp[p * 4 + 0] = id == 0 ? (float)valid0 : co[id];
    pp[p * 4 + 1] = go[id * 3 + 0];
    pp[p * 4 + 2] = go[id * 3 + 1];
    pp[p * 4 + 3] = go[id * 3 + 2];
  }
}

// matches ops/bev.py::_round_int: where(x>=0, floor(x+0.5), ceil(x-0.5))
inline int32_t round_half_away(float x) {
  return (int32_t)(x >= 0.0f ? floorf(x + 0.5f) : ceilf(x - 0.5f));
}

}  // namespace

extern "C" {

// Voxel stats + pillar COUNTING SORT: real rows in their original order
// within each pillar, padding rows at the tail of pillar 0 (a stable argsort
// of the unsorted output), per-pillar start offsets, and, where pp_out is
// not null, the per-point stats rows. points: (B, in_rows, 4), n_real (B,)
// real rows per scan. Outputs are pre-zeroed by the caller: points_out
// (B, M, 4), valid_out (B, M), ids_out (B, M), counts_out (B, V),
// centroids_out (B, V, 3), starts_out (B, V + 1), pp_out (B, M, 4), where M
// = max_points may differ from in_rows.
int compute_voxel_stats_sorted(
    const float* points, const int64_t* n_real, int64_t num_scans,
    int64_t in_rows,
    float xmin, float xstep, int64_t nx,
    float ymin, float ystep, int64_t ny,
    float zmin, float zstep, int64_t nz,
    int crop,
    float* points_out, float* valid_out, int32_t* ids_out,
    float* counts_out, float* centroids_out, int32_t* starts_out,
    float* pp_out, int64_t max_points, int num_threads) {
  const int64_t v = nx * ny * nz;
  for_each_scan(num_scans, num_threads, [&](std::atomic<int64_t>& next) {
    std::vector<float> tmp_p(max_points * 4);
    std::vector<float> tmp_v(max_points);
    std::vector<int32_t> tmp_i(max_points);
    std::vector<int32_t> cursor(v);
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= num_scans) return;
      sorted_stats_one(
          points + i * in_rows * 4, n_real[i],
          xmin, xstep, nx, ymin, ystep, ny, zmin, zstep, nz, crop,
          points_out + i * max_points * 4, valid_out + i * max_points,
          ids_out + i * max_points, counts_out + i * v,
          centroids_out + i * v * 3, starts_out + i * (v + 1),
          pp_out ? pp_out + i * max_points * 4 : nullptr, max_points,
          tmp_p, tmp_v, tmp_i, cursor);
    }
  });
  return 0;
}

// Host BEV probability image: the exact ops/bev.py::scan_to_bev semantics
// (single-sweep fast path, no ground alignment). The derived integer bounds
// (half_xy, z_lo, nz) come from the Python caller, so both implementations
// share one truncation rule.
int compute_bev_batch(
    const float* points, const int64_t* n_real, int64_t num_scans,
    float res, int64_t s, float max_range,
    int64_t z_lo, int64_t nz, int64_t half_xy,
    float hit_prob, float max_prob, float occupied_value, float free_value,
    float* image_out,    // (B, s, s), filled here
    float* origin_out,   // (B, 2)
    int32_t* nocc_out,   // (B,)
    int64_t max_points, int num_threads) {
  for_each_scan(num_scans, num_threads, [&](std::atomic<int64_t>& next) {
    std::vector<int64_t> vids;
    std::vector<int32_t> cx, cy;  // distinct-cell coords (parallel arrays)
    std::vector<uint16_t> cnt((size_t)(s * s));
    const int64_t nxy = 2 * half_xy;
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= num_scans) return;
      const float* pts = points + i * max_points * 4;
      const int64_t n = n_real[i] < max_points ? n_real[i] : max_points;
      vids.clear();
      const float max_r2 = max_range * max_range;
      for (int64_t p = 0; p < n; ++p) {
        const float x = pts[p * 4 + 0], y = pts[p * 4 + 1],
                    z = pts[p * 4 + 2];
        if (x * x + y * y + z * z > max_r2) continue;
        const int32_t gx = round_half_away(x / res);
        const int32_t gy = round_half_away(y / res);
        const int32_t gz = round_half_away(z / res);
        if (gz < (int32_t)z_lo || gz - (int32_t)z_lo >= (int32_t)nz)
          continue;
        // offsets keep ids positive, as on the device
        const int64_t vid =
            (((int64_t)(gx + half_xy)) * nxy + (gy + half_xy)) * nz +
            (gz - z_lo);
        vids.push_back(vid);
      }
      std::sort(vids.begin(), vids.end());
      vids.erase(std::unique(vids.begin(), vids.end()), vids.end());
      // distinct cells back to (x, y) grid coords; bbox
      cx.clear();
      cy.clear();
      int32_t min_x = INT32_MAX, min_y = INT32_MAX;
      int32_t max_x = INT32_MIN, max_y = INT32_MIN;
      for (const int64_t vid : vids) {
        const int32_t gx = (int32_t)(vid / (nxy * nz)) - (int32_t)half_xy;
        const int32_t gy = (int32_t)((vid / nz) % nxy) - (int32_t)half_xy;
        // projection = round(cell·res / res) = cell (no rotation)
        cx.push_back(gx);
        cy.push_back(gy);
        min_x = gx < min_x ? gx : min_x;
        max_x = gx > max_x ? gx : max_x;
        min_y = gy < min_y ? gy : min_y;
        max_y = gy > max_y ? gy : max_y;
      }
      float* img = image_out + i * s * s;
      std::fill(img, img + s * s, free_value);
      if (vids.empty()) {
        origin_out[i * 2 + 0] = 0.0f;
        origin_out[i * 2 + 1] = 0.0f;
        nocc_out[i] = 0;
        continue;
      }
      const int64_t w_x = (int64_t)max_x - min_x + 1;
      const int64_t w_y = (int64_t)max_y - min_y + 1;
      const int64_t sh_x = w_x <= s ? (s - w_x) / 2 : -((w_x - s) / 2);
      const int64_t sh_y = w_y <= s ? (s - w_y) / 2 : -((w_y - s) / 2);
      const int64_t off_x = sh_x - min_x;
      const int64_t off_y = sh_y - min_y;
      std::fill(cnt.begin(), cnt.end(), (uint16_t)0);
      for (size_t k = 0; k < cx.size(); ++k) {
        const int64_t col = cx[k] + off_x;
        const int64_t row = cy[k] + off_y;
        if (col < 0 || col >= s || row < 0 || row >= s) continue;
        ++cnt[(size_t)(row * s + col)];
      }
      int32_t nocc = 0;
      for (int64_t px = 0; px < s * s; ++px) {
        if ((float)cnt[(size_t)px] * hit_prob > max_prob) {
          img[px] = occupied_value;
          ++nocc;
        }
      }
      origin_out[i * 2 + 0] = (float)(-off_x) * res;
      origin_out[i * 2 + 1] = (float)(-off_y) * res;
      nocc_out[i] = nocc;
    }
  });
  return 0;
}

// ---------------------------------------------------------------------------
// File loaders. paths: B C-strings; fmt: 0 = KITTI, 1 = nuScenes, 2 = NCLT.
// counts_out (B,) receives the points decoded per file, or -1 where a file
// could not be read; each returns 0 when every file decoded, 1 otherwise.

// Decode files into points_out (B, max_points, 4), pre-zeroed by the caller.
int load_scan_batch(const char** paths, int64_t num_files, int fmt,
                    float* points_out, int64_t max_points, int64_t* counts_out,
                    int num_threads) {
  std::atomic<int> failed(0);
  for_each_scan(num_files, num_threads, [&](std::atomic<int64_t>& next) {
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= num_files) return;
      const int64_t n = decode_file(paths[i], fmt,
                                    points_out + i * max_points * 4,
                                    max_points);
      counts_out[i] = n;
      if (n < 0) failed.store(1);
    }
  });
  return failed.load();
}

// Decode each file, give each row its pillar id with the voxelizer's
// semantics (trunc-toward-zero binning; padding and out-of-bounds rows
// alias to pillar 0), stable-sort the rows by id and emit per-pillar start
// offsets. Outputs: points_out (B, M, 4) sorted, valid_out (B, M) 1.0 for a
// decoded row, ids_out (B, M), starts_out (B, V + 1), V = nx * ny * nz.
int load_scan_batch_pillar_sorted(
    const char** paths, int64_t num_files, int fmt,
    float xmin, float xstep, int64_t nx,
    float ymin, float ystep, int64_t ny,
    float zmin, float zstep, int64_t nz,
    float* points_out, float* valid_out, int32_t* ids_out,
    int32_t* starts_out, int64_t* counts_out,
    int64_t max_points, int num_threads) {
  const int64_t v = nx * ny * nz;
  std::atomic<int> failed(0);
  for_each_scan(num_files, num_threads, [&](std::atomic<int64_t>& next) {
    std::vector<float> pts(max_points * 4);
    std::vector<int32_t> ids(max_points);
    std::vector<int32_t> order(max_points);
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= num_files) return;
      std::fill(pts.begin(), pts.end(), 0.0f);
      const int64_t n = decode_file(paths[i], fmt, pts.data(), max_points);
      counts_out[i] = n;
      if (n < 0) {
        failed.store(1);
        continue;
      }
      for (int64_t p = 0; p < max_points; ++p) {
        if (p >= n) {  // padding -> pillar 0
          ids[p] = 0;
          continue;
        }
        // trunc toward zero, matching torch .int()
        const float fx = (pts[p * 4 + 0] - xmin) / xstep;
        const float fy = (pts[p * 4 + 1] - ymin) / ystep;
        const float fz = (pts[p * 4 + 2] - zmin) / zstep;
        const int64_t cx = (int64_t)fx, cy = (int64_t)fy, cz = (int64_t)fz;
        const bool oob = cx < 0 || cx >= nx || cy < 0 || cy >= ny ||
                         cz < 0 || cz >= nz;
        ids[p] = oob ? 0 : (int32_t)(cx * ny * nz + cy * nz + cz);
      }
      for (int64_t p = 0; p < max_points; ++p) order[p] = (int32_t)p;
      std::stable_sort(order.begin(), order.end(),
                       [&](int32_t a, int32_t b) { return ids[a] < ids[b]; });
      float* po = points_out + i * max_points * 4;
      float* vo = valid_out + i * max_points;
      int32_t* io = ids_out + i * max_points;
      for (int64_t p = 0; p < max_points; ++p) {
        const int32_t src = order[p];
        std::memcpy(po + p * 4, &pts[src * 4], 4 * sizeof(float));
        vo[p] = src < n ? 1.0f : 0.0f;
        io[p] = ids[src];
      }
      // per-pillar start offsets (searchsorted-left over the sorted ids)
      int32_t* so = starts_out + i * (v + 1);
      int64_t p = 0;
      for (int64_t cell = 0; cell <= v; ++cell) {
        while (p < max_points && io[p] < cell) ++p;
        so[cell] = (int32_t)p;
      }
    }
  });
  return failed.load();
}

// Pillar statistics over already-decoded padded scans, rows left in their
// order (voxel_stats_one). points: (B, in_rows, 4). Outputs pre-zeroed by
// the caller: points_out (B, M, 4), valid_out (B, M), ids_out (B, M),
// counts_out (B, V), centroids_out (B, V, 3), M = max_points.
int compute_voxel_stats(
    const float* points, const int64_t* n_real, int64_t num_scans,
    int64_t in_rows,
    float xmin, float xstep, int64_t nx,
    float ymin, float ystep, int64_t ny,
    float zmin, float zstep, int64_t nz,
    int crop,
    float* points_out, float* valid_out, int32_t* ids_out,
    float* counts_out, float* centroids_out,
    int64_t max_points, int num_threads) {
  const int64_t v = nx * ny * nz;
  for_each_scan(num_scans, num_threads, [&](std::atomic<int64_t>& next) {
    int64_t valid0 = 0;
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= num_scans) return;
      voxel_stats_one(
          points + i * in_rows * 4, n_real[i],
          xmin, xstep, nx, ymin, ystep, ny, zmin, zstep, nz, crop,
          points_out + i * max_points * 4, valid_out + i * max_points,
          ids_out + i * max_points, counts_out + i * v,
          centroids_out + i * v * 3, max_points, &valid0);
    }
  });
  return 0;
}

// Decode files and compute their pillar statistics in one threaded pass,
// with compute_voxel_stats's outputs. A file may hold up to 4 x max_points
// rows before the crop (the rest are not read).
int load_scan_batch_voxel_stats(
    const char** paths, int64_t num_files, int fmt,
    float xmin, float xstep, int64_t nx,
    float ymin, float ystep, int64_t ny,
    float zmin, float zstep, int64_t nz,
    int crop,
    float* points_out, float* valid_out, int32_t* ids_out,
    float* counts_out, float* centroids_out, int64_t* decoded_out,
    int64_t max_points, int num_threads) {
  const int64_t v = nx * ny * nz;
  std::atomic<int> failed(0);
  for_each_scan(num_files, num_threads, [&](std::atomic<int64_t>& next) {
    const int64_t scratch_rows = max_points * 4;
    std::vector<float> pts(scratch_rows * 4);
    int64_t valid0 = 0;
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= num_files) return;
      std::fill(pts.begin(), pts.end(), 0.0f);
      const int64_t n = decode_file(paths[i], fmt, pts.data(), scratch_rows);
      decoded_out[i] = n;
      if (n < 0) {
        failed.store(1);
        continue;
      }
      voxel_stats_one(
          pts.data(), n,
          xmin, xstep, nx, ymin, ystep, ny, zmin, zstep, nz, crop,
          points_out + i * max_points * 4, valid_out + i * max_points,
          ids_out + i * max_points, counts_out + i * v,
          centroids_out + i * v * 3, max_points, &valid0);
    }
  });
  return failed.load();
}

}  // extern "C"
