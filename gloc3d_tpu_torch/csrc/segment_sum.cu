// Segment sums of segment-sorted rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel gloc3d_tpu/ops/pallas_scatter.py::_cumsum_rows_128
// and its wrapper segment_sum_sorted_fast. That kernel streams a running
// column cumsum over a (N*C/128, 128) lane view, carried across a sequential
// grid, and differences it at the segment starts. Hopper blocks run in no
// fixed order and carry nothing between them, so this kernel sums the
// segments directly and needs no carry.
//
// Design: each warp owns a fixed tile of TILE_ROWS rows of one batch item.
// Lane j holds channel pairs j, j+32, ... (float2), so one row of C = 64 is a
// single coalesced 256-byte read. The warp finds the segment of its first
// row by binary search in `starts`, walks its rows adding into registers, and
// flushes at every segment boundary: a segment that lies wholly inside the
// tile is stored, the first and last segment of a tile are atomically added
// into the output (which the caller zeroed). The work per warp is bounded by
// the tile, whatever the size of one segment: pillar 0 collects every padding
// and out-of-bounds row, tens of thousands at the 122 480-row pad, and is
// split over as many warps as it spans tiles.
//
// Bound on the card: memory. The main path reads N*C*4 bytes (31 MB at
// N = 122 480, C = 64) plus `starts`, and writes V*C*4 bytes (2.9 MB at
// V = 11 200). Rows are loaded ROWS_IN_FLIGHT at a time before they are
// summed, so each lane keeps that many loads outstanding.
//
// C interface, loaded with ctypes: returns cudaGetLastError() after the
// launch. The kernel launches on the given stream, does not synchronise and
// allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_ROWS = 128;
constexpr int ROWS_IN_FLIGHT = 8;
constexpr int WARPS_PER_BLOCK = 8;

template <int PAIRS>
__device__ __forceinline__ void flush(float* __restrict__ out_row,
                                      const float2 (&acc)[PAIRS], int lane,
                                      int half_c, bool owned) {
#pragma unroll
  for (int q = 0; q < PAIRS; ++q) {
    const int p = lane + 32 * q;
    if (p < half_c) {
      float* dst = out_row + 2 * p;
      if (owned) {
        *reinterpret_cast<float2*>(dst) = acc[q];
      } else {
        atomicAdd(dst, acc[q].x);
        atomicAdd(dst + 1, acc[q].y);
      }
    }
  }
}

// PAIRS = channel pairs per lane = ceil(C / 64).
template <int PAIRS>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
segment_sum_sorted_kernel(const float* __restrict__ values,
                          const int* __restrict__ starts,
                          float* __restrict__ out, int n, int v, int c,
                          int tiles_per_item, int64_t total_tiles) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (warp >= total_tiles) return;
  const int64_t b = warp / tiles_per_item;
  const int tile = static_cast<int>(warp - b * tiles_per_item);
  const int* st = starts + b * (v + 1);
  const float* x = values + b * static_cast<int64_t>(n) * c;
  float* o = out + b * static_cast<int64_t>(v) * c;
  const int half_c = c >> 1;

  // rows outside [starts[0], starts[V]) belong to no segment
  const int lo = max(tile * TILE_ROWS, __ldg(st));
  const int hi = min(min(tile * TILE_ROWS + TILE_ROWS, n), __ldg(st + v));
  if (lo >= hi) return;

  // the segment holding row lo: st[a] <= lo < st[a + 1]
  int a = 0, z = v;
  while (z - a > 1) {
    const int m = (a + z) >> 1;
    if (__ldg(st + m) <= lo) a = m; else z = m;
  }
  int seg = a;
  int seg_lo = __ldg(st + seg);
  int seg_hi = __ldg(st + seg + 1);

  float2 acc[PAIRS];
#pragma unroll
  for (int q = 0; q < PAIRS; ++q) acc[q] = make_float2(0.f, 0.f);

  for (int r0 = lo; r0 < hi; r0 += ROWS_IN_FLIGHT) {
    float2 buf[ROWS_IN_FLIGHT][PAIRS];
#pragma unroll
    for (int u = 0; u < ROWS_IN_FLIGHT; ++u) {
      const int r = r0 + u;
#pragma unroll
      for (int q = 0; q < PAIRS; ++q) {
        const int p = lane + 32 * q;
        buf[u][q] = (r < hi && p < half_c)
            ? __ldg(reinterpret_cast<const float2*>(
                  x + static_cast<int64_t>(r) * c) + p)
            : make_float2(0.f, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < ROWS_IN_FLIGHT; ++u) {
      const int r = r0 + u;
      if (r >= hi) break;
      if (r >= seg_hi) {
        flush<PAIRS>(o + static_cast<int64_t>(seg) * c, acc, lane, half_c,
                     seg_lo >= lo && seg_hi <= hi);
#pragma unroll
        for (int q = 0; q < PAIRS; ++q) acc[q] = make_float2(0.f, 0.f);
        do {  // skip empty segments up to the one holding row r
          ++seg;
          seg_lo = seg_hi;
          seg_hi = __ldg(st + seg + 1);
        } while (seg_hi <= r);
      }
#pragma unroll
      for (int q = 0; q < PAIRS; ++q) {
        acc[q].x += buf[u][q].x;
        acc[q].y += buf[u][q].y;
      }
    }
  }
  flush<PAIRS>(o + static_cast<int64_t>(seg) * c, acc, lane, half_c,
               seg_lo >= lo && seg_hi <= hi);
}

template <int PAIRS>
cudaError_t launch(const float* values, const int* starts, float* out,
                   int64_t b, int n, int v, int c, cudaStream_t stream) {
  const int tiles_per_item = (n + TILE_ROWS - 1) / TILE_ROWS;
  const int64_t total_tiles = b * tiles_per_item;
  const int64_t blocks = (total_tiles + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  segment_sum_sorted_kernel<PAIRS>
      <<<static_cast<unsigned>(blocks), WARPS_PER_BLOCK * 32, 0, stream>>>(
          values, starts, out, n, v, c, tiles_per_item, total_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gloc3d_segment_sum_sorted(const float* values,
                                         const int* starts, float* out,
                                         int64_t b, int64_t n, int64_t v,
                                         int64_t c, void* stream) {
  if (b <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ni = static_cast<int>(n), vi = static_cast<int>(v),
            ci = static_cast<int>(c);
  switch ((ci + 63) / 64) {
    case 1: return static_cast<int>(launch<1>(values, starts, out, b, ni, vi, ci, s));
    case 2: return static_cast<int>(launch<2>(values, starts, out, b, ni, vi, ci, s));
    case 3: return static_cast<int>(launch<3>(values, starts, out, b, ni, vi, ci, s));
    case 4: return static_cast<int>(launch<4>(values, starts, out, b, ni, vi, ci, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
