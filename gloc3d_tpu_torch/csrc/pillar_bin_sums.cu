// Unsorted pillar binning (segment sums by id) for Hopper (sm_90a).
//
// Replaces the TPU kernel gloc3d_tpu/ops/pallas_scatter.py::pillar_bin_sums
// (with its batched wrapper pillar_bin_mean). That kernel builds a bf16
// one-hot (chunk, V) matrix per chunk of rows and accumulates
// one_hot^T @ [features | 1] in a VMEM accumulator over a sequential grid.
// Hopper blocks run in no order and carry nothing between them, and the
// semantics to hold are the fp32 sums of the XLA scatter the JAX serving path
// runs, so this kernel scatters fp32 sums directly:
//   sums[b, ids[b, i], :] += features[b, i, :];  counts[b, ids[b, i]] += 1
// Counts include every row: padding and out-of-grid rows carry id 0.
//
// Bound on the card: memory. At the main-path shape (N = 122 480, C = 64,
// V = 11 200) it reads 31.4 MB of features and 0.5 MB of ids and writes
// 2.9 MB: ~0.01 ms at 3.35 TB/s. What costs time instead is contention on
// pillar 0, which holds every padding and out-of-grid row (~83 000 of 122 480
// on a 70 m scan): they are spread through the scan, so per-row atomics would
// serialise ~5 M adds onto 64 addresses.
//
// Design: a warp owns 32 consecutive rows of one batch item (one id per
// lane, broadcast by shuffle) and walks them with lanes over channels, so a
// row of 64 floats is two coalesced 128-byte loads, ROWS_IN_FLIGHT rows
// loaded before they are summed.
//  - Rows of pillar 0 are summed in registers; at the end the block's warps
//    reduce them in shared memory and add them to the output once per block.
//  - Other rows are summed in registers while consecutive rows share an id
//    (a run) and flushed with one atomicAdd per channel per run: one add per
//    row in scan order, one per pillar on pillar-sorted input.
// The output is zeroed by the caller; empty pillars stay exactly 0. Rows
// whose id lies outside [0, V) are skipped (the wrapper rejects them first).
//
// C interface, loaded with ctypes: returns cudaGetLastError() after the
// launch. The kernel launches on the given stream, does not synchronise and
// allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS_PER_BLOCK = 8;
constexpr int ROWS_PER_WARP = 32;
constexpr int TILE_ROWS = WARPS_PER_BLOCK * ROWS_PER_WARP;
constexpr int ROWS_IN_FLIGHT = 8;
constexpr unsigned FULL_MASK = 0xffffffffu;

// PER = channels per lane = ceil(C / 32); lane l holds channels l + 32 k.
template <int PER>
__device__ __forceinline__ void flush_run(float* __restrict__ out_row,
                                          float* __restrict__ count,
                                          const float (&acc)[PER], float cnt,
                                          int lane, int c) {
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int ch = lane + 32 * k;
    if (ch < c) atomicAdd(out_row + ch, acc[k]);
  }
  if (lane == 0) atomicAdd(count, cnt);
}

template <int PER>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
pillar_bin_sums_kernel(const float* __restrict__ feats,
                       const int* __restrict__ ids, float* __restrict__ sums,
                       float* __restrict__ counts, int n, int v, int c,
                       int tiles_per_item) {
  __shared__ float s_acc0[WARPS_PER_BLOCK][PER * 32];
  __shared__ float s_cnt0[WARPS_PER_BLOCK];

  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int64_t b = blockIdx.x / tiles_per_item;
  const int tile = static_cast<int>(blockIdx.x - b * tiles_per_item);
  const float* x = feats + b * static_cast<int64_t>(n) * c;
  const int* id = ids + b * static_cast<int64_t>(n);
  float* o = sums + b * static_cast<int64_t>(v) * c;
  float* oc = counts + b * static_cast<int64_t>(v);

  float acc0[PER], run[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) acc0[k] = run[k] = 0.f;
  float cnt0 = 0.f, run_cnt = 0.f;
  int run_id = -1;

  const int lo = tile * TILE_ROWS + wid * ROWS_PER_WARP;
  const int rows = max(0, min(ROWS_PER_WARP, n - lo));
  const int my_id = lane < rows ? __ldg(id + lo + lane) : -1;

  for (int u0 = 0; u0 < rows; u0 += ROWS_IN_FLIGHT) {
    float buf[ROWS_IN_FLIGHT][PER];
#pragma unroll
    for (int u = 0; u < ROWS_IN_FLIGHT; ++u) {
      const int64_t r = lo + u0 + u;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int ch = lane + 32 * k;
        buf[u][k] = (u0 + u < rows && ch < c) ? __ldg(x + r * c + ch) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < ROWS_IN_FLIGHT; ++u) {
      // every lane reaches the shuffle: the row count is warp-uniform
      const int rid = __shfl_sync(FULL_MASK, my_id, (u0 + u) & 31);
      if (u0 + u >= rows || rid < 0 || rid >= v) continue;
      if (rid == 0) {
#pragma unroll
        for (int k = 0; k < PER; ++k) acc0[k] += buf[u][k];
        cnt0 += 1.f;
        continue;
      }
      if (rid != run_id) {
        if (run_id > 0)
          flush_run<PER>(o + static_cast<int64_t>(run_id) * c, oc + run_id,
                         run, run_cnt, lane, c);
#pragma unroll
        for (int k = 0; k < PER; ++k) run[k] = 0.f;
        run_cnt = 0.f;
        run_id = rid;
      }
#pragma unroll
      for (int k = 0; k < PER; ++k) run[k] += buf[u][k];
      run_cnt += 1.f;
    }
  }
  if (run_id > 0)
    flush_run<PER>(o + static_cast<int64_t>(run_id) * c, oc + run_id, run,
                   run_cnt, lane, c);

  // pillar 0: reduce the block's warps in shared memory, add once per block
#pragma unroll
  for (int k = 0; k < PER; ++k) s_acc0[wid][lane + 32 * k] = acc0[k];
  if (lane == 0) s_cnt0[wid] = cnt0;
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS_PER_BLOCK; ++w) t += s_acc0[w][ch];
    if (t != 0.f) atomicAdd(o + ch, t);
  }
  if (threadIdx.x == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS_PER_BLOCK; ++w) t += s_cnt0[w];
    if (t != 0.f) atomicAdd(oc, t);
  }
}

template <int PER>
cudaError_t launch(const float* feats, const int* ids, float* sums,
                   float* counts, int64_t b, int n, int v, int c,
                   cudaStream_t stream) {
  const int tiles_per_item = (n + TILE_ROWS - 1) / TILE_ROWS;
  const int64_t blocks = b * tiles_per_item;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  pillar_bin_sums_kernel<PER>
      <<<static_cast<unsigned>(blocks), WARPS_PER_BLOCK * 32, 0, stream>>>(
          feats, ids, sums, counts, n, v, c, tiles_per_item);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gloc3d_pillar_bin_sums(const float* feats, const int* ids,
                                      float* sums, float* counts, int64_t b,
                                      int64_t n, int64_t v, int64_t c,
                                      void* stream) {
  if (b <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ni = static_cast<int>(n), vi = static_cast<int>(v),
            ci = static_cast<int>(c);
  switch ((ci + 31) / 32) {
    case 1: return static_cast<int>(launch<1>(feats, ids, sums, counts, b, ni, vi, ci, s));
    case 2: return static_cast<int>(launch<2>(feats, ids, sums, counts, b, ni, vi, ci, s));
    case 3: return static_cast<int>(launch<3>(feats, ids, sums, counts, b, ni, vi, ci, s));
    case 4: return static_cast<int>(launch<4>(feats, ids, sums, counts, b, ni, vi, ci, s));
    case 5: return static_cast<int>(launch<5>(feats, ids, sums, counts, b, ni, vi, ci, s));
    case 6: return static_cast<int>(launch<6>(feats, ids, sums, counts, b, ni, vi, ci, s));
    case 7: return static_cast<int>(launch<7>(feats, ids, sums, counts, b, ni, vi, ci, s));
    case 8: return static_cast<int>(launch<8>(feats, ids, sums, counts, b, ni, vi, ci, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
