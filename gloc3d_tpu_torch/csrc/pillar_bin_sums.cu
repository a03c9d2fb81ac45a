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
// Counts include every row: padding and out-of-grid rows carry id 0. Empty
// pillars stay exactly 0. Rows whose id lies outside [0, V) are skipped (the
// wrapper rejects them first). (The one-hot product on tensor cores would be
// 2·V·N·(C+1) ≈ 0.18 TFLOP per scan, ~0.18 ms at the bf16 peak, against a
// ~10 µs memory bound.)
//
// Bound on the card: memory. At the main-path shape (N = 122 480, V =
// 11 200) one scan's feature binning (C = 64) reads 31.4 MB of features and
// 0.5 MB of ids and writes 2.9 MB: ~10 µs at 3.35 TB/s; its statistics
// binning (C = 4) moves 2.7 MB: ~0.8 µs, so it is bound by launch and a few
// round trips to memory. Two things cost time beyond the bytes: pillar 0,
// which holds every padding and out-of-grid row (~82 000 of 122 480 on a
// 70 m scan, spread through the scan), and the atomics of the other rows
// (runs of equal ids are short in scan order, so nearly every such row is
// one atomic add of C floats and one of its count).
//
// Design: blocks of NT threads, each over a contiguous chunk of an item's
// rows (chunks_per_item), and a second, small kernel for pillar 0.
//  - Pillar 0 without same-address atomics and the same on every run: each
//    block sums its pillar-0 rows in registers in a fixed order, adds its
//    warps in a fixed order and stores the partial (C sums and a count) in
//    the caller's scratch; pillar_bin_sums_pillar0, launched next on the
//    stream, adds every item's partials in a fixed order (a warp per
//    column) and writes pillar 0. (A "last block adds the partials" finish
//    inside the binning kernel, an atomic ticket after a __threadfence, was
//    slower on an H100, most at batch 24: each block's fence waits for its
//    own atomics to drain before the block can retire.)
//  - Narrow (C <= 8, the statistics launch): about two blocks per SM, each
//    over a long chunk. Lanes over rows, each row one 16-byte load where
//    C = 4 (scalar loads otherwise), UNROLL rows per thread in flight.
//    Lanes holding the same id are grouped with __match_any_sync; the
//    group's lowest lane gathers the others' rows by shuffles and issues one
//    vector atomic (float4 / float2 atomicAdd on global memory, compute
//    capability 9.x) and one count atomic per distinct id.
//  - Wide (C > 8, the 64-channel feature launch): a block per 256 rows,
//    balanced over the SMs by the block scheduler; each warp walks 32
//    contiguous rows, the whole warp on one row at a time with lanes over
//    channels in vectors of VW floats (2 at C = 64: one 8-byte load per
//    lane, 256 contiguous bytes per warp), U rows loaded before they are
//    summed. A warp sums rows while the id repeats and flushes each run
//    with one VW-wide atomicAdd per lane and one count atomic. (Streaming
//    the rows through shared memory with 1-D bulk copies, a ring of four
//    16 KB stages per block, was slower at both batch 1 and 24 on an H100;
//    so was a persistent grid of a few long chunks per SM.)
//
// C interface, loaded with ctypes: zeroes the outputs with cudaMemsetAsync,
// launches both kernels on the given stream, returns cudaGetLastError(). It
// does not synchronise and allocates nothing; the caller passes the
// scratch, gloc3d_pillar_bin_sums_scratch_floats(b, n, c) floats on the
// current device.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int NT = 256;  // threads per block
constexpr int NW = NT / 32;
constexpr int MAX_C = 256;
constexpr int NARROW_MAX_C = 8;  // the narrow kernel takes C <= 8
constexpr int UNROLL = 4;     // narrow: rows per thread in flight
constexpr int NARROW_BLOCKS_PER_SM = 2;
constexpr int WIDE_TILE_ROWS = 256;
constexpr int FIN_LOADS = 8;  // pillar-0 sum: loads in flight per lane
constexpr unsigned FULL = 0xffffffffu;

// ------------------------------------------------------------- pillar 0
// Every block stores its pillar-0 partial (C sums, then the count) into
// column j of the item's (C+1, chunks) partials, part[(b (C+1) + j) chunks +
// chunk]; pillar_bin_sums_pillar0 adds them after the binning kernel.
__device__ __forceinline__ void store_partial(const float* s_part,
                                              float* part, int64_t b,
                                              int chunk, int chunks, int c) {
  for (int t = threadIdx.x; t <= c; t += NT)
    part[(b * (c + 1) + t) * chunks + chunk] = s_part[t];
}

// One warp per (item, column j <= C): its lanes add the item's partials of
// column j in a fixed order (lane l takes chunks l, l + 32, ..., then a
// fixed shuffle tree) and lane 0 writes pillar 0's sum j (or its count).
__global__ void __launch_bounds__(NT)
pillar_bin_sums_pillar0(const float* __restrict__ part,
                        float* __restrict__ sums, float* __restrict__ counts,
                        int64_t b, int v, int c, int chunks) {
  const int lane = threadIdx.x & 31;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * NW + (threadIdx.x >> 5);
  if (w >= b * (c + 1)) return;  // warp-uniform
  const int64_t item = w / (c + 1);
  const int j = static_cast<int>(w % (c + 1));
  const float* p = part + w * chunks;
  float s = 0.f;
  int k = lane;
  for (; k + 32 * (FIN_LOADS - 1) < chunks; k += 32 * FIN_LOADS) {
    float q[FIN_LOADS];
#pragma unroll
    for (int u = 0; u < FIN_LOADS; ++u) q[u] = p[k + 32 * u];
#pragma unroll
    for (int u = 0; u < FIN_LOADS; ++u) s += q[u];
  }
  for (; k < chunks; k += 32) s += p[k];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  if (lane == 0) {
    if (j < c) sums[item * v * c + j] = s;
    else counts[item * v] = s;
  }
}

// VW consecutive floats at p (aligned to VW floats): load, add atomically.
template <int VW>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (VW == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (VW == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VW>
__device__ __forceinline__ void atomic_add_vec(float* p, const float* v) {
  if constexpr (VW == 4)
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  else if constexpr (VW == 2)
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  else
    atomicAdd(p, v[0]);
}

// dst[0 .. C) += v with the widest atomics C allows (the sums row of pillar
// p starts at p·C floats of a 16-byte aligned tensor).
template <int C>
__device__ __forceinline__ void atomic_add_row(float* dst, const float* v) {
  constexpr int VW = C % 4 == 0 ? 4 : C % 2 == 0 ? 2 : 1;
#pragma unroll
  for (int j = 0; j < C; j += VW) atomic_add_vec<VW>(dst + j, v + j);
}

// The block's pillar-0 sums: s_red[w][0 .. c] holds warp w's (C sums, then
// the count); add the warps in order into s_part.
__device__ __forceinline__ void add_warps(const float* s_red, int stride,
                                          float* s_part, int c) {
  __syncthreads();
  for (int t = threadIdx.x; t <= c; t += NT) {
    float tot = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) tot += s_red[w * stride + t];
    s_part[t] = tot;
  }
  __syncthreads();
}

// --------------------------------------------------------------- narrow
template <int C>
__global__ void __launch_bounds__(NT)
pillar_bin_sums_narrow(const float* __restrict__ feats,
                       const int* __restrict__ ids, float* __restrict__ sums,
                       float* __restrict__ counts, float* __restrict__ part,
                       int n, int v, int chunks, int rows_per_chunk,
                       int vec16) {
  __shared__ float s_red[NW][C + 1];
  __shared__ float s_part[C + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunk = static_cast<int>(blockIdx.x % chunks);
  const int64_t b = blockIdx.x / chunks;
  const float* x = feats + b * static_cast<int64_t>(n) * C;
  const int* id = ids + b * static_cast<int64_t>(n);
  float* o = sums + b * static_cast<int64_t>(v) * C;
  float* oc = counts + b * static_cast<int64_t>(v);
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(n, r0 + rows_per_chunk);

  float acc0[C];
#pragma unroll
  for (int j = 0; j < C; ++j) acc0[j] = 0.f;
  float cnt0 = 0.f;

  for (int base = r0; base < r1; base += UNROLL * NT) {  // block-uniform
    float val[UNROLL][C];
    int key[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = base + u * NT + threadIdx.x;
      const bool ok = r < r1;
      key[u] = ok ? __ldg(id + r) : -1;
      if constexpr (C % 4 == 0) {
        if (vec16) {
#pragma unroll
          for (int j = 0; j < C; j += 4) {
            const float4 q = ok ? __ldg(reinterpret_cast<const float4*>(
                                      x + static_cast<int64_t>(r) * C + j))
                                : make_float4(0.f, 0.f, 0.f, 0.f);
            val[u][j] = q.x;
            val[u][j + 1] = q.y;
            val[u][j + 2] = q.z;
            val[u][j + 3] = q.w;
          }
          continue;
        }
      }
#pragma unroll
      for (int j = 0; j < C; ++j)
        val[u][j] = ok ? __ldg(x + static_cast<int64_t>(r) * C + j) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      int k = key[u];
      if (k == 0) {  // pillar 0: registers, a fixed order
#pragma unroll
        for (int j = 0; j < C; ++j) acc0[j] += val[u][j];
        cnt0 += 1.f;
      }
      if (k <= 0 || k >= v) k = -1;
      // every lane of the warp reaches the collectives below
      const unsigned grp = __match_any_sync(FULL, k);
      const int leader = __ffs(grp) - 1;
      const bool lead = k > 0 && lane == leader;
      unsigned pend = __ballot_sync(FULL, k > 0 && lane != leader);
      while (pend) {  // warp-uniform: one pass per repeated id
        const int src = __ffs(pend) - 1;
        pend &= pend - 1;
        const int ks = __shfl_sync(FULL, k, src);
        float vs[C];
#pragma unroll
        for (int j = 0; j < C; ++j) vs[j] = __shfl_sync(FULL, val[u][j], src);
        if (lead && ks == k) {
#pragma unroll
          for (int j = 0; j < C; ++j) val[u][j] += vs[j];
        }
      }
      if (lead) {
        atomic_add_row<C>(o + static_cast<int64_t>(k) * C, val[u]);
        atomicAdd(oc + k, static_cast<float>(__popc(grp)));
      }
    }
  }

  // pillar 0 across the block: a shuffle tree per warp, then warps in order
#pragma unroll
  for (int j = 0; j < C; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc0[j] += __shfl_xor_sync(FULL, acc0[j], off);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    cnt0 += __shfl_xor_sync(FULL, cnt0, off);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < C; ++j) s_red[warp][j] = acc0[j];
    s_red[warp][C] = cnt0;
  }
  add_warps(&s_red[0][0], C + 1, s_part, C);
  store_partial(s_part, part, b, chunk, chunks, C);
}

// ----------------------------------------------------------------- wide
// Lane l holds the channels [VW (l + 32 k), VW (l + 32 k) + VW) for k < PER;
// U rows in flight per warp (16 took more registers and was slower at
// batch 1 on an H100).
template <int VW, int PER>
__global__ void __launch_bounds__(NT)
pillar_bin_sums_wide(const float* __restrict__ feats,
                     const int* __restrict__ ids, float* __restrict__ sums,
                     float* __restrict__ counts, float* __restrict__ part,
                     int n, int v, int c, int chunks, int rows_per_chunk) {
  constexpr int NV = VW * PER;
  constexpr int U = 8;
  __shared__ float s_red[NW][MAX_C + 1];
  __shared__ float s_part[MAX_C + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunk = static_cast<int>(blockIdx.x % chunks);
  const int64_t b = blockIdx.x / chunks;
  const float* x = feats + b * static_cast<int64_t>(n) * c;
  const int* id = ids + b * static_cast<int64_t>(n);
  float* o = sums + b * static_cast<int64_t>(v) * c;
  float* oc = counts + b * static_cast<int64_t>(v);
  const int r0 = chunk * rows_per_chunk;
  const int span = max(0, min(n, r0 + rows_per_chunk) - r0);
  const int lo = r0 + static_cast<int>(static_cast<int64_t>(span) * warp / NW);
  const int hi =
      r0 + static_cast<int>(static_cast<int64_t>(span) * (warp + 1) / NW);
  const int groups = c / VW;  // vectors per row

  float acc0[NV], run[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) acc0[k] = run[k] = 0.f;
  float cnt0 = 0.f, run_cnt = 0.f;
  int run_id = -1;

  auto flush = [&]() {
    float* dst = o + static_cast<int64_t>(run_id) * c;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int g = lane + 32 * k;
      if (g < groups) atomic_add_vec<VW>(dst + g * VW, run + k * VW);
    }
    if (lane == 0) atomicAdd(oc + run_id, run_cnt);
  };

  for (int base = lo; base < hi; base += U) {  // warp-uniform
    const int rows = min(U, hi - base);
    const int my_id = lane < rows ? __ldg(id + base + lane) : -1;
    float val[U][NV];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float* row = x + static_cast<int64_t>(base + u) * c;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int g = lane + 32 * k;
        if (u < rows && g < groups) {
          load_vec<VW>(row + g * VW, val[u] + k * VW);
        } else {
#pragma unroll
          for (int j = 0; j < VW; ++j) val[u][k * VW + j] = 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      // every lane reaches the shuffle: u and rows are warp-uniform
      const int rid = __shfl_sync(FULL, my_id, u);
      if (u >= rows || rid < 0 || rid >= v) continue;
      if (rid == 0) {  // pillar 0: registers, a fixed order
#pragma unroll
        for (int k = 0; k < NV; ++k) acc0[k] += val[u][k];
        cnt0 += 1.f;
        continue;
      }
      if (rid != run_id) {
        if (run_id > 0) flush();
#pragma unroll
        for (int k = 0; k < NV; ++k) run[k] = 0.f;
        run_cnt = 0.f;
        run_id = rid;
      }
#pragma unroll
      for (int k = 0; k < NV; ++k) run[k] += val[u][k];
      run_cnt += 1.f;
    }
  }
  if (run_id > 0) flush();

  // pillar 0 across the block: lanes hold distinct channels, warps in order
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int g = lane + 32 * k;
    if (g < groups) {
#pragma unroll
      for (int j = 0; j < VW; ++j) s_red[warp][g * VW + j] = acc0[k * VW + j];
    }
  }
  if (lane == 0) s_red[warp][c] = cnt0;
  add_warps(&s_red[0][0], MAX_C + 1, s_part, c);
  store_partial(s_part, part, b, chunk, chunks, c);
}

// --------------------------------------------------------------- launch
struct Args {
  const float* feats;
  const int* ids;
  float* sums;
  float* counts;
  float* part;
  int64_t b;
  int n, v, c, chunks, rows_per_chunk;
  cudaStream_t stream;
};

template <int C>
cudaError_t launch_narrow(const Args& a) {
  const int vec16 =
      (C % 4 == 0) && (reinterpret_cast<uintptr_t>(a.feats) % 16 == 0);
  pillar_bin_sums_narrow<C>
      <<<static_cast<unsigned>(a.b * a.chunks), NT, 0, a.stream>>>(
          a.feats, a.ids, a.sums, a.counts, a.part, a.n, a.v, a.chunks,
          a.rows_per_chunk, vec16);
  return cudaGetLastError();
}

template <int VW, int PER>
cudaError_t launch_wide(const Args& a) {
  pillar_bin_sums_wide<VW, PER>
      <<<static_cast<unsigned>(a.b * a.chunks), NT, 0, a.stream>>>(
          a.feats, a.ids, a.sums, a.counts, a.part, a.n, a.v, a.c, a.chunks,
          a.rows_per_chunk);
  return cudaGetLastError();
}

// The widest vector that divides C, fits the rows' alignment and still puts
// all 32 lanes on a row (VW · 32 <= C); PER vectors per lane.
cudaError_t dispatch(const Args& a) {
  static_assert(NARROW_MAX_C == 8, "one narrow case per C <= NARROW_MAX_C");
  switch (a.c) {
    case 1: return launch_narrow<1>(a);
    case 2: return launch_narrow<2>(a);
    case 3: return launch_narrow<3>(a);
    case 4: return launch_narrow<4>(a);
    case 5: return launch_narrow<5>(a);
    case 6: return launch_narrow<6>(a);
    case 7: return launch_narrow<7>(a);
    case 8: return launch_narrow<8>(a);
    default: break;
  }
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a.feats);
  if (a.c % 4 == 0 && addr % 16 == 0 && a.c >= 128)
    return a.c <= 128 ? launch_wide<4, 1>(a) : launch_wide<4, 2>(a);
  if (a.c % 2 == 0 && addr % 8 == 0 && a.c >= 64) {
    switch ((a.c + 63) / 64) {
      case 1: return launch_wide<2, 1>(a);
      case 2: return launch_wide<2, 2>(a);
      case 3: return launch_wide<2, 3>(a);
      default: return launch_wide<2, 4>(a);
    }
  }
  switch ((a.c + 31) / 32) {
    case 1: return launch_wide<1, 1>(a);
    case 2: return launch_wide<1, 2>(a);
    case 3: return launch_wide<1, 3>(a);
    case 4: return launch_wide<1, 4>(a);
    case 5: return launch_wide<1, 5>(a);
    case 6: return launch_wide<1, 6>(a);
    case 7: return launch_wide<1, 7>(a);
    default: return launch_wide<1, 8>(a);
  }
}

// Blocks per batch item of n rows. Narrow: NARROW_BLOCKS_PER_SM per SM of
// the current device over the batch, rounded down so that no second wave
// holds a few blocks, and at least one. Wide: one per WIDE_TILE_ROWS rows,
// which the block scheduler balances over the SMs.
cudaError_t chunks_per_item(int64_t b, int64_t n, int64_t c, int64_t* chunks) {
  if (c > NARROW_MAX_C) {
    *chunks = std::max<int64_t>(1, (n + WIDE_TILE_ROWS - 1) / WIDE_TILE_ROWS);
    return cudaSuccess;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *chunks = std::max<int64_t>(1, NARROW_BLOCKS_PER_SM * sms / b);
  return e;
}

}  // namespace

// Floats of scratch a call with these sizes needs on the current device
// (the pillar-0 partials), or -1 when the device cannot be read.
extern "C" int64_t gloc3d_pillar_bin_sums_scratch_floats(int64_t b, int64_t n,
                                                         int64_t c) {
  int64_t chunks = 0;
  if (b <= 0) return 0;
  if (chunks_per_item(b, n, c, &chunks) != cudaSuccess) return -1;
  return b * (c + 1) * chunks;
}

extern "C" int gloc3d_pillar_bin_sums(const float* feats, const int* ids,
                                      float* sums, float* counts,
                                      float* scratch, int64_t b, int64_t n,
                                      int64_t v, int64_t c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0) return static_cast<int>(cudaSuccess);
  int64_t chunks = 0;
  cudaError_t e = chunks_per_item(b, n, c, &chunks);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n > 0x7fffffff || v > 0x7fffffff || c < 1 || c > MAX_C ||
      b * chunks > 0x7fffffff || b * (c + 1) > 0x7fffffffLL * NW)
    return static_cast<int>(cudaErrorInvalidValue);
  e = cudaMemsetAsync(sums, 0, sizeof(float) * b * v * c, s);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(counts, 0, sizeof(float) * b * v, s);
  if (e != cudaSuccess || n == 0) return static_cast<int>(e);
  const int ni = static_cast<int>(n);
  const int ch = static_cast<int>(chunks);
  const Args a{feats, ids, sums, counts, scratch, b, ni, static_cast<int>(v),
               static_cast<int>(c), ch, (ni + ch - 1) / ch, s};
  e = dispatch(a);
  if (e != cudaSuccess) return static_cast<int>(e);
  pillar_bin_sums_pillar0<<<static_cast<unsigned>((b * (c + 1) + NW - 1) / NW),
                            NT, 0, s>>>(scratch, sums, counts, b,
                                        static_cast<int>(v),
                                        static_cast<int>(c), ch);
  return static_cast<int>(cudaGetLastError());
}
