// Unsorted pillar binning (segment sums by id) for Hopper (sm_90a), v3: the
// same bits on every launch.
//
// Replaces the TPU kernel gloc3d_tpu/ops/pallas_scatter.py::pillar_bin_sums
// (with its batched wrapper pillar_bin_mean). That kernel builds a bf16
// one-hot (chunk, V) matrix per chunk of rows and accumulates
// one_hot^T @ [features | 1] in a VMEM accumulator over a sequential grid.
// Hopper blocks run in no order and carry nothing between them, and the
// semantics to hold are the fp32 sums of the XLA scatter the JAX serving path
// runs, so this kernel scatters directly:
//   sums[b, ids[b, i], :] += features[b, i, :];  counts[b, ids[b, i]] += 1
// Counts include every row: padding and out-of-grid rows carry id 0. Empty
// pillars are exactly 0. Rows whose id lies outside [0, V) are skipped (the
// wrapper rejects them first). A non-finite value gives its pillar's sum what
// a sum in any order gives: NaN if any row is NaN or both infinities occur,
// else the infinity that occurs (the XLA scatter's result; the one-hot
// product of the TPU kernel would spread 0 · inf = NaN to every pillar).
//
// Bound on the card: memory. At the main-path shape (N = 122 480, V =
// 11 200) one scan's feature binning (C = 64) reads 31.4 MB of features and
// 0.5 MB of ids and writes 2.9 MB: ~10 µs at 3.35 TB/s; its statistics
// binning (C = 4) moves 2.7 MB: ~0.8 µs, so it is bound by launch and a few
// round trips to memory.
//
// Determinism. v2 added every pillar but pillar 0 with float atomics, whose
// order changes between launches, so two extractions of one scan differed in
// their last bits and near-tied keyframes swapped ranks. Two routes give the
// same bits every time: a stable counting sort by pillar followed by sums in
// row order (a per-chunk count table over all V pillars and its scan, then a
// scatter of the rows: three passes and a table of chunks x V counts), or
// exact integer sums, whose order does not matter. v3 takes the integer
// route: it keeps v2's row walk and adds one more read of the features.
//  1. Keys: for each (item, pillar p >= 1, channel) one uint32 key, the
//     largest biased exponent e of a finite |x| over the pillar's rows by
//     atomicMax, with flags for NaN, +inf and -inf above it by atomicOr (a
//     max after a flag leaves the flag, a flag after a max keeps both); the
//     row count by an int atomicAdd. A key is read before its atomics,
//     which are skipped where they would not change it (most rows of a
//     pillar share their exponents). Pillar 0's per-block fp32 partials are
//     stored here, as in v2.
//  2. Sums: every row of pillar p >= 1 adds llrint(x * 2^s) into an int64
//     accumulator, where |x| < 2^t, t = max(e, 1) - 126, and s = 62 - lg - t
//     with N <= 2^lg: each term is below 2^(62 - lg), so N of them cannot
//     overflow. A pillar-channel holding a flag adds nothing.
//  3. Finish: each sum is acc * 2^-s rounded once to fp32 (or the flags'
//     NaN / inf), each count the int count; pillar 0 is added from the
//     partials in a fixed order by pillar_bin_sums_pillar0, as in v2.
// The scale is per pillar and channel, not per channel of the whole call: the
// quantum 2^-s is 2^(lg - 61) of the pillar-channel's largest |x| (2^-44 at
// N = 122 480), so the error relative to that pillar's L1 mass is at most
// count * 2^(lg - 61), whatever the values of the other pillars. A scale
// per channel would put the quantum at 2^-44 of the channel's largest value
// over the whole scan, and a pillar whose values all lie below ~1e-8 of that
// would miss the 1e-5 the kernel is held to. The price is a key atomic per
// run of equal ids and a key read per run.
//
// Row walk, as v2 (pass 1 and pass 2 alike):
//  - Narrow (C <= 8, the statistics launch): about two blocks per SM, each
//    over a long chunk. Lanes over rows, each row one 16-byte load where
//    C = 4 (scalar loads otherwise), UNROLL rows per thread in flight, one
//    atomic per row and channel.
//  - Wide (C > 8, the 64-channel feature launch): a block per 256 rows; each
//    warp walks 32 contiguous rows, the whole warp on one row at a time with
//    lanes over channels in vectors of VW floats (2 at C = 64: one 8-byte
//    load per lane), U rows loaded before they are added. A warp merges the
//    rows of a run of equal ids in registers (exponent max and flags, or
//    the integer sum) and flushes each run with one atomic per channel.
//  - Pillar 0 (every padding and out-of-grid row, ~82 000 of 122 480 on a
//    70 m scan, spread through the scan) never takes an atomic: in pass 1
//    each block sums its pillar-0 rows in registers in a fixed order, adds
//    its warps in a fixed order and stores the partial (C sums and a count)
//    in the scratch; pillar_bin_sums_pillar0 adds every item's partials in a
//    fixed order (a warp per column) and writes pillar 0.
//
// C interface, loaded with ctypes: zeroes the scratch's accumulators with
// one cudaMemsetAsync, launches the four kernels on the given stream,
// returns cudaGetLastError(). It does not synchronise and allocates nothing;
// the caller passes gloc3d_pillar_bin_sums_scratch_bytes(b, n, v, c) bytes
// of scratch on the current device (12 per output sum: the int64
// accumulators and the keys; 4 per pillar; the pillar-0 partials).

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
// key flags, above every biased exponent (< 256)
constexpr unsigned POS_INF = 1u << 29;
constexpr unsigned NEG_INF = 1u << 30;
constexpr unsigned NAN_SEEN = 1u << 31;
constexpr unsigned FLAGS = POS_INF | NEG_INF | NAN_SEEN;

struct Args {
  const float* feats;
  const int* ids;
  float* sums;
  float* counts;
  unsigned long long* acc;  // (B, V, C) int64 sums, two's complement
  unsigned* keys;           // (B, V, C)
  int* cnt;                 // (B, V)
  float* part;              // pillar-0 partials, (B, C + 1, chunks)
  int64_t b;
  int n, v, c, lg, chunks, rows_per_chunk;
};

// ----------------------------------------------------------- the integers
// A finite value's biased exponent (|x| < 2^(max(e, 1) - 126)), else 0.
__device__ __forceinline__ unsigned exponent_of(float x) {
  const unsigned bits = __float_as_uint(x) & 0x7fffffffu;
  return bits < 0x7f800000u ? bits >> 23 : 0u;
}

// A non-finite value's flag, else 0.
__device__ __forceinline__ unsigned flag_of(float x) {
  const unsigned bits = __float_as_uint(x) & 0x7fffffffu;
  if (bits < 0x7f800000u) return 0u;
  if (bits > 0x7f800000u) return NAN_SEEN;
  return x > 0.f ? POS_INF : NEG_INF;
}

// 2^s as a double (|s| < 1023).
__device__ __forceinline__ double pow2(int s) {
  return __longlong_as_double(static_cast<long long>(1023 + s) << 52);
}

// s of a key without flags: 2^(t + s) = 2^(62 - lg), t = max(e, 1) - 126.
__device__ __forceinline__ int scale_exp(unsigned key, int lg) {
  return 62 - lg - (max(static_cast<int>(key), 1) - 126);
}

// The multiplier of a pillar-channel's values in pass 2; 0 where the
// pillar-channel holds a non-finite value (the finish writes it from the
// flags).
__device__ __forceinline__ double scale_of(unsigned key, int lg) {
  return (key & FLAGS) ? 0.0 : pow2(scale_exp(key, lg));
}

// Keys only grow (max, or), so a value read here is at most the key's
// value: the atomics are skipped only where they would change nothing.
__device__ __forceinline__ void flush_key(unsigned* k, unsigned e,
                                          unsigned f) {
  if (!e && !f) return;
  const unsigned seen = __ldcg(k);
  if (f & ~seen) atomicOr(k, f);
  if (e > seen) atomicMax(k, e);
}

__device__ __forceinline__ void add_term(unsigned long long* p, float x,
                                         double scale) {
  if (scale == 0.0) return;
  const long long q = __double2ll_rn(static_cast<double>(x) * scale);
  if (q) atomicAdd(p, static_cast<unsigned long long>(q));
}

// ------------------------------------------------------------- pillar 0
// Every block stores its pillar-0 partial (C sums, then the count) into
// column j of the item's (C+1, chunks) partials, part[(b (C+1) + j) chunks +
// chunk]; pillar_bin_sums_pillar0 adds them after the binning passes.
__device__ __forceinline__ void store_partial(const float* s_part,
                                              float* part, int64_t b,
                                              int chunk, int chunks, int c) {
  for (int t = threadIdx.x; t <= c; t += NT)
    part[(b * (c + 1) + t) * chunks + chunk] = s_part[t];
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

// One warp per (item, column j <= C): its lanes add the item's partials of
// column j in a fixed order (lane l takes chunks l, l + 32, ..., then a
// fixed shuffle tree) and lane 0 writes pillar 0's sum j (or its count).
__global__ void __launch_bounds__(NT) pillar_bin_sums_pillar0(const Args a) {
  const int lane = threadIdx.x & 31;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * NW + (threadIdx.x >> 5);
  if (w >= a.b * (a.c + 1)) return;  // warp-uniform
  const int64_t item = w / (a.c + 1);
  const int j = static_cast<int>(w % (a.c + 1));
  const float* p = a.part + w * a.chunks;
  float s = 0.f;
  int k = lane;
  for (; k + 32 * (FIN_LOADS - 1) < a.chunks; k += 32 * FIN_LOADS) {
    float q[FIN_LOADS];
#pragma unroll
    for (int u = 0; u < FIN_LOADS; ++u) q[u] = p[k + 32 * u];
#pragma unroll
    for (int u = 0; u < FIN_LOADS; ++u) s += q[u];
  }
  for (; k < a.chunks; k += 32) s += p[k];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  if (lane == 0) {
    if (j < a.c) a.sums[item * a.v * a.c + j] = s;
    else a.counts[item * a.v] = s;
  }
}

// ---------------------------------------------------------------- finish
// A warp per (item, pillar p >= 1), lanes over channels: the int64 sums
// rounded once to fp32 (or the flags' value), the count.
__global__ void __launch_bounds__(NT) pillar_bin_sums_finish(const Args a) {
  const int lane = threadIdx.x & 31;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * NW + (threadIdx.x >> 5);
  if (w >= a.b * a.v || w % a.v == 0) return;  // pillar 0: see above
  for (int j = lane; j < a.c; j += 32) {
    const int64_t i = w * a.c + j;
    const unsigned key = a.keys[i];
    float s;
    if ((key & NAN_SEEN) || ((key & POS_INF) && (key & NEG_INF)))
      s = __int_as_float(0x7fc00000);
    else if (key & POS_INF)
      s = __int_as_float(0x7f800000);
    else if (key & NEG_INF)
      s = __int_as_float(static_cast<int>(0xff800000u));
    else
      s = __double2float_rn(__ll2double_rn(static_cast<long long>(a.acc[i])) *
                            pow2(-scale_exp(key, a.lg)));
    a.sums[i] = s;
  }
  if (lane == 0) a.counts[w] = static_cast<float>(a.cnt[w]);
}

// --------------------------------------------------------------- loads
// VW consecutive floats at p (aligned to VW floats).
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

// --------------------------------------------------------------- narrow
// SUMS = false: pass 1 (keys, counts, pillar-0 partials); true: pass 2.
template <int C, bool SUMS>
__global__ void __launch_bounds__(NT)
pillar_bin_sums_narrow(const Args a, int vec16) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunk = static_cast<int>(blockIdx.x % a.chunks);
  const int64_t b = blockIdx.x / a.chunks;
  const float* x = a.feats + b * static_cast<int64_t>(a.n) * C;
  const int* id = a.ids + b * static_cast<int64_t>(a.n);
  const int64_t pb = b * a.v;  // the item's first pillar
  const int r0 = chunk * a.rows_per_chunk;
  const int r1 = min(a.n, r0 + a.rows_per_chunk);

  float acc0[C];
#pragma unroll
  for (int j = 0; j < C; ++j) acc0[j] = 0.f;
  float cnt0 = 0.f;

  for (int base = r0; base < r1; base += UNROLL * NT) {
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
      const int k = key[u];
      if (k == 0) {  // pillar 0: registers, a fixed order
        if constexpr (!SUMS) {
#pragma unroll
          for (int j = 0; j < C; ++j) acc0[j] += val[u][j];
          cnt0 += 1.f;
        }
        continue;
      }
      if (k < 0 || k >= a.v) continue;
      const int64_t o = (pb + k) * C;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        if constexpr (SUMS)
          add_term(a.acc + o + j, val[u][j], scale_of(a.keys[o + j], a.lg));
        else
          flush_key(a.keys + o + j, exponent_of(val[u][j]),
                    flag_of(val[u][j]));
      }
      if constexpr (!SUMS) atomicAdd(a.cnt + pb + k, 1);
    }
  }

  if constexpr (!SUMS) {
    // pillar 0 across the block: a shuffle tree per warp, warps in order
    __shared__ float s_red[NW][C + 1];
    __shared__ float s_part[C + 1];
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
    store_partial(s_part, a.part, b, chunk, a.chunks, C);
  }
}

// ----------------------------------------------------------------- wide
// Lane l holds the channels [VW (l + 32 k), VW (l + 32 k) + VW) for k < PER;
// U rows in flight per warp (16 took more registers and was slower at
// batch 1 on an H100, v2).
template <int VW, int PER, bool SUMS>
__global__ void __launch_bounds__(NT) pillar_bin_sums_wide(const Args a) {
  constexpr int NV = VW * PER;
  constexpr int U = 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = a.c;
  const int chunk = static_cast<int>(blockIdx.x % a.chunks);
  const int64_t b = blockIdx.x / a.chunks;
  const float* x = a.feats + b * static_cast<int64_t>(a.n) * c;
  const int* id = a.ids + b * static_cast<int64_t>(a.n);
  const int64_t pb = b * a.v;
  const int r0 = chunk * a.rows_per_chunk;
  const int span = max(0, min(a.n, r0 + a.rows_per_chunk) - r0);
  const int lo = r0 + static_cast<int>(static_cast<int64_t>(span) * warp / NW);
  const int hi =
      r0 + static_cast<int>(static_cast<int64_t>(span) * (warp + 1) / NW);
  const int groups = c / VW;  // vectors per row

  float acc0[NV];
  // the current run of equal ids: pass 1 its exponents and flags, pass 2
  // its integer sums at the pillar-channel's scale
  unsigned run_e[NV], run_f[NV];
  long long run_q[NV];
  double scale[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    acc0[k] = 0.f;
    run_e[k] = run_f[k] = 0u;
    run_q[k] = 0;
    scale[k] = 0.0;
  }
  float cnt0 = 0.f;
  int run_n = 0, run_id = -1;

  auto flush = [&]() {
    const int64_t o = (pb + run_id) * c;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int g = lane + 32 * k;
      if (g >= groups) continue;
#pragma unroll
      for (int j = 0; j < VW; ++j) {
        const int i = k * VW + j;
        if constexpr (SUMS) {
          if (run_q[i])
            atomicAdd(a.acc + o + g * VW + j,
                      static_cast<unsigned long long>(run_q[i]));
        } else {
          flush_key(a.keys + o + g * VW + j, run_e[i], run_f[i]);
        }
      }
    }
    if constexpr (!SUMS) {
      if (lane == 0) atomicAdd(a.cnt + pb + run_id, run_n);
    }
  };

  auto start = [&](int rid) {
    run_id = rid;
    run_n = 0;
    const int64_t o = (pb + rid) * c;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int g = lane + 32 * k;
#pragma unroll
      for (int j = 0; j < VW; ++j) {
        const int i = k * VW + j;
        run_e[i] = run_f[i] = 0u;
        run_q[i] = 0;
        if constexpr (SUMS)
          scale[i] = g < groups ? scale_of(a.keys[o + g * VW + j], a.lg)
                                : 0.0;
      }
    }
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
      if (u >= rows || rid < 0 || rid >= a.v) continue;
      if (rid == 0) {  // pillar 0: registers, a fixed order
        if constexpr (!SUMS) {
#pragma unroll
          for (int k = 0; k < NV; ++k) acc0[k] += val[u][k];
          cnt0 += 1.f;
        }
        continue;
      }
      if (rid != run_id) {
        if (run_id > 0) flush();
        start(rid);
      }
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        if constexpr (SUMS) {
          if (scale[k] != 0.0)
            run_q[k] += __double2ll_rn(static_cast<double>(val[u][k]) *
                                       scale[k]);
        } else {
          run_e[k] = max(run_e[k], exponent_of(val[u][k]));
          run_f[k] |= flag_of(val[u][k]);
        }
      }
      ++run_n;
    }
  }
  if (run_id > 0) flush();

  if constexpr (!SUMS) {
    // pillar 0 across the block: lanes hold distinct channels, warps in order
    __shared__ float s_red[NW][MAX_C + 1];
    __shared__ float s_part[MAX_C + 1];
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
    store_partial(s_part, a.part, b, chunk, a.chunks, c);
  }
}

// --------------------------------------------------------------- launch
template <int C, bool SUMS>
cudaError_t launch_narrow(const Args& a, cudaStream_t s) {
  const int vec16 =
      (C % 4 == 0) && (reinterpret_cast<uintptr_t>(a.feats) % 16 == 0);
  pillar_bin_sums_narrow<C, SUMS>
      <<<static_cast<unsigned>(a.b * a.chunks), NT, 0, s>>>(a, vec16);
  return cudaGetLastError();
}

template <int VW, int PER, bool SUMS>
cudaError_t launch_wide(const Args& a, cudaStream_t s) {
  pillar_bin_sums_wide<VW, PER, SUMS>
      <<<static_cast<unsigned>(a.b * a.chunks), NT, 0, s>>>(a);
  return cudaGetLastError();
}

// The widest vector that divides C, fits the rows' alignment and still puts
// all 32 lanes on a row (VW · 32 <= C); PER vectors per lane.
template <bool SUMS>
cudaError_t dispatch(const Args& a, cudaStream_t s) {
  static_assert(NARROW_MAX_C == 8, "one narrow case per C <= NARROW_MAX_C");
  switch (a.c) {
    case 1: return launch_narrow<1, SUMS>(a, s);
    case 2: return launch_narrow<2, SUMS>(a, s);
    case 3: return launch_narrow<3, SUMS>(a, s);
    case 4: return launch_narrow<4, SUMS>(a, s);
    case 5: return launch_narrow<5, SUMS>(a, s);
    case 6: return launch_narrow<6, SUMS>(a, s);
    case 7: return launch_narrow<7, SUMS>(a, s);
    case 8: return launch_narrow<8, SUMS>(a, s);
    default: break;
  }
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a.feats);
  if (a.c % 4 == 0 && addr % 16 == 0 && a.c >= 128)
    return a.c <= 128 ? launch_wide<4, 1, SUMS>(a, s)
                      : launch_wide<4, 2, SUMS>(a, s);
  if (a.c % 2 == 0 && addr % 8 == 0 && a.c >= 64) {
    switch ((a.c + 63) / 64) {
      case 1: return launch_wide<2, 1, SUMS>(a, s);
      case 2: return launch_wide<2, 2, SUMS>(a, s);
      case 3: return launch_wide<2, 3, SUMS>(a, s);
      default: return launch_wide<2, 4, SUMS>(a, s);
    }
  }
  switch ((a.c + 31) / 32) {
    case 1: return launch_wide<1, 1, SUMS>(a, s);
    case 2: return launch_wide<1, 2, SUMS>(a, s);
    case 3: return launch_wide<1, 3, SUMS>(a, s);
    case 4: return launch_wide<1, 4, SUMS>(a, s);
    case 5: return launch_wide<1, 5, SUMS>(a, s);
    case 6: return launch_wide<1, 6, SUMS>(a, s);
    case 7: return launch_wide<1, 7, SUMS>(a, s);
    default: return launch_wide<1, 8, SUMS>(a, s);
  }
}

// Blocks per batch item of n rows. Narrow: NARROW_BLOCKS_PER_SM per SM of
// the current device over the batch, and at least one. Wide: one per
// WIDE_TILE_ROWS rows, which the block scheduler balances over the SMs.
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

// Byte offsets into the scratch: the int64 accumulators, the keys, the
// counts (zeroed, [0, zeroed)), then the pillar-0 partials.
struct Layout {
  int64_t keys, cnt, part, total;
};

Layout layout(int64_t b, int64_t v, int64_t c, int64_t chunks) {
  Layout l;
  l.keys = 8 * b * v * c;
  l.cnt = l.keys + 4 * b * v * c;
  l.part = l.cnt + 4 * b * v;
  l.total = l.part + 4 * b * (c + 1) * chunks;
  return l;
}

}  // namespace

// Bytes of scratch a call with these sizes needs on the current device, or
// -1 when the device cannot be read.
extern "C" int64_t gloc3d_pillar_bin_sums_scratch_bytes(int64_t b, int64_t n,
                                                        int64_t v,
                                                        int64_t c) {
  int64_t chunks = 0;
  if (b <= 0) return 0;
  if (chunks_per_item(b, n, c, &chunks) != cudaSuccess) return -1;
  return layout(b, v, c, chunks).total;
}

extern "C" int gloc3d_pillar_bin_sums(const float* feats, const int* ids,
                                      float* sums, float* counts,
                                      void* scratch, int64_t b, int64_t n,
                                      int64_t v, int64_t c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0) return static_cast<int>(cudaSuccess);
  int64_t chunks = 0;
  cudaError_t e = chunks_per_item(b, n, c, &chunks);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n > 0x7fffffff || v > 0x7fffffff || v < 1 || c < 1 || c > MAX_C ||
      b * chunks > 0x7fffffff || b * (c + 1) > 0x7fffffffLL * NW ||
      b * v > 0x7fffffffLL * NW)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) {
    e = cudaMemsetAsync(sums, 0, sizeof(float) * b * v * c, s);
    if (e == cudaSuccess)
      e = cudaMemsetAsync(counts, 0, sizeof(float) * b * v, s);
    return static_cast<int>(e);
  }
  const Layout l = layout(b, v, c, chunks);
  char* base = static_cast<char*>(scratch);
  e = cudaMemsetAsync(base, 0, l.part, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  int lg = 0;
  while ((int64_t{1} << lg) < n) ++lg;  // n <= 2^lg
  const int ni = static_cast<int>(n);
  const int ch = static_cast<int>(chunks);
  const Args a{feats,
               ids,
               sums,
               counts,
               reinterpret_cast<unsigned long long*>(base),
               reinterpret_cast<unsigned*>(base + l.keys),
               reinterpret_cast<int*>(base + l.cnt),
               reinterpret_cast<float*>(base + l.part),
               b,
               ni,
               static_cast<int>(v),
               static_cast<int>(c),
               lg,
               ch,
               (ni + ch - 1) / ch};
  e = dispatch<false>(a, s);
  if (e == cudaSuccess) e = dispatch<true>(a, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  pillar_bin_sums_finish<<<static_cast<unsigned>((b * v + NW - 1) / NW), NT,
                           0, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  pillar_bin_sums_pillar0<<<static_cast<unsigned>((b * (c + 1) + NW - 1) /
                                                  NW),
                            NT, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
