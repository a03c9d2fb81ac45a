// Unsorted pillar binning (segment sums by id) for Hopper (sm_90a), v4: a
// fixed order of adds, so every launch gives the same bits.
//
// Replaces the TPU kernel gloc3d_tpu/ops/pallas_scatter.py::pillar_bin_sums
// (with its batched wrapper pillar_bin_mean). That kernel builds a bf16
// one-hot (chunk, V) matrix per chunk of rows and accumulates
// one_hot^T @ [features | 1] in a VMEM accumulator over a sequential grid.
// Hopper blocks run in no order and carry nothing between them, and the
// semantics to hold are the fp32 sums of the XLA scatter the JAX serving path
// runs:
//   sums[b, ids[b, i], :] += features[b, i, :];  counts[b, ids[b, i]] += 1
// Counts include every row: padding and out-of-grid rows carry id 0. Empty
// pillars are exactly 0. Rows whose id lies outside [0, V) are left out of
// the sums and counts; the kernel counts them, and notes the first one and
// its id, in a status block the wrapper reads. A non-finite value gives its
// pillar's sum what a sum in any order gives: NaN if any row is NaN or both
// infinities occur, else the infinity that occurs (the XLA scatter's result;
// the one-hot product of the TPU kernel would spread 0 * inf = NaN to every
// pillar).
//
// Bound on the card: memory. At the main-path shape (N = 122 480, V =
// 11 200) one scan's feature binning (C = 64) reads 31.4 MB of features and
// 0.5 MB of ids and writes 2.9 MB: ~10 us at 3.35 TB/s; its statistics
// binning (C = 4) moves 2.7 MB: ~0.8 us, so it is bound by the latency of
// its dependent phases. A train step's feature binning (B = 24) moves
// 0.83 GB: ~0.25 ms.
//
// Why v3 was slow. v3 summed exact int64 integers at a per-pillar power-of-
// two scale, so the order of its atomics did not matter. That took two reads
// of the features (one for the scales, one for the sums), 12 bytes of
// memset scratch per output sum hit by scattered 64-bit atomics, a memset
// and four kernels, and a grid whose blocks depended on the batch size.
//
// v4 sorts each item's row indices by pillar, stably (a counting sort of the
// ids alone, 0.5 MB a scan), then gathers every pillar's rows in that order
// and adds them, reading the features once. The order of adds is fixed by
// the sorted positions of the item alone (chunks of WP positions, blocks of
// BP), so an item's bits do not depend on the batch it is binned in, and
// the tile split of the sort (which depends on the batch only through its
// warps per tile) moves no row. Four kernels, no memset:
//  1. tiles: a block per (item, tile of TILE rows). Each warp walks its
//     rows 32 at a time in row order with a 16-bit histogram per pillar in
//     shared memory; a row's rank among the tile's rows of its pillar comes
//     from __match_any_sync and the counts so far. The tile writes its dense
//     row of per-pillar counts (the table), every row's rank, and its count
//     of ids outside [0, V) with the first of them. It zeroes the arrival
//     counters of kernels 2 and 4.
//  2. starts: a warp per 32 pillars walks the table's column in tile order
//     and leaves, per tile, the pillar's start within its group of 32 plus
//     the counts of the tiles before; it writes the counts and zeroes the
//     sums of empty pillars. The last block of an item (an arrival counter)
//     scans the groups' totals and writes the item's status.
//  3. place: each row goes to position group start + table entry + rank;
//     a pillar's rows lie in row order.
//  4. reduce: a warp walks WP sorted positions and gathers their rows.
//     Wide rows (C > 8): the warp on one row at a time, lanes over channels
//     in 8- or 16-byte vectors, UR rows in flight. Narrow rows (C <= 8): a
//     lane per position, one vector load a row, a segmented scan over the
//     lanes (a fixed tree). A run that is a whole pillar is stored; runs at
//     the warp's edges go to shared memory, where warp 0 adds them in
//     position order (fp64). A pillar that crosses a block's edge leaves one
//     fp64 piece per block; the last block to deliver its piece (an arrival
//     counter) adds the pieces in block order, over its warps by a fixed
//     split, and rounds once. Pillar 0's ~82 000 rows are ~80 pieces.
// Accuracy: a warp adds at most WP rows in fp32, everything above that in
// fp64, and each sum is rounded once to fp32: within (WP + 1) * 2^-24 of the
// pillar's L1 mass, and in practice ~4e-7 of it on a real scan.
//
// C interface, loaded with ctypes: launches the four kernels on the given
// stream (for N = 0, three memsets instead) and returns cudaGetLastError().
// It does not synchronise and allocates nothing: the caller passes
// gloc3d_pillar_bin_sums_scratch_bytes(b, n, v, c) bytes of scratch on the
// current device, O(B (N + V ceil(N / TILE))) int32 (the table is one
// count per pillar and tile) plus two fp64 pieces of C per BP positions.
// The scratch starts with the status block, (B, 4) int32 per item: ids
// outside [0, V), the first such row, its id, and the rows placed (N less
// the bad ones).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

#include <cub/block/block_scan.cuh>

namespace {

constexpr int MAX_C = 256;
constexpr int NARROW_MAX_C = 8;
constexpr unsigned FULL = 0xffffffffu;
// tiles: rows per tile; the largest window of pillars a warp counts in
// shared memory at once
constexpr int TILE = 4096;
constexpr int RB = 8;  // rounds of 32 rows whose peers are found together
constexpr int WIN_MAX = 12288;
// starts and place: threads; rows per thread in place
constexpr int NB = 256;
constexpr int PLACE_ROWS = 4;
// reduce: warps per block (at least two blocks an SM), sorted positions per
// warp and per block; wide rows loaded U at a time
constexpr int NWD = 16;
constexpr int MIN_BLOCKS = 2;
constexpr int WP = 64;
constexpr int BP = NWD * WP;
constexpr int U = 8;

struct Args {
  const float* feats;
  const int* ids;
  float* sums;
  float* counts;
  int* status;   // (B, 4): bad ids, first bad row, its id, rows placed
  int* itemcnt;  // (B) arrivals of the starts blocks; arrive follows it
  int* arrive;   // (B, nblk) arrivals of block pieces
  int* tinfo;    // (B, tiles, 3): bad ids, first bad row, its id
  int* table;    // (B, tiles, V): counts, then start in group + tiles before
  int* lrank;    // (B, N): rank among the tile's rows of the same pillar
  int2* psid;    // (B, N): (row, pillar) at each sorted position
  int* lstart;   // (B, V): exclusive start within the pillar's warp group
  int* tot;      // (B, V): rows per pillar
  int* wtot;     // (B, nunit): rows per group of 32 pillars
  int* cpre;     // (B, nunit): exclusive prefix of wtot
  double* part;  // (B, nblk, 2, C): pieces of pillars crossing blocks
  int64_t b;
  int n, v, c, tiles, win, nblk, nunit;
  int64_t ncount;  // counters zeroed by the tiles kernel
};

__device__ __forceinline__ unsigned lanemask_lt(int lane) {
  return (1u << lane) - 1u;
}

// ------------------------------------------------------------------ tiles
// A block per (item, tile of TILE rows), TW warps each on SUB consecutive
// rows. The tile's ids are staged in shared memory. Each warp walks its rows
// 32 at a time in row order and counts each pillar of the current window in
// its own 16-bit histogram: a row's rank in the warp's rows is the pillar's
// count so far plus its rank among the equal ids of the 32
// (__match_any_sync, taken for RB rounds before their counts, which alone
// carry from round to round). The histograms then become, per pillar, the
// counts of the warps before (warp 0's slot: the tile's count, which goes to
// the table), and a row's rank in the tile adds its warp's.
template <int TW>
__global__ void __launch_bounds__(TW * 32) pillar_bin_sums_tiles(const Args a) {
  constexpr int NT = TW * 32;
  constexpr int SUB = TILE / TW;
  extern __shared__ int4 s_raw[];
  __shared__ int s_bad, s_first;
  int* s_ids = reinterpret_cast<int*>(s_raw);              // [TILE]
  unsigned short* s_rank =
      reinterpret_cast<unsigned short*>(s_ids + TILE);     // [TILE]
  unsigned short* s_hist = s_rank + TILE;                  // [TW][win]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
       i < a.ncount; i += static_cast<int64_t>(gridDim.x) * NT)
    a.itemcnt[i] = 0;
  const int64_t item = blockIdx.x / a.tiles;
  const int t = static_cast<int>(blockIdx.x % a.tiles);
  const int row0 = t * TILE;
  const int rows = min(TILE, a.n - row0);
  const int* id = a.ids + item * a.n + row0;
  if (threadIdx.x == 0) {
    s_bad = 0;
    s_first = INT_MAX;
  }
  if ((reinterpret_cast<uintptr_t>(id) & 15) == 0 && (rows & 3) == 0) {
    for (int k = threadIdx.x; k < rows / 4; k += NT)
      reinterpret_cast<int4*>(s_ids)[k] =
          __ldg(reinterpret_cast<const int4*>(id) + k);
  } else {
    for (int k = threadIdx.x; k < rows; k += NT) s_ids[k] = __ldg(id + k);
  }
  __syncthreads();
  {
    int nbad = 0, first = INT_MAX;
    for (int k = threadIdx.x; k < rows; k += NT) {
      const int x = s_ids[k];
      if (x < 0 || x >= a.v) {
        ++nbad;
        first = min(first, row0 + k);
      }
    }
    if (nbad) {
      atomicAdd(&s_bad, nbad);
      atomicMin(&s_first, first);
    }
  }
  int* lr = a.lrank + item * a.n + row0;
  int* trow = a.table + (item * a.tiles + t) * static_cast<int64_t>(a.v);
  const bool vec = (reinterpret_cast<uintptr_t>(trow) & 15) == 0;
  unsigned short* hist = s_hist + warp * a.win;
  const int k_lo = warp * SUB, k_hi = min(rows, k_lo + SUB);
  for (int wlo = 0; wlo < a.v; wlo += a.win) {
    const int w = min(a.win, a.v - wlo);
    // a.win is a multiple of 8: 16-byte stores
    for (int p = lane; p < a.win / 8; p += 32)
      reinterpret_cast<int4*>(hist)[p] = make_int4(0, 0, 0, 0);
    __syncwarp();
    static_assert(SUB % (32 * RB) == 0, "rounds come in batches of RB");
    for (int b0 = k_lo; b0 < k_lo + SUB; b0 += 32 * RB) {
      int y[RB];
      unsigned peers[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const int k = b0 + 32 * r + lane;
        y[r] = (k < k_hi ? s_ids[k] : -1) - wlo;
        const bool in = y[r] >= 0 && y[r] < w;
        peers[r] = __match_any_sync(FULL, in ? y[r] : -1);
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const bool in = y[r] >= 0 && y[r] < w;
        const int leader = __ffs(peers[r]) - 1;
        int old = 0;
        if (in && lane == leader) {
          old = hist[y[r]];
          hist[y[r]] = static_cast<unsigned short>(old + __popc(peers[r]));
        }
        old = __shfl_sync(FULL, old, leader);
        if (in)
          s_rank[b0 + 32 * r + lane] = static_cast<unsigned short>(
              old + __popc(peers[r] & lanemask_lt(lane)));
        __syncwarp();
      }
    }
    __syncthreads();
    // four pillars at a time (16-bit counts packed in 64 bits; a tile's
    // counts stay below 2^16, so packed sums do not carry)
    for (int q = threadIdx.x; q < (w + 3) / 4; q += NT) {
      unsigned long long run = 0;
#pragma unroll
      for (int u = 0; u < TW; ++u) {
        unsigned long long* h =
            reinterpret_cast<unsigned long long*>(s_hist + u * a.win) + q;
        const unsigned long long x = *h;
        if (u) *h = run;
        run += x;
      }
      reinterpret_cast<unsigned long long*>(s_hist)[q] = run;
      const int p = 4 * q;
      if (vec && p + 3 < w && (wlo & 3) == 0) {
        reinterpret_cast<int4*>(trow + wlo + p)[0] =
            make_int4(static_cast<int>(run & 0xffff),
                      static_cast<int>((run >> 16) & 0xffff),
                      static_cast<int>((run >> 32) & 0xffff),
                      static_cast<int>(run >> 48));
      } else {
        for (int e = 0; e < 4 && p + e < w; ++e)
          trow[wlo + p + e] = static_cast<int>((run >> (16 * e)) & 0xffff);
      }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < rows; k += NT) {
      const int x = s_ids[k];
      if (x < wlo || x >= wlo + w) continue;
      const int u = k / SUB;
      lr[k] = s_rank[k] + (u ? s_hist[u * a.win + x - wlo] : 0);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    int* ti = a.tinfo + (item * a.tiles + t) * 3;
    ti[0] = s_bad;
    ti[1] = s_bad ? s_first : 0;
    ti[2] = s_bad ? s_ids[s_first - row0] : 0;
  }
}

// ----------------------------------------------------------------- starts
// A warp per 32 pillars (a lane each) turns each tile's count into the
// pillar's start within the group plus the counts of the tiles before, in
// place; the item's last block scans the groups' totals and writes the
// status.
__global__ void __launch_bounds__(NB) pillar_bin_sums_starts(const Args a) {
  using Scan = cub::BlockScan<int, NB>;
  __shared__ typename Scan::TempStorage tmp;
  __shared__ int s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_item = (a.v + NB - 1) / NB;
  const int64_t item = blockIdx.x / per_item;
  const int p0 = static_cast<int>(blockIdx.x % per_item) * NB + warp * 32;
  const int p = p0 + lane;
  const bool ok = p < a.v;
  if (p0 < a.v) {  // warp-uniform
    int* col = a.table + item * a.tiles * static_cast<int64_t>(a.v) + p;
    const int64_t vs = a.v;
    // the first 32 tiles stay in registers (all of them up to N = 131 072)
    int x[32], run = 0;
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      x[u] = ok && u < a.tiles ? col[u * vs] : 0;
      run += x[u];
    }
    for (int t = 32; t < a.tiles; ++t) run += ok ? col[t * vs] : 0;
    const int64_t ip = item * a.v + p;
    int inc = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, inc, off);
      if (lane >= off) inc += y;
    }
    // each tile's entry becomes the pillar's start within the warp group
    // plus the counts of the tiles before
    int pre = inc - run;
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      if (ok && u < a.tiles) col[u * vs] = pre;
      pre += x[u];
    }
    for (int t = 32; t < a.tiles; ++t) {
      if (!ok) break;
      const int y = col[t * vs];
      col[t * vs] = pre;
      pre += y;
    }
    if (ok) {
      a.counts[ip] = static_cast<float>(run);
      a.tot[ip] = run;
      a.lstart[ip] = inc - run;
    }
    if (lane == 31) a.wtot[item * a.nunit + p0 / 32] = inc;
    unsigned empty = __ballot_sync(FULL, ok && run == 0);
    while (empty) {  // warp-uniform
      const int k = __ffs(empty) - 1;
      empty &= empty - 1;
      float* row = a.sums + (item * a.v + p0 + k) * static_cast<int64_t>(a.c);
      for (int j = lane; j < a.c; j += 32) row[j] = 0.f;
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(a.itemcnt + item, 1) == per_item - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the item's last block: starts of the warp groups, then the status
  const int* wt = a.wtot + item * a.nunit;
  int carry = 0;
  for (int base = 0; base < a.nunit; base += NB * 4) {
    int x[4], y[4], agg;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = base + threadIdx.x * 4 + e;
      x[e] = k < a.nunit ? __ldcg(wt + k) : 0;
    }
    Scan(tmp).ExclusiveSum(x, y, agg);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = base + threadIdx.x * 4 + e;
      if (k < a.nunit) a.cpre[item * a.nunit + k] = carry + y[e];
    }
    carry += agg;
    __syncthreads();
  }
  if (warp == 0) {
    int bad = 0, first = 0, val = 0;
    for (int t0 = 0; t0 < a.tiles; t0 += 32) {  // tiles in order
      const int t = t0 + lane;
      const int* ti = a.tinfo + (item * a.tiles + t) * 3;
      const int nb = t < a.tiles ? ti[0] : 0;
      const unsigned has = __ballot_sync(FULL, nb != 0);
      if (has && !bad) {
        const int src = __ffs(has) - 1;
        const int f = t < a.tiles ? ti[1] : 0, vv = t < a.tiles ? ti[2] : 0;
        first = __shfl_sync(FULL, f, src);
        val = __shfl_sync(FULL, vv, src);
      }
      int sum = nb;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(FULL, sum, off);
      bad += sum;
    }
    if (lane == 0) {
      int* st = a.status + item * 4;
      st[0] = bad;
      st[1] = first;
      st[2] = val;
      st[3] = a.n - bad;
    }
    // the positions no row reaches end the item's sorted rows
    int2* ps = a.psid + item * a.n;
    for (int k = a.n - bad + lane; k < a.n; k += 32) ps[k] = make_int2(0, -1);
  }
}

// ------------------------------------------------------------------ place
__global__ void __launch_bounds__(NB) pillar_bin_sums_place(const Args a) {
  const int rows = NB * PLACE_ROWS;
  const int per_item = (a.n + rows - 1) / rows;
  const int64_t item = blockIdx.x / per_item;
  const int r0 = static_cast<int>(blockIdx.x % per_item) * rows;
  const int* id = a.ids + item * a.n;
  int2* ps = a.psid + item * a.n;
#pragma unroll
  for (int k = 0; k < PLACE_ROWS; ++k) {
    const int r = r0 + k * NB + threadIdx.x;
    if (r >= a.n) break;
    const int p = __ldg(id + r);
    if (p < 0 || p >= a.v) continue;
    const int pos = a.cpre[item * a.nunit + (p >> 5)] +
                    a.table[(item * a.tiles + r / TILE) * a.v + p] +
                    a.lrank[item * a.n + r];
    ps[pos] = make_int2(r, p);
  }
}

// ----------------------------------------------------------------- reduce
// Shared by both row walks. Each warp has left its chunk's edge runs that
// continue past the chunk in s_buf[warp][0] (the run at the chunk's start)
// and s_buf[warp][1] (at its end), fp64, channel j at index j, with
// sh.meta[warp][s] = (pillar, continues from before, continues after).
// Warp 0 adds them in position order: a pillar that starts and ends in the
// block is stored; one that crosses the block's edge leaves a piece, and
// the block that delivers a pillar's last piece adds all of them in block
// order (a fixed split over its warps, then the warps in order).
struct Shared {
  int meta[NWD][2][3];  // pillar (-1: none), cont_in, cont_out
  int job[2][3];        // pillar, first block, pieces
  int njob;
};

template <int NV>  // channels per lane: NV * 32 >= C
__device__ __forceinline__ void merge_and_combine(const Args& a,
                                                  double* s_buf, Shared& sh,
                                                  int64_t item, int blk,
                                                  float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = a.c;
  __syncthreads();
  if (warp == 0) {
    double m[NV];
#pragma unroll
    for (int e = 0; e < NV; ++e) m[e] = 0.0;
    int open = -1;
    bool before = false;  // the open pillar began before this block
    auto emit = [&](int s) {
      double* dst = a.part + ((item * a.nblk + blk) * 2 + s) *
                                 static_cast<int64_t>(c);
#pragma unroll
      for (int e = 0; e < NV; ++e) {
        const int j = lane + 32 * e;
        if (j < c) dst[j] = m[e];
      }
      __threadfence();
      __syncwarp();
      if (lane == 0) {
        const int64_t ip = item * a.v + open;
        const int gs = a.lstart[ip] + a.cpre[item * a.nunit + (open >> 5)];
        const int kb0 = gs / BP, kb1 = (gs + a.tot[ip] - 1) / BP;
        if (atomicAdd(a.arrive + item * a.nblk + kb0, 1) == kb1 - kb0) {
          __threadfence();
          const int k = sh.njob++;
          sh.job[k][0] = open;
          sh.job[k][1] = kb0;
          sh.job[k][2] = kb1 - kb0 + 1;
        }
      }
      __syncwarp();
    };
    for (int w = 0; w < NWD; ++w) {
      for (int s = 0; s < 2; ++s) {
        const int id = sh.meta[w][s][0];
        if (id < 0) continue;
        const bool cin = sh.meta[w][s][1], cout = sh.meta[w][s][2];
        const double* slot = s_buf + (w * 2 + s) * c;
        const bool cont = cin && open == id;
#pragma unroll
        for (int e = 0; e < NV; ++e) {
          const int j = lane + 32 * e;
          const double y = j < c ? slot[j] : 0.0;
          m[e] = cont ? m[e] + y : y;
        }
        if (!cont) {  // a new pillar; cin only at the block's first position
          open = id;
          before = cin;
        }
        if (!cout) {
          if (before) {
            emit(0);
          } else {
            float* dst = out + static_cast<int64_t>(open) * c;
#pragma unroll
            for (int e = 0; e < NV; ++e) {
              const int j = lane + 32 * e;
              if (j < c) dst[j] = static_cast<float>(m[e]);
            }
          }
          open = -1;
        }
      }
    }
    if (open >= 0) emit(before ? 0 : 1);
  }
  __syncthreads();

  const int njob = sh.njob;
  for (int jb = 0; jb < njob; ++jb) {
    const int id = sh.job[jb][0], kb0 = sh.job[jb][1], np = sh.job[jb][2];
    const int lo = static_cast<int>(static_cast<int64_t>(np) * warp / NWD);
    const int hi =
        static_cast<int>(static_cast<int64_t>(np) * (warp + 1) / NWD);
    double m[NV];
#pragma unroll
    for (int e = 0; e < NV; ++e) m[e] = 0.0;
#pragma unroll 4
    for (int k = lo; k < hi; ++k) {
      // the first block's piece is its tail (slot 1), every later one slot 0
      const double* src =
          a.part + ((item * a.nblk + kb0 + k) * 2 + (k == 0 ? 1 : 0)) *
                       static_cast<int64_t>(c);
#pragma unroll
      for (int e = 0; e < NV; ++e) {
        const int j = lane + 32 * e;
        if (j < c) m[e] += __ldcg(src + j);
      }
    }
#pragma unroll
    for (int e = 0; e < NV; ++e) {
      const int j = lane + 32 * e;
      if (j < c) s_buf[warp * c + j] = m[e];
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int e = 0; e < NV; ++e) {
        const int j = lane + 32 * e;
        if (j >= c) continue;
        double s = 0.0;
        for (int w = 0; w < NWD; ++w) s += s_buf[w * c + j];
        out[static_cast<int64_t>(id) * c + j] = static_cast<float>(s);
      }
    }
    __syncthreads();
  }
}

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

// Wide rows (C > 8): a warp on one row at a time, lane l holding the
// channels [VW (l + 32 q), VW (l + 32 q) + VW) for q < PER; UR rows loaded
// before they are added into the run's fp32 sums (a run has at most WP
// rows; pieces and merges are fp64).
template <int VW, int PER>
__global__ void __launch_bounds__(NWD * 32, MIN_BLOCKS)
pillar_bin_sums_reduce(const Args a) {
  constexpr int NV = VW * PER;
  constexpr int UR = NV <= 4 ? U : U / 2;  // rows in flight
  extern __shared__ double s_buf[];  // [NWD][2][C]
  __shared__ Shared sh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = a.c;
  const int64_t item = blockIdx.x / a.nblk;
  const int blk = static_cast<int>(blockIdx.x % a.nblk);
  const int2* ps = a.psid + item * a.n;
  const float* x = a.feats + item * static_cast<int64_t>(a.n) * c;
  float* out = a.sums + item * static_cast<int64_t>(a.v) * c;
  const int groups = c / VW;
  if (lane < 2) sh.meta[warp][lane][0] = -1;
  if (threadIdx.x == 0) sh.njob = 0;
  __syncwarp();

  const int c0 = blk * BP + warp * WP, c1 = min(c0 + WP, a.n);
  if (c0 < c1) {  // warp-uniform
    const int prev_id = c0 > 0 ? ps[c0 - 1].y : -1;
    const int next_id = c1 < a.n ? ps[c1].y : -1;
    float acc[NV];
#pragma unroll
    for (int e = 0; e < NV; ++e) acc[e] = 0.f;
    int cur = -1, rb = c0;

    // the run of pillar cur over positions [rb, re) ends
    auto finish = [&](int re) {
      const bool cin = rb == c0 && prev_id == cur;
      const bool cout = re == c1 && next_id == cur;
      if (!cin && !cout) {
        float* dst = out + static_cast<int64_t>(cur) * c;
#pragma unroll
        for (int q = 0; q < PER; ++q) {
          const int g = lane + 32 * q;
          if (g < groups) {
            if constexpr (VW == 4) {
              reinterpret_cast<float4*>(dst)[g] = make_float4(
                  acc[q * 4], acc[q * 4 + 1], acc[q * 4 + 2], acc[q * 4 + 3]);
            } else if constexpr (VW == 2) {
              reinterpret_cast<float2*>(dst)[g] =
                  make_float2(acc[q * 2], acc[q * 2 + 1]);
            } else {
              dst[g] = acc[q];
            }
          }
        }
        return;
      }
      const int s = rb == c0 ? 0 : 1;
      double* slot = s_buf + (warp * 2 + s) * c;
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int g = lane + 32 * q;
        if (g < groups) {
#pragma unroll
          for (int e = 0; e < VW; ++e) slot[g * VW + e] = acc[q * VW + e];
        }
      }
      if (lane == 0) {
        sh.meta[warp][s][0] = cur;
        sh.meta[warp][s][1] = cin;
        sh.meta[warp][s][2] = cout;
      }
    };

    for (int base = c0; base < c1; base += 32) {
      const int cnt = min(32, c1 - base);
      const int2 my = lane < cnt ? ps[base + lane] : make_int2(0, -1);
      for (int k0 = 0; k0 < cnt; k0 += UR) {  // warp-uniform; k0 + UR <= 32
        float val[UR][NV];
#pragma unroll
        for (int u = 0; u < UR; ++u) {
          const int r = __shfl_sync(FULL, my.x, k0 + u);
          const float* row = x + static_cast<int64_t>(r) * c;
#pragma unroll
          for (int q = 0; q < PER; ++q) {
            const int g = lane + 32 * q;
            if (k0 + u < cnt && g < groups) {
              load_vec<VW>(row + g * VW, val[u] + q * VW);
            } else {
#pragma unroll
              for (int e = 0; e < VW; ++e) val[u][q * VW + e] = 0.f;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < UR; ++u) {
          const int rid = __shfl_sync(FULL, my.y, k0 + u);
          if (k0 + u >= cnt || rid < 0) continue;  // warp-uniform
          if (rid != cur) {
            if (cur >= 0) finish(base + k0 + u);
            cur = rid;
            rb = base + k0 + u;
#pragma unroll
            for (int e = 0; e < NV; ++e) acc[e] = 0.f;
          }
#pragma unroll
          for (int e = 0; e < NV; ++e) acc[e] += val[u][e];
        }
      }
    }
    if (cur >= 0) finish(c1);
  }
  merge_and_combine<NV>(a, s_buf, sh, item, blk, out);
}

// Narrow rows (C <= 8): lane l on position l of each group of 32, one
// vector load per row; a segmented scan over the lanes (a fixed tree) sums
// each run of equal pillars within the group, and the run that continues
// from the group before adds the carry first.
template <int C>
__global__ void __launch_bounds__(NWD * 32, MIN_BLOCKS)
pillar_bin_sums_reduce_narrow(const Args a, int vec16) {
  constexpr int G = WP / 32;  // groups per warp
  extern __shared__ double s_buf[];  // [NWD][2][C]
  __shared__ Shared sh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t item = blockIdx.x / a.nblk;
  const int blk = static_cast<int>(blockIdx.x % a.nblk);
  const int2* ps = a.psid + item * a.n;
  const float* x = a.feats + item * static_cast<int64_t>(a.n) * C;
  float* out = a.sums + item * static_cast<int64_t>(a.v) * C;
  if (lane < 2) sh.meta[warp][lane][0] = -1;
  if (threadIdx.x == 0) sh.njob = 0;
  __syncwarp();

  const int c0 = blk * BP + warp * WP, c1 = min(c0 + WP, a.n);
  if (c0 < c1) {  // warp-uniform
    int2 pr[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int pos = c0 + g * 32 + lane;
      pr[g] = pos < c1 ? ps[pos] : make_int2(0, -1);
    }
    const int prev_id = c0 > 0 ? ps[c0 - 1].y : -1;
    const int next_id = c1 < a.n ? ps[c1].y : -1;
    float val[G][C];
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int j = 0; j < C; ++j) val[g][j] = 0.f;
      if (pr[g].y >= 0) {
        const float* row = x + static_cast<int64_t>(pr[g].x) * C;
        if constexpr (C % 4 == 0) {
          if (vec16) {
#pragma unroll
            for (int j = 0; j < C; j += 4) load_vec<4>(row + j, val[g] + j);
            continue;
          }
        }
#pragma unroll
        for (int j = 0; j < C; ++j) val[g][j] = __ldg(row + j);
      }
    }
    int carry_id = -1, carry_rb = c0;
    float carry[C];
#pragma unroll
    for (int j = 0; j < C; ++j) carry[j] = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int base = c0 + g * 32;
      const int id = pr[g].y;
      const bool ok = id >= 0;
      float* v = val[g];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int idd = __shfl_up_sync(FULL, id, d);
        const bool take = lane >= d && idd == id;
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const float y = __shfl_up_sync(FULL, v[j], d);
          if (take) v[j] += y;
        }
      }
      const int up = __shfl_up_sync(FULL, id, 1);
      const unsigned heads = __ballot_sync(FULL, ok && (lane == 0 || up != id));
      const int after = __shfl_sync(FULL, pr[(g + 1) % G].y, 0);
      int nid = __shfl_down_sync(FULL, id, 1);
      if (lane == 31) nid = g + 1 < G ? after : -1;
      const bool cont = ok && id == carry_id;
      if (cont) {
#pragma unroll
        for (int j = 0; j < C; ++j) v[j] = carry[j] + v[j];
      }
      const unsigned le = lane == 31 ? FULL : (2u << lane) - 1u;
      const int rb = cont ? carry_rb : base + 31 - __clz(heads & le);
      const int pos = base + lane;
      if (ok && (pos == c1 - 1 || nid != id)) {  // a run ends here
        const bool cin = rb == c0 && prev_id == id;
        const bool cout = pos + 1 == c1 && next_id == id;
        if (!cin && !cout) {
          float* dst = out + static_cast<int64_t>(id) * C;
#pragma unroll
          for (int j = 0; j < C; ++j) dst[j] = v[j];
        } else {
          const int s = rb == c0 ? 0 : 1;
          double* slot = s_buf + (warp * 2 + s) * C;
#pragma unroll
          for (int j = 0; j < C; ++j) slot[j] = v[j];
          sh.meta[warp][s][0] = id;
          sh.meta[warp][s][1] = cin;
          sh.meta[warp][s][2] = cout;
        }
      }
      carry_id = __shfl_sync(FULL, id, 31);
      carry_rb = __shfl_sync(FULL, rb, 31);
#pragma unroll
      for (int j = 0; j < C; ++j) carry[j] = __shfl_sync(FULL, v[j], 31);
    }
  }
  merge_and_combine<1>(a, s_buf, sh, item, blk, out);
}

// --------------------------------------------------------------- launch
template <typename K>
cudaError_t launch_with_smem(K kernel, const Args& a, int threads,
                             int64_t blocks, int smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<static_cast<unsigned>(blocks), threads, smem, s>>>(a);
  return cudaGetLastError();
}

template <int VW, int PER>
cudaError_t launch_reduce(const Args& a, cudaStream_t s) {
  return launch_with_smem(pillar_bin_sums_reduce<VW, PER>, a, NWD * 32,
                          a.b * a.nblk, NWD * 2 * a.c * 8, s);
}

template <int C>
cudaError_t launch_narrow(const Args& a, cudaStream_t s) {
  const int vec16 = (C % 4 == 0) &&
                    (reinterpret_cast<uintptr_t>(a.feats) % 16 == 0);
  pillar_bin_sums_reduce_narrow<C>
      <<<static_cast<unsigned>(a.b * a.nblk), NWD * 32, NWD * 2 * C * 8, s>>>(
          a, vec16);
  return cudaGetLastError();
}

// Narrow for C <= 8; otherwise the widest vector that divides C and fits
// the rows' alignment: 16 bytes for C >= 128, 8 bytes where that still
// puts all 32 lanes on a row (C >= 64), else one float; PER vectors a lane.
cudaError_t dispatch_reduce(const Args& a, cudaStream_t s) {
  static_assert(NARROW_MAX_C == 8, "one narrow case per C <= NARROW_MAX_C");
  switch (a.c) {
    case 1: return launch_narrow<1>(a, s);
    case 2: return launch_narrow<2>(a, s);
    case 3: return launch_narrow<3>(a, s);
    case 4: return launch_narrow<4>(a, s);
    case 5: return launch_narrow<5>(a, s);
    case 6: return launch_narrow<6>(a, s);
    case 7: return launch_narrow<7>(a, s);
    case 8: return launch_narrow<8>(a, s);
    default: break;
  }
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a.feats);
  if (a.c % 4 == 0 && addr % 16 == 0 && a.c >= 128)
    return a.c <= 128 ? launch_reduce<4, 1>(a, s) : launch_reduce<4, 2>(a, s);
  if (a.c % 2 == 0 && addr % 8 == 0 && a.c >= 64) {
    switch ((a.c + 63) / 64) {
      case 1: return launch_reduce<2, 1>(a, s);
      case 2: return launch_reduce<2, 2>(a, s);
      case 3: return launch_reduce<2, 3>(a, s);
      default: return launch_reduce<2, 4>(a, s);
    }
  }
  switch ((a.c + 31) / 32) {
    case 1: return launch_reduce<1, 1>(a, s);
    case 2: return launch_reduce<1, 2>(a, s);
    case 3: return launch_reduce<1, 3>(a, s);
    case 4: return launch_reduce<1, 4>(a, s);
    case 5: return launch_reduce<1, 5>(a, s);
    case 6: return launch_reduce<1, 6>(a, s);
    case 7: return launch_reduce<1, 7>(a, s);
    default: return launch_reduce<1, 8>(a, s);
  }
}

int64_t align16(int64_t x) { return (x + 15) & ~int64_t{15}; }

// Byte offsets into the scratch; the status block comes first.
struct Layout {
  int64_t counters, tinfo, table, lrank, psid, lstart, tot, wtot, cpre, part,
      total, ncount;
  int tiles, win, nblk, nunit;
};

Layout layout(int64_t b, int64_t n, int64_t v, int64_t c) {
  Layout l;
  l.tiles = static_cast<int>((n + TILE - 1) / TILE);
  l.win = static_cast<int>(std::min<int64_t>(v, WIN_MAX));
  l.win = (l.win + 7) & ~7;  // 16-byte rows of 16-bit counts
  l.nblk = static_cast<int>((n + BP - 1) / BP);
  l.nunit = static_cast<int>((v + 31) / 32);
  l.ncount = b + b * l.nblk;
  l.counters = align16(16 * b);
  l.tinfo = align16(l.counters + 4 * l.ncount);
  l.table = align16(l.tinfo + 12 * b * l.tiles);
  l.lrank = align16(l.table + 4 * b * l.tiles * v);
  l.psid = align16(l.lrank + 4 * b * n);
  l.lstart = align16(l.psid + 8 * b * n);
  l.tot = align16(l.lstart + 4 * b * v);
  l.wtot = align16(l.tot + 4 * b * v);
  l.cpre = align16(l.wtot + 4 * b * l.nunit);
  l.part = align16(l.cpre + 4 * b * l.nunit);
  l.total = l.part + 8 * b * l.nblk * 2 * c;
  return l;
}

}  // namespace


// Bytes of scratch a call with these sizes needs.
extern "C" int64_t gloc3d_pillar_bin_sums_scratch_bytes(int64_t b, int64_t n,
                                                        int64_t v,
                                                        int64_t c) {
  if (b <= 0) return 0;
  if (n <= 0) return 16 * b;
  return layout(b, n, v, c).total;
}

extern "C" int gloc3d_pillar_bin_sums(const float* feats, const int* ids,
                                      float* sums, float* counts,
                                      void* scratch, int64_t b, int64_t n,
                                      int64_t v, int64_t c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0) return static_cast<int>(cudaSuccess);
  if (n > INT_MAX / 2 || v > INT_MAX / 2 || v < 1 || c < 1 || c > MAX_C)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) {
    cudaError_t e = cudaMemsetAsync(sums, 0, sizeof(float) * b * v * c, s);
    if (e == cudaSuccess)
      e = cudaMemsetAsync(counts, 0, sizeof(float) * b * v, s);
    if (e == cudaSuccess) e = cudaMemsetAsync(scratch, 0, 16 * b, s);
    return static_cast<int>(e);
  }
  const Layout l = layout(b, n, v, c);
  const int64_t tile_blocks = b * l.tiles;
  const int64_t starts_blocks = b * ((v + NB - 1) / NB);
  const int64_t place_blocks = b * ((n + NB * PLACE_ROWS - 1) /
                                    (NB * PLACE_ROWS));
  if (tile_blocks > INT_MAX || starts_blocks > INT_MAX ||
      place_blocks > INT_MAX || b * l.nblk > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  char* base = static_cast<char*>(scratch);
  Args a;
  a.feats = feats;
  a.ids = ids;
  a.sums = sums;
  a.counts = counts;
  a.status = reinterpret_cast<int*>(base);
  a.itemcnt = reinterpret_cast<int*>(base + l.counters);
  a.arrive = a.itemcnt + b;
  a.tinfo = reinterpret_cast<int*>(base + l.tinfo);
  a.table = reinterpret_cast<int*>(base + l.table);
  a.lrank = reinterpret_cast<int*>(base + l.lrank);
  a.psid = reinterpret_cast<int2*>(base + l.psid);
  a.lstart = reinterpret_cast<int*>(base + l.lstart);
  a.tot = reinterpret_cast<int*>(base + l.tot);
  a.wtot = reinterpret_cast<int*>(base + l.wtot);
  a.cpre = reinterpret_cast<int*>(base + l.cpre);
  a.part = reinterpret_cast<double*>(base + l.part);
  a.b = b;
  a.n = static_cast<int>(n);
  a.v = static_cast<int>(v);
  a.c = static_cast<int>(c);
  a.tiles = l.tiles;
  a.win = l.win;
  a.nblk = l.nblk;
  a.nunit = l.nunit;
  a.ncount = l.ncount;

  // 8 warps a tile while the tiles fit on the SMs at once, else 4 (two
  // blocks an SM); the split moves no bits, since ranks follow row order
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e =
      tile_blocks <= sms
          ? launch_with_smem(pillar_bin_sums_tiles<8>, a, 8 * 32, tile_blocks,
                             TILE * 6 + 8 * l.win * 2, s)
          : launch_with_smem(pillar_bin_sums_tiles<4>, a, 4 * 32, tile_blocks,
                             TILE * 6 + 4 * l.win * 2, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  pillar_bin_sums_starts<<<static_cast<unsigned>(starts_blocks), NB, 0, s>>>(
      a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  pillar_bin_sums_place<<<static_cast<unsigned>(place_blocks), NB, 0, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(dispatch_reduce(a, s));
}
