// k-NN PCA normals of a batch of point clouds, in float64, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel. It replaces the k-NN and the PCA of the JAX
// function gloc3d_tpu/ops/ground.py::estimate_ground: an (M, M) distance
// matrix, jax.lax.approx_min_k over its rows, the neighbours' covariance
// and its smallest eigenvector. The port had kept that shape in plain
// PyTorch: a K = 3 DGEMM writing a (B, M, M) float64 matrix (134 MB a scan
// at M = 4096), four elementwise passes over it and a radix top-k, ~1 ms of
// device time a located query. Semantics (the plain version,
// kernels/knn_normals.py::knn_normals_plain):
//   d2(i, j) = (|p_i|^2 - 2 p_i.p_j) + |p_j|^2, float64, in that order;
//   columns with ok false count as +inf, as does a NaN distance;
//   the k smallest by (d2, j): at equal distances the earliest index wins,
//   and with fewer than k finite columns the earliest infinite ones fill;
//   the neighbours' mean, their covariance / k, and its smallest
//   eigenvector in closed form (Cardano, the 3 x 3 determinant by
//   cofactors, +Z where the covariance is isotropic or the eigenvector
//   vanishes).
//
// Bound on the card: float64 operations, not bytes. The inputs are 32 B a
// point (0.13 MB a scan); the work is M^2 pair distances of 6 float64
// instructions each (a product, three fused multiply-adds, an add and the
// comparison with the row's threshold), 101 M a scan at M = 4096: 6 us at
// the H100's 16.7 T float64 instructions a second outside the tensor cores
// (its 33.5 TFLOP/s counts a fused multiply-add as two). The float64 tensor
// cores (DMMA, twice that peak) are not counted: their K = 4 product rounds
// in an order of its own, and the selection needs the plain version's
// distances bit for bit, so that ties and neighbour sets agree.
//
// Design. A block takes WARPS rows of one scan, a warp one row. The block
// stages the scan's columns in shared memory, TILE at a time (x, y, z and
// |p|^2, +inf for a column with ok false), so any M fits; each lane of a
// warp walks the columns lane, lane + 32, ..., and computes the distance
// with explicit roundings (__dmul_rn, __fma_rn, __dadd_rn) in the plain
// version's order. Every other product is a __dmul_rn too, which the
// compiler never fuses into an add: a fused covariance or eigenvector
// moved a near-degenerate normal by 3e-12 from the plain version (H100).
// The warp keeps the row's running k smallest as a sorted list of (distance,
// index) across its 32 lanes, lane l holding place l, and the list's k-th
// entry as the row's threshold; distances are read with NaN as +inf and -0
// as +0, so (distance, index) is a strict order, the set and its order do
// not depend on the order of the columns or the lanes, and every launch
// gives the same bits. One float64 comparison with the threshold drops
// nearly every column; a column whose (distance, index) lies below the
// threshold goes to the row's candidate buffer in shared memory (a ballot
// gives its slot); when 32 would not fit, the warp sorts the buffer (a
// bitonic sort over the lanes), merges it into the list (the lower half of
// the reversed pair, then a bitonic merge) and takes the new threshold. On
// random column order ~k ln(M / 32) columns of a row pass the threshold
// after the first 64, so a row merges ~4 times (k = 10, M = 4096).
// The same warp then reads the k neighbours (lane l the l-th), sums the
// mean and the six covariance terms by a butterfly over the lanes (a fixed
// order: every lane ends with the same bits) and solves the 3 x 3 on every
// lane; lane 0 writes the normal. The grid is B x ceil(M / WARPS) blocks,
// so one scan fills the card. On an H100 at M = 4096 the distances alone
// take ~55 % of the kernel's time and the selection ~35 % (PERF.md).
//
// C interface, loaded with ctypes: launches on the given stream and returns
// cudaGetLastError(). It does not synchronise and allocates nothing, so a
// CUDA graph captures it as one node. points (B, M, 3) float64 and ok
// (B, M) bool (one byte each), contiguous; out (B, M, 3) float64; 1 <= k <=
// min(32, M).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;
constexpr int TILE = 1024;
constexpr int MAX_K = 32;
constexpr int IDX_NONE = INT_MAX;

// A candidate: its distance, NaN read as +inf and -0 as +0 (each compares
// equal to its stand-in in the plain version's order), and its column.
// (+inf, IDX_NONE) fills an empty place and lies above every column.
struct Entry {
  double d;
  int idx;
};

__device__ __forceinline__ double inf() {
  return __longlong_as_double(0x7ff0000000000000ll);
}

__device__ __forceinline__ Entry none() { return {inf(), IDX_NONE}; }

__device__ __forceinline__ double canonical(double d) {
  return d != d ? inf() : __dadd_rn(d, 0.0);
}

// (d, idx) in the strict order of the plain version's selection
__device__ __forceinline__ bool below(const Entry& a, const Entry& b) {
  return a.d < b.d || (a.d == b.d && a.idx < b.idx);
}

__device__ __forceinline__ Entry shfl_xor(const Entry& e, int mask) {
  return {__shfl_xor_sync(FULL, e.d, mask),
          __shfl_xor_sync(FULL, e.idx, mask)};
}

__device__ __forceinline__ Entry shfl(const Entry& e, int lane) {
  return {__shfl_sync(FULL, e.d, lane), __shfl_sync(FULL, e.idx, lane)};
}

// A product the compiler never fuses into an add: as in the plain
// version, every product below rounds on its own, and only the distance's
// __fma_rn fuse.
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}

// |p|^2 as the plain version's torch.sum(p * p, -1): the squares, then
// left to right
__device__ __forceinline__ double norm2(double x, double y, double z) {
  return (mul(x, x) + mul(y, y)) + mul(z, z);
}

// Sort the lanes' entries ascending (a bitonic network over the warp).
__device__ __forceinline__ Entry warp_sort(Entry v, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const Entry o = shfl_xor(v, stride);
      const bool keep_low = ((lane & stride) == 0) == ((lane & size) == 0);
      v = (below(o, v) == keep_low) ? o : v;
    }
  }
  return v;
}

// Merge a sorted buffer into the sorted list: the lower half of list vs
// reversed buffer is a bitonic sequence holding the 32 smallest, which a
// bitonic merge sorts.
__device__ __forceinline__ Entry warp_merge(Entry list, Entry sorted_buf,
                                            int lane) {
  const Entry rev = shfl(sorted_buf, 31 - lane);
  Entry v = below(rev, list) ? rev : list;
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const Entry o = shfl_xor(v, stride);
    const bool keep_low = (lane & stride) == 0;
    v = (below(o, v) == keep_low) ? o : v;
  }
  return v;
}

// Merge a row's candidate buffer (cnt entries in shared memory) into its
// list and take the new threshold; the whole warp calls it.
__device__ __forceinline__ void flush(Entry& list, Entry& tau, int& cnt,
                                      const double* bd, const int* bidx,
                                      int lane, int k) {
  __syncwarp();
  Entry c = none();
  if (lane < cnt) c = {bd[lane], bidx[lane]};
  list = warp_merge(list, warp_sort(c, lane), lane);
  tau = shfl(list, k - 1);
  cnt = 0;
  __syncwarp();
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(FULL, v, m);
  return v;
}

// The smallest eigenvector of a symmetric 3 x 3 (a00, a11, a22, a01, a02,
// a12), as the plain version's _smallest_eigvec_3x3.
__device__ void smallest_eigvec(double a00, double a11, double a22,
                                double a01, double a02, double a12,
                                double* out) {
  const double q = (a00 + a11 + a22) / 3.0;
  const double p1 = mul(a01, a01) + mul(a02, a02) + mul(a12, a12);
  const double d0 = a00 - q, d1 = a11 - q, d2 = a22 - q;
  const double p2 =
      mul(d0, d0) + mul(d1, d1) + mul(d2, d2) + mul(2.0, p1);
  const double p = sqrt(fmax(p2 / 6.0, 1e-20));
  // B = (A - qI) / p; its determinant by cofactors
  const double b00 = d0 / p, b11 = d1 / p, b22 = d2 / p;
  const double b01 = a01 / p, b02 = a02 / p, b12 = a12 / p;
  const double detb = mul(b00, mul(b11, b22) - mul(b12, b12)) -
                      mul(b01, mul(b01, b22) - mul(b12, b02)) +
                      mul(b02, mul(b01, b12) - mul(b11, b02));
  const double r = fmin(fmax(detb / 2.0, -1.0), 1.0);
  const double phi = acos(r) / 3.0;
  const double lam1 = q + mul(mul(2.0, p), cos(phi));
  const double lam3 =
      q + mul(mul(2.0, p), cos(phi + 2.0 * 3.141592653589793 / 3.0));
  const double lam2 = mul(3.0, q) - lam1 - lam3;
  // C = (A - lam1 I)(A - lam2 I); the column of largest norm (the first of
  // equal ones)
  const double m[3][3] = {{a00 - lam1, a01, a02},
                          {a01, a11 - lam1, a12},
                          {a02, a12, a22 - lam1}};
  const double n[3][3] = {{a00 - lam2, a01, a02},
                          {a01, a11 - lam2, a12},
                          {a02, a12, a22 - lam2}};
  double c[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      c[i][j] = mul(m[i][0], n[0][j]) + mul(m[i][1], n[1][j]) +
                mul(m[i][2], n[2][j]);
  int best = 0;
  double best_norm = -1.0;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const double nj = sqrt(mul(c[0][j], c[0][j]) + mul(c[1][j], c[1][j]) +
                           mul(c[2][j], c[2][j]));
    if (nj > best_norm) {
      best_norm = nj;
      best = j;
    }
  }
  const double v0 = c[0][best], v1 = c[1][best], v2 = c[2][best];
  const double len = sqrt(mul(v0, v0) + mul(v1, v1) + mul(v2, v2));
  if (p2 < 1e-16 || len < 1e-12) {
    out[0] = 0.0;
    out[1] = 0.0;
    out[2] = 1.0;
  } else {
    const double s = fmax(len, 1e-20);
    out[0] = v0 / s;
    out[1] = v1 / s;
    out[2] = v2 / s;
  }
}

struct Shared {
  double x[TILE], y[TILE], z[TILE], sq[TILE];
  double bd[WARPS][32];  // each row's candidate buffer
  int bidx[WARPS][32];
};

__global__ void __launch_bounds__(WARPS * 32)
    knn_normals_kernel(const double* __restrict__ points,
                       const unsigned char* __restrict__ ok,
                       double* __restrict__ out, int m, int k,
                       int blocks_per_scan) {
  __shared__ Shared sh;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t scan = blockIdx.x / blocks_per_scan;
  const int row = (blockIdx.x % blocks_per_scan) * WARPS + warp;
  const double* pts = points + scan * m * 3;
  const unsigned char* oks = ok + scan * m;
  double* bd = sh.bd[warp];
  int* bidx = sh.bidx[warp];

  // a row past M computes and is not written
  const int i = min(row, m - 1);
  const double rx = pts[3 * i], ry = pts[3 * i + 1], rz = pts[3 * i + 2];
  const double rsq = norm2(rx, ry, rz);
  Entry list = none(), tau = none();
  int cnt = 0;

  for (int t0 = 0; t0 < m; t0 += TILE) {
    const int tn = min(TILE, m - t0);
    __syncthreads();
    for (int c = threadIdx.x; c < tn; c += WARPS * 32) {
      const int j = t0 + c;
      const double x = pts[3 * j], y = pts[3 * j + 1], z = pts[3 * j + 2];
      sh.x[c] = x;
      sh.y[c] = y;
      sh.z[c] = z;
      sh.sq[c] = oks[j] ? norm2(x, y, z) : inf();
    }
    __syncthreads();
    for (int base = 0; base < tn; base += 32) {
      const int c = base + lane;
      const bool live = c < tn;
      const int cc = live ? c : 0;
      // the dot as a K = 3 product accumulates it, then
      // (|p_i|^2 - 2 dot) in one rounding (2 dot is exact), + |p_j|^2
      const double dot = __fma_rn(
          rz, sh.z[cc], __fma_rn(ry, sh.y[cc], mul(rx, sh.x[cc])));
      const double d = __dadd_rn(__fma_rn(-2.0, dot, rsq), sh.sq[cc]);
      // one float64 comparison with the threshold drops all but the
      // columns that may lie below it (NaN among them); those take the
      // exact order
      const bool maybe = live && !(d > tau.d);
      if (!__ballot_sync(FULL, maybe)) continue;
      const Entry e = {canonical(d), t0 + c};
      const bool admit = maybe && below(e, tau);
      const unsigned ballot = __ballot_sync(FULL, admit);
      if (!ballot) continue;
      const int n = __popc(ballot);
      if (cnt + n > 32) flush(list, tau, cnt, bd, bidx, lane, k);
      if (admit) {
        const int at = cnt + __popc(ballot & ((1u << lane) - 1u));
        bd[at] = e.d;
        bidx[at] = e.idx;
      }
      cnt += n;
    }
  }
  if (cnt > 0) flush(list, tau, cnt, bd, bidx, lane, k);

  // the k neighbours, lane l the l-th; the rest add zeros
  double x = 0.0, y = 0.0, z = 0.0;
  if (lane < k) {
    const int j = list.idx;
    x = pts[3 * j];
    y = pts[3 * j + 1];
    z = pts[3 * j + 2];
  }
  const double mx = warp_sum(x) / k, my = warp_sum(y) / k,
               mz = warp_sum(z) / k;
  const double cx = lane < k ? x - mx : 0.0;
  const double cy = lane < k ? y - my : 0.0;
  const double cz = lane < k ? z - mz : 0.0;
  const double a00 = warp_sum(mul(cx, cx)) / k,
               a11 = warp_sum(mul(cy, cy)) / k,
               a22 = warp_sum(mul(cz, cz)) / k,
               a01 = warp_sum(mul(cx, cy)) / k,
               a02 = warp_sum(mul(cx, cz)) / k,
               a12 = warp_sum(mul(cy, cz)) / k;
  double nrm[3];
  smallest_eigvec(a00, a11, a22, a01, a02, a12, nrm);
  if (lane == 0 && row < m) {
    double* o = out + (scan * m + row) * 3;
    o[0] = nrm[0];
    o[1] = nrm[1];
    o[2] = nrm[2];
  }
}

}  // namespace

extern "C" int gloc3d_knn_normals(const double* points,
                                  const unsigned char* ok, double* out,
                                  int64_t b, int64_t m, int64_t k,
                                  void* stream) {
  if (b <= 0 || m <= 0) return static_cast<int>(cudaSuccess);
  if (m > INT_MAX / 4 || k < 1 || k > MAX_K || k > m)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per_scan = (m + WARPS - 1) / WARPS;
  if (b * per_scan > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  knn_normals_kernel<<<static_cast<unsigned>(b * per_scan), WARPS * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      points, ok, out, static_cast<int>(m), static_cast<int>(k),
      static_cast<int>(per_scan));
  return static_cast<int>(cudaGetLastError());
}
