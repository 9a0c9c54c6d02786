// The register-tiled 128 x 128 fp32 score tile shared by knn_topk.cu,
// knn_stream.cu and pairwise_l2.cu, and the top-k merge of the two top-k
// kernels.
//
// The tile: 256 threads as 16 x 16, thread t = (ty, tx) = (t >> 4, t & 15)
// owning the 8 x 8 products of rows slot_of(ty, i) and columns
// slot_of(tx, j).  The d axis is staged in chunks of BK dims, transposed
// ([BK][LD] floats: dim dd of tile row r at dd * LD + r), double-buffered
// in shared memory: while one chunk is scored (fma_chunk) the next is loaded
// into registers (load_chunk / load_chunk_rows, four values a thread) and
// stored into the other buffer (store_chunk) before the step's one barrier.
// Per dim a thread reads its 8 row and 8 column values as four float4 loads
// and does 64 FMAs with them.  Each pair's dot is summed with fmaf over d
// ascending, from 0.
//
// The merge: each query row keeps its k best (score, column) entries sorted
// in shared memory; survivors of a threshold filter are queued (QCAP a row
// per round) and one warp per row inserts them with a ballot rank in
// (score, column) order, so survivors may arrive in any order and equal
// scores keep the lowest column first (the Pallas merge's first-argmin).
//
// Operands may be float or __nv_bfloat16; bf16 values are upcast exactly as
// they are staged, and every sum runs in fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

namespace tile {

constexpr int TQ = 128;       // query rows per tile
constexpr int TC = 128;       // candidate columns per tile
constexpr int BK = 8;         // dims per staged chunk
constexpr int THREADS = 256;  // 16 x 16 threads, 8 x 8 scores each
constexpr int LD = TQ + 4;    // row stride (floats) of a transposed chunk
constexpr int CHUNK = BK * LD;  // floats of one staged chunk
constexpr int QCAP = 32;      // queued survivors per query row per round
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Row (or column) of the tile held by register slot i of thread coordinate
// t: two runs of four, 64 apart, so each is one float4 read.
__device__ __forceinline__ int slot_of(int t, int i) {
  return (i < 4 ? 0 : 64) + 4 * t + (i & 3);
}

// (a, ca) < (b, cb) in (score, column) order.
__device__ __forceinline__ bool before(float a, int ca, float b, int cb) {
  return a < b || (a == b && ca < cb);
}

// This thread's share of the chunk (dims d0..d0+BK) of the 128 rows
// r0..r0+127 of `src` (row stride `stride`): rows >= r_end and dims >= d_end
// read as 0.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ src, long long stride,
                                           long long r0, long long r_end, int d0,
                                           int d_end, float (&reg)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int e = threadIdx.x + u * THREADS;
    const long long r = r0 + (e >> 3);
    const int d = d0 + (e & 7);
    reg[u] = (r < r_end && d < d_end) ? to_f32(src[r * stride + d]) : 0.f;
  }
}

// As load_chunk for gathered rows: tile row r is row rows[r] of `src`
// (rows[r] < 0 reads as 0).
template <typename T>
__device__ __forceinline__ void load_chunk_rows(const T* __restrict__ src, long long stride,
                                                const int* rows, int d0, int d_end,
                                                float (&reg)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int e = threadIdx.x + u * THREADS;
    const int r = rows[e >> 3];
    const int d = d0 + (e & 7);
    reg[u] = (r >= 0 && d < d_end) ? to_f32(src[(long long)r * stride + d]) : 0.f;
  }
}

__device__ __forceinline__ void store_chunk(float* dst, const float (&reg)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int e = threadIdx.x + u * THREADS;
    dst[(e & 7) * LD + (e >> 3)] = reg[u];
  }
}

// Score one staged chunk of nd <= BK dims: acc[i][j] += q_i * c_j.  With
// NORM, thread t also sums the squares of its own tile row: column t of
// the candidate chunk (t < TC) or row t - TC of the query chunk.  With
// WHOLE, a whole chunk (nd == BK) runs unpredicated, so the compiler may
// load a dim's operands while the previous dim's FMAs issue (the same sums
// in the same order; knn_topk.cu keeps the predicated form it was tuned
// with).
template <bool NORM, bool WHOLE = true>
__device__ __forceinline__ void fma_chunk(const float* qb, const float* cb, int nd,
                                          float (&acc)[8][8], float& norm) {
  const int t = threadIdx.x;
  const int tx = t & 15;
  const int ty = t >> 4;
#pragma unroll
  for (int dd = 0; dd < BK; ++dd) {
    if ((WHOLE && nd == BK) || dd < nd) {
      const float4 a0 = *reinterpret_cast<const float4*>(qb + dd * LD + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(qb + dd * LD + 64 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(cb + dd * LD + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(cb + dd * LD + 64 + 4 * tx);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      if (NORM) {
        const float x = t < TC ? cb[dd * LD + t] : qb[dd * LD + t - TC];
        norm = fmaf(x, x, norm);
      }
    }
  }
}

// Merge each row's queued survivors (q_d, q_c: [TQ][QCAP], q_cnt of them)
// into its sorted list (top_d, top_c: [TQ][KMAX], k live): warp w takes rows
// w, w + 8, ...  A survivor that no longer precedes the k-th entry, or that
// drop(row, column) rejects, is skipped.  Then the row's k-th entry goes to
// worst_d / worst_c and its queue count to 0.
template <int KMAX, typename Drop>
__device__ __forceinline__ void merge_queues(float* top_d, int* top_c, const float* q_d,
                                             const int* q_c, int* q_cnt, float* worst_d,
                                             int* worst_c, int k, Drop drop) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int row = warp; row < TQ; row += THREADS / 32) {
    const int n = min(q_cnt[row], QCAP);
    if (n == 0) continue;
    float d = lane < KMAX ? top_d[row * KMAX + lane] : CUDART_INF_F;
    int c = lane < KMAX ? top_c[row * KMAX + lane] : INT_MAX;
    float wd = __shfl_sync(FULL, d, k - 1);
    int wc = __shfl_sync(FULL, c, k - 1);
    for (int e = 0; e < n; ++e) {
      const float s = q_d[row * QCAP + e];
      const int g = q_c[row * QCAP + e];
      if (!before(s, g, wd, wc) || drop(row, g)) continue;
      const int pos = __popc(__ballot_sync(FULL, before(d, c, s, g)));
      const float ud = __shfl_up_sync(FULL, d, 1);
      const int uc = __shfl_up_sync(FULL, c, 1);
      if (lane > pos) {
        d = ud;
        c = uc;
      } else if (lane == pos) {
        d = s;
        c = g;
      }
      wd = __shfl_sync(FULL, d, k - 1);
      wc = __shfl_sync(FULL, c, k - 1);
    }
    if (lane < KMAX) {
      top_d[row * KMAX + lane] = d;
      top_c[row * KMAX + lane] = c;
    }
    if (lane == 0) {
      worst_d[row] = wd;
      worst_c[row] = wc;
      q_cnt[row] = 0;
    }
  }
}

}  // namespace tile

// Run `__VA_ARGS__` with constexpr KMAX (smallest of 8/16/32 holding k) in
// scope.
#define DISPATCH_KMAX(k, ...)                                             \
  do {                                                                    \
    if ((k) <= 8) {                                                       \
      constexpr int KMAX = 8;                                             \
      __VA_ARGS__;                                                        \
    } else if ((k) <= 16) {                                               \
      constexpr int KMAX = 16;                                            \
      __VA_ARGS__;                                                        \
    } else {                                                              \
      constexpr int KMAX = 32;                                            \
      __VA_ARGS__;                                                        \
    }                                                                     \
  } while (0)

// Run `__VA_ARGS__` with constexpr bool IP (the metric: true for the
// negated inner product -q.c, false for squared L2) in scope.
#define DISPATCH_IP(ip, ...)                                              \
  do {                                                                    \
    if (ip) {                                                             \
      constexpr bool IP = true;                                           \
      __VA_ARGS__;                                                        \
    } else {                                                              \
      constexpr bool IP = false;                                          \
      __VA_ARGS__;                                                        \
    }                                                                     \
  } while (0)
