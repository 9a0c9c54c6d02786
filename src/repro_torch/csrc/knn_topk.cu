// Exact k nearest candidates per query over a contiguous candidate array:
// the brute certification lane's kernel.
//
// Replaces: src/repro/kernels/knn_topk/kernel.py, knn_tile_topk (pallas_call
// at :119, body _knn_topk_kernel / _tile_topk :41).  The TPU kernel wrote
// one k-row partial per (query tile x block_c candidate tile) and ops.py
// merged the (C / block_c, Q, k) partials.  Here each thread block owns a
// 128-query tile and one contiguous *split* of the candidates and walks its
// 128-candidate tiles itself, so the cross-tile merge is fused into a
// running top-k and only (n_splits, Q, k) partials remain; ops.knn_topk
// merges those with a stable sort, keeping split order, so the result equals
// the TPU path's (first-argmin ties, lowest candidate column first).
//
// What it computes: d = max(|q|^2 + |c|^2 - 2 q.c, 0), or d = -q.c
// (unclamped) under the ip metric, with rows where cand_id < 0 or cand_id ==
// query_id excluded, reduced to the k smallest (distance, id) pairs; ids
// are -1 where the distance is inf.
//
// What bounds it on an H100: fp32 operations.  Every pair costs 2 * dim
// FLOPs of dot product (plus 3 for the expansion), and each staged candidate
// is reused by 128 queries, so HBM is far from the limit; exact fp32 is the
// contract, so the FMAs run on the CUDA cores (no TF32 / bf16 tensor cores).
//
// What the design does about it:
//  - A register-tiled distance tile, as in pairwise_l2.cu: 256 threads
//    compute a 128 x 128 score tile, 8 x 8 per thread.  The d axis is staged
//    in chunks of BK dims, transposed, double-buffered in shared memory (any
//    width fits); each thread reads its 8 query and 8 candidate values per
//    dim as four float4 loads and does 64 FMAs with them.
//  - A threshold filter before any insertion: each query's current k-th
//    best (score, column) sits in shared memory; a score is compared with it
//    and only survivors are queued (per query, QCAP slots).  Over a large
//    split a query sees ~k ln(C / k) survivors, so after the first tiles the
//    top-k costs about one compare per pair (a row minimum and one compare
//    per query row of a thread's 8 x 8 scores).
//  - The top-k lists live in shared memory, not in registers, so the
//    accumulators alone set the register budget (two blocks per SM).  One
//    warp merges a query's queued survivors into its list, one survivor per
//    step: a ballot finds its rank, a shuffle shifts the tail.  Entries are
//    ordered by (score, column), so survivors may arrive in any order and
//    equal scores still keep the lowest column first.  A queue that
//    overflows is drained and the rejected survivors are filtered again.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

#include "topk.cuh"

namespace {

constexpr int TQ = 128;       // queries per block tile
constexpr int TC = 128;       // candidates per block tile
constexpr int BK = 8;         // dims per staged chunk
constexpr int THREADS = 256;  // 16 x 16 threads, 8 x 8 scores each
constexpr int LD = TQ + 4;    // row stride (floats) of a transposed chunk
constexpr int QCAP = 32;      // queued survivors per query per round
constexpr int CHUNK = BK * LD;                // floats of one staged chunk
constexpr unsigned FULL = 0xffffffffu;

// Row (or column) of the tile held by register slot i of thread coordinate
// t: two runs of four, 64 apart, so each is one float4 read.
__device__ __forceinline__ int slot_of(int t, int i) {
  return (i < 4 ? 0 : 64) + 4 * t + (i & 3);
}

// (a, ca) < (b, cb) in (score, column) order.
__device__ __forceinline__ bool before(float a, int ca, float b, int cb) {
  return a < b || (a == b && ca < cb);
}

// Load this thread's share of the chunk (dims d0..d0+BK) of a 128-row tile
// starting at row r0 (rows >= r_end and dims >= dim read as 0).
__device__ __forceinline__ void load_chunk(const float* __restrict__ src,
                                           long long r0, long long r_end,
                                           int d0, int dim, float (&reg)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int e = threadIdx.x + u * THREADS;
    const long long r = r0 + (e >> 3);
    const int d = d0 + (e & 7);
    reg[u] = (r < r_end && d < dim) ? src[r * dim + d] : 0.f;
  }
}

__device__ __forceinline__ void store_chunk(float* dst, const float (&reg)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int e = threadIdx.x + u * THREADS;
    dst[(e & 7) * LD + (e >> 3)] = reg[u];
  }
}

template <int KMAX, bool IP>
__global__ void __launch_bounds__(THREADS, 2)
knn_topk_kernel(const float* __restrict__ queries,
                const float* __restrict__ cands,
                const int* __restrict__ query_ids,
                const int* __restrict__ cand_ids, float* __restrict__ out_d,
                int* __restrict__ out_i, int n_q, int n_c, int dim, int k,
                long long per_split) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                         // [2][BK][LD] query chunks
  float* cs = qs + 2 * CHUNK;               // [2][BK][LD] candidate chunks
  float* top_d = cs + 2 * CHUNK;            // [TQ][KMAX] sorted scores
  int* top_c = reinterpret_cast<int*>(top_d + TQ * KMAX);  // their columns
  float* q_d = reinterpret_cast<float*>(top_c + TQ * KMAX);  // [TQ][QCAP]
  int* q_c = reinterpret_cast<int*>(q_d + TQ * QCAP);        // [TQ][QCAP]
  float* worst_d = reinterpret_cast<float*>(q_c + TQ * QCAP);  // [TQ]
  int* worst_c = reinterpret_cast<int*>(worst_d + TQ);         // [TQ]
  int* q_cnt = worst_c + TQ;                                   // [TQ]
  int* qid_s = q_cnt + TQ;                                     // [TQ]
  int* cid_s = qid_s + TQ;                                     // [TC]
  float* qq_s = reinterpret_cast<float*>(cid_s + TC);          // [TQ]
  float* cc_s = qq_s + TQ;                                     // [TC]

  const int t = threadIdx.x;
  const int tx = t & 15;
  const int ty = t >> 4;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long q0 = (long long)blockIdx.x * TQ;
  const long long c_begin = blockIdx.y * per_split;
  const long long c_end = min((long long)n_c, c_begin + per_split);

  if (t < TQ) {
    const bool active = q0 + t < n_q;
    qid_s[t] = active ? query_ids[q0 + t] : -1;
    worst_d[t] = active ? CUDART_INF_F : -CUDART_INF_F;  // padding rows take nothing
    worst_c[t] = active ? INT_MAX : INT_MIN;
    q_cnt[t] = 0;
  }
  for (int e = t; e < TQ * KMAX; e += THREADS) {
    top_d[e] = CUDART_INF_F;
    top_c[e] = INT_MAX;
  }

  float reg_q[4], reg_c[4];
  if (c_begin < c_end) {
    load_chunk(queries, q0, n_q, 0, dim, reg_q);
    load_chunk(cands, c_begin, c_end, 0, dim, reg_c);
    store_chunk(qs, reg_q);
    store_chunk(cs, reg_c);
  }
  __syncthreads();
  int buf = 0;

  for (long long c0 = c_begin; c0 < c_end; c0 += TC) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    float norm = 0.f;  // threads < 128: |c|^2 of column t; others |q|^2 of row t - 128

    for (int d0 = 0; d0 < dim; d0 += BK) {
      // Prefetch the next chunk (of this tile, or the first of the next).
      const bool more_d = d0 + BK < dim;
      const bool next = more_d || c0 + TC < c_end;
      if (next) {
        const int nd0 = more_d ? d0 + BK : 0;
        load_chunk(queries, q0, n_q, nd0, dim, reg_q);
        load_chunk(cands, more_d ? c0 : c0 + TC, c_end, nd0, dim, reg_c);
      }
      const float* qb = qs + buf * CHUNK;
      const float* cb = cs + buf * CHUNK;
      const int nd = min(BK, dim - d0);
#pragma unroll
      for (int dd = 0; dd < BK; ++dd) {
        if (dd < nd) {
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
          if (!IP) {
            const float x = t < TC ? cb[dd * LD + t] : qb[dd * LD + t - TC];
            norm = fmaf(x, x, norm);
          }
        }
      }
      if (next) {
        store_chunk(qs + (buf ^ 1) * CHUNK, reg_q);
        store_chunk(cs + (buf ^ 1) * CHUNK, reg_c);
      }
      __syncthreads();
      buf ^= 1;
    }

    // Scores of the tile; a column with cand_id < 0 scores NaN, which no
    // comparison lets through.  Then the threshold filter.
    if (t < TC) {
      cid_s[t] = c0 + t < c_end ? cand_ids[c0 + t] : -1;
      cc_s[t] = norm;
    } else {
      qq_s[t - TC] = norm;
    }
    __syncthreads();
    float cmask[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) cmask[j] = cid_s[slot_of(tx, j)] < 0 ? CUDART_NAN_F : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float qq = qq_s[slot_of(ty, i)];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float s = IP ? -acc[i][j]
                           : fmaxf(qq + cc_s[slot_of(tx, j)] - 2.f * acc[i][j], 0.f);
        acc[i][j] = s + cmask[j];
      }
    }

    unsigned long long done = 0ull;  // bit 8i+j: queued, or out of the running
    bool first = true;
    while (true) {
      int tried = 0, overflow = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = slot_of(ty, i);
        const float wd = worst_d[row];
        const int wc = worst_c[row];
        if (first) {
          // In the first round every listed column precedes this tile, so
          // only a strictly smaller score can change the list's output: one
          // compare per row settles the common case of none (fminf skips
          // the NaN of masked columns).
          float low = acc[i][0];
#pragma unroll
          for (int j = 1; j < 8; ++j) low = fminf(low, acc[i][j]);
          if (!(low < wd)) {
            done |= 0xffull << (8 * i);
            continue;
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const unsigned long long bit = 1ull << (8 * i + j);
          const int gcol = (int)(c0 + slot_of(tx, j));
          if ((done & bit) || !before(acc[i][j], gcol, wd, wc)) {
            done |= bit;  // the k-th best only improves: it stays out
            continue;
          }
          tried = 1;
          const int slot = atomicAdd(&q_cnt[row], 1);
          if (slot < QCAP) {
            q_d[row * QCAP + slot] = acc[i][j];
            q_c[row * QCAP + slot] = gcol;
            done |= bit;
          } else {
            overflow = 1;
          }
        }
      }
      first = false;
      if (!__syncthreads_or(tried)) break;

      // Merge each query's queue into its list: warp w takes rows w, w+8, ...
      for (int row = warp; row < TQ; row += THREADS / 32) {
        const int n = min(q_cnt[row], QCAP);
        if (n == 0) continue;
        const int qid = qid_s[row];
        float d = lane < KMAX ? top_d[row * KMAX + lane] : CUDART_INF_F;
        int c = lane < KMAX ? top_c[row * KMAX + lane] : INT_MAX;
        float wd = __shfl_sync(FULL, d, k - 1);
        int wc = __shfl_sync(FULL, c, k - 1);
        for (int e = 0; e < n; ++e) {
          const float s = q_d[row * QCAP + e];
          const int g = q_c[row * QCAP + e];
          // The self pair passes the filter (it is rare); it is dropped here.
          if (!before(s, g, wd, wc) || cid_s[g - c0] == qid) continue;
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
      if (!__syncthreads_or(overflow)) break;
    }
  }

  __syncthreads();
  const long long off = (long long)blockIdx.y * n_q * k;
  for (int e = t; e < TQ * k; e += THREADS) {
    const int r = e / k;
    const int p = e - r * k;
    if (q0 + r < n_q) {
      const float d = top_d[r * KMAX + p];
      out_d[off + (q0 + r) * k + p] = d;
      out_i[off + (q0 + r) * k + p] = isinf(d) ? -1 : cand_ids[top_c[r * KMAX + p]];
    }
  }
}

// Dynamic shared memory of one block (the wrapper's plan mirrors it).
template <int KMAX>
constexpr size_t smem_bytes() {
  return sizeof(float) * (4 * CHUNK + 2 * TQ * KMAX + 2 * TQ * QCAP + 7 * TQ);
}

template <int KMAX, bool IP>
cudaError_t launch(const float* queries, const float* cands,
                   const int* query_ids, const int* cand_ids, float* out_d,
                   int* out_i, int n_q, int n_c, int dim, int k, int n_splits,
                   long long per_split, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<KMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      knn_topk_kernel<KMAX, IP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_q + TQ - 1) / TQ, n_splits);
  knn_topk_kernel<KMAX, IP><<<grid, THREADS, smem, stream>>>(
      queries, cands, query_ids, cand_ids, out_d, out_i, n_q, n_c, dim, k,
      per_split);
  return cudaGetLastError();
}

}  // namespace

// `ip` selects the metric (0: squared L2, 1: -q.c).  Splits are per_split
// candidates wide; the grid is (ceil(n_q / 128), n_splits).
extern "C" int knn_topk_launch(const float* queries, const float* cands,
                               const int* query_ids, const int* cand_ids,
                               float* out_d, int* out_i, int n_q, int n_c,
                               int dim, int k, int n_splits,
                               long long per_split, int ip, void* stream) {
  if (n_q == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  DISPATCH_IP(ip, DISPATCH_KMAX(k,
      err = (launch<KMAX, IP>(queries, cands, query_ids, cand_ids, out_d,
                              out_i, n_q, n_c, dim, k, n_splits, per_split,
                              s))));
  return (int)err;
}
