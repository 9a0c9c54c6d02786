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
//  - The register-tiled score tile of score_tile.cuh: 256 threads compute a
//    128 x 128 score tile, 8 x 8 per thread.  The d axis is staged in chunks
//    of BK dims, transposed, double-buffered in shared memory (any width
//    fits); each thread reads its 8 query and 8 candidate values per dim as
//    four float4 loads and does 64 FMAs with them.
//  - A threshold filter before any insertion: each query's current k-th
//    best (score, column) sits in shared memory; a score is compared with it
//    and only survivors are queued (per query, QCAP slots).  Over a large
//    split a query sees ~k ln(C / k) survivors, so after the first tiles the
//    top-k costs about one compare per pair (a row minimum and one compare
//    per query row of a thread's 8 x 8 scores).
//  - The top-k lists live in shared memory, not in registers, so the
//    accumulators alone set the register budget (two blocks per SM).  One
//    warp merges a query's queued survivors into its list, one survivor per
//    step: a ballot finds its rank, a shuffle shifts the tail
//    (score_tile.cuh's merge_queues).  Entries are ordered by (score,
//    column), so survivors may arrive in any order and equal scores still
//    keep the lowest column first.  A queue that overflows is drained and
//    the rejected survivors are filtered again.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

#include "score_tile.cuh"

namespace {

using namespace tile;

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
    load_chunk(queries, dim, q0, n_q, 0, dim, reg_q);
    load_chunk(cands, dim, c_begin, c_end, 0, dim, reg_c);
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
        load_chunk(queries, dim, q0, n_q, nd0, dim, reg_q);
        load_chunk(cands, dim, more_d ? c0 : c0 + TC, c_end, nd0, dim, reg_c);
      }
      const float* qb = qs + buf * CHUNK;
      const float* cb = cs + buf * CHUNK;
      fma_chunk<!IP, false>(qb, cb, min(BK, dim - d0), acc, norm);
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

      // Merge each query's queue into its list.  The self pair passes the
      // filter (it is rare); it is dropped here.
      merge_queues<KMAX>(top_d, top_c, q_d, q_c, q_cnt, worst_d, worst_c, k,
                         [&](int row, int g) { return cid_s[g - c0] == qid_s[row]; });
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
