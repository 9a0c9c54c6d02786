// Exact k nearest candidates per query over a contiguous candidate array:
// the brute certification lane's kernel.
//
// Replaces: src/repro/kernels/knn_topk/kernel.py, knn_tile_topk (pallas_call
// at :119, body _knn_topk_kernel / _tile_topk :41).  The TPU kernel wrote
// one k-row partial per (query tile x block_c candidate tile) and ops.py
// merged the (C / block_c, Q, k) partials.  Here each thread block owns a
// query tile and one contiguous *split* of the candidates and walks its
// block_c tiles itself, so the cross-tile merge is fused into the running
// top-k and only (n_splits, Q, k) partials remain; ops.knn_topk merges
// those with a stable sort, keeping split order, so the result equals the
// TPU path's (first-argmin ties, lowest candidate column first).
//
// What it computes: d = max(|q|^2 + |c|^2 - 2 q.c, 0), or d = -q.c
// (unclamped) under the ip metric, with rows where cand_id < 0 or cand_id ==
// query_id excluded, reduced to the k smallest (distance, id) pairs; ids
// are -1 where the distance is inf.
//
// What bounds it on an H100: operations.  Every candidate tile staged in
// shared memory is reused by block_q queries, so the fp32 FMA pipe and the
// register top-k insertion, not HBM, set the pace.
//
// What the design does about it: each thread keeps its query and its top-k
// in registers (Query<DP>, RunningTopK<KMAX>) and reads staged candidate
// rows as float4 broadcasts, one shared load per four FMAs.  The brute lane
// calls it with few queries against a large corpus or with millions of
// queries; splitting the candidates across blocks (the wrapper sizes
// n_splits to give every SM work) keeps the card busy when there are only
// a handful of query tiles.
#include <cuda_runtime.h>

#include "topk.cuh"

template <int KMAX, int DP, bool IP>
__global__ void knn_topk_kernel(
    const float* __restrict__ queries, const float* __restrict__ cands,
    const int* __restrict__ query_ids, const int* __restrict__ cand_ids,
    float* __restrict__ out_d, int* __restrict__ out_i, int n_q, int n_c,
    int dim, int k, int block_q, int block_c, long long per_split) {
  extern __shared__ __align__(16) float smem[];
  const int stride = DP > 0 ? DP : dim;
  float* c_s = smem;                                   // [block_c][stride]
  float* cc_s = c_s + block_c * stride;                // [block_c]
  int* id_s = reinterpret_cast<int*>(cc_s + block_c);  // [block_c]
  float* q_s = reinterpret_cast<float*>(id_s + block_c);  // generic path only

  const long long q0 = (long long)blockIdx.x * block_q;
  const long long row = q0 + threadIdx.x;
  const bool active = row < n_q;
  Query<DP> q;
  q.load(queries + q0 * dim, (long long)n_q - q0, dim, block_q, q_s);
  const int qid = active ? query_ids[row] : -1;

  RunningTopK<KMAX> top;
  top.init(k);

  const long long c_begin = blockIdx.y * per_split;
  const long long c_end = min((long long)n_c, c_begin + per_split);
  for (long long c0 = c_begin; c0 < c_end; c0 += block_c) {
    const int n = (int)min((long long)block_c, c_end - c0);
    __syncthreads();  // the previous tile's readers are done
    for (int r = threadIdx.x; r < block_c; r += blockDim.x) {
      id_s[r] = r < n ? cand_ids[c0 + r] : -1;
    }
    stage_rows(cands + c0 * dim, n, block_c, dim, stride, c_s, cc_s);

    for (int r = 0; r < n; ++r) {
      const int cid = id_s[r];
      if (cid < 0 || cid == qid) continue;
      const float dot = q.dot(c_s + r * stride);
      top.push(IP ? -dot : fmaxf(q.qq + cc_s[r] - 2.f * dot, 0.f), cid);
    }
  }
  if (active) {
    const long long off = (long long)blockIdx.y * n_q * k;
    top.store(out_d + off, out_i + off, row);
  }
}

template <int KMAX, int DP, bool IP>
static cudaError_t launch(const float* queries, const float* cands,
                          const int* query_ids, const int* cand_ids,
                          float* out_d, int* out_i, int n_q, int n_c, int dim,
                          int k, int block_q, int block_c, int n_splits,
                          long long per_split, cudaStream_t stream) {
  const int stride = DP > 0 ? DP : dim;
  const size_t smem = sizeof(float) * ((size_t)block_c * stride + 2 * block_c +
                                       Query<DP>::smem_floats(dim, block_q));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        knn_topk_kernel<KMAX, DP, IP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((n_q + block_q - 1) / block_q, n_splits);
  knn_topk_kernel<KMAX, DP, IP><<<grid, block_q, smem, stream>>>(
      queries, cands, query_ids, cand_ids, out_d, out_i, n_q, n_c, dim, k,
      block_q, block_c, per_split);
  return cudaGetLastError();
}

// `ip` selects the metric (0: squared L2, 1: -q.c).
extern "C" int knn_topk_launch(const float* queries, const float* cands,
                               const int* query_ids, const int* cand_ids,
                               float* out_d, int* out_i, int n_q, int n_c,
                               int dim, int k, int block_q, int block_c,
                               int n_splits, long long per_split, int ip,
                               void* stream) {
  if (n_q == 0) return (int)cudaGetLastError();
  cudaError_t err;
  DISPATCH_IP(ip, DISPATCH_KMAX_DP(k, dim,
      err = (launch<KMAX, DP, IP>(queries, cands, query_ids, cand_ids, out_d,
                                  out_i, n_q, n_c, dim, k, block_q, block_c,
                                  n_splits, per_split,
                                  (cudaStream_t)stream))));
  return (int)err;
}
