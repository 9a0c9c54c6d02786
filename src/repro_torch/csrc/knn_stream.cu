// Streaming epsilon-filtered top-k over a per-tile block table: the dense
// engine's hot loop.
//
// Replaces: src/repro/kernels/knn_stream/kernel.py, knn_stream_topk_prefetch
// (scalar-prefetch block table, pallas_call at :220) and
// knn_stream_topk_padded (contiguous candidates, :275), both running
// _stream_kernel (:73).  The padded kernel is the identity-block-table case
// of this one: the wrapper passes a single shared table and id row with
// tile stride 0.
//
// What it computes, per query row of tile t: for every slot j of
// block_table[t], the block_c corpus rows starting at block_table[t, j] *
// block_c (the cell-sorted corpus, read in place) are scored with
// d = max(|q|^2 + |c|^2 - 2 q.c, 0), or d = -q.c (unclamped: ip scores may
// be negative) under the ip metric; rows with cand_id >= 0, cand_id !=
// query_id and d <= eps2 are counted into `found` and merged into a running
// top-k.  ids are -1 where the distance is inf.  Queries and corpus are
// float, or both __nv_bfloat16 (distance_dtype="bf16", half the corpus
// bytes): bf16 values are upcast on load and all arithmetic is fp32, as the
// TPU's bf16 matmul with f32 accumulation.
//
// What bounds it on an H100: operations, not bytes.  Each corpus block is
// read once per tile (block_c * dim * 4 bytes) and then used block_q times,
// so arithmetic intensity is ~block_q / 2 FMA per byte; the FMAs run on the
// fp32 pipe (exact fp32 distances are the contract, so no TF32/bf16 tensor
// cores), and the running top-k insertion costs ~3 * KMAX instructions per
// accepted candidate.
//
// What the design does about it: the TPU kernel carried its running top-k
// across a sequential grid axis in VMEM scratch.  Here one thread block owns
// one query tile and walks its block-table slots itself; each thread owns
// one query, keeps it in registers (Query<DP>, zero-padded to DP dims) and
// keeps its top-k in registers (RunningTopK, templated on KMAX in
// {8, 16, 32} so no register array is indexed at runtime).  Each corpus
// block is staged once in shared memory and read by every thread as float4
// broadcasts.  A slot whose ids are all -1 (unused schedule slots, rows
// outside the tile's cell union) is skipped before its corpus block is
// loaded, which subsumes the Pallas per-slot merge skip.
#include <cuda_runtime.h>

#include "topk.cuh"

template <int KMAX, int DP, bool IP, typename T>
__global__ void knn_stream_kernel(
    const T* __restrict__ queries, const T* __restrict__ corpus,
    const int* __restrict__ block_table, long long bt_stride,
    const int* __restrict__ query_ids, const int* __restrict__ cand_ids,
    long long cid_stride, const float* __restrict__ eps2_ptr,
    float* __restrict__ out_d, int* __restrict__ out_i,
    int* __restrict__ out_found, int nblk, int dim, int k, int block_q,
    int block_c) {
  extern __shared__ __align__(16) float smem[];
  const int stride = DP > 0 ? DP : dim;
  float* c_s = smem;                                   // [block_c][stride]
  float* cc_s = c_s + block_c * stride;                // [block_c]
  int* id_s = reinterpret_cast<int*>(cc_s + block_c);  // [block_c]
  float* q_s = reinterpret_cast<float*>(id_s + block_c);  // generic path only

  const long long tile = blockIdx.x;
  const long long row = tile * block_q + threadIdx.x;
  Query<DP> q;
  q.load(queries + tile * block_q * dim, block_q, dim, block_q, q_s);
  const int qid = query_ids[row];
  const float eps2 = *eps2_ptr;
  const int* table = block_table + tile * bt_stride;
  const int* ids = cand_ids + tile * cid_stride;

  RunningTopK<KMAX> top;
  top.init(k);
  int found = 0;

  for (int j = 0; j < nblk; ++j) {
    __syncthreads();  // the previous slot's readers are done with c_s/id_s
    int any = 0;
    for (int r = threadIdx.x; r < block_c; r += blockDim.x) {
      const int cid = ids[(long long)j * block_c + r];
      id_s[r] = cid;
      any |= cid >= 0;
    }
    if (!__syncthreads_or(any)) continue;
    stage_rows(corpus + (long long)table[j] * block_c * dim, block_c, block_c,
               dim, stride, c_s, cc_s);

    for (int r = 0; r < block_c; ++r) {
      const int cid = id_s[r];
      if (cid < 0) continue;
      const float dot = q.dot(c_s + r * stride);
      const float dist = IP ? -dot : fmaxf(q.qq + cc_s[r] - 2.f * dot, 0.f);
      if (cid != qid && dist <= eps2) {
        ++found;
        top.push(dist, cid);
      }
    }
  }
  top.store(out_d, out_i, row);
  out_found[row] = found;
}

template <int KMAX, int DP, bool IP, typename T>
static cudaError_t launch(const T* queries, const T* corpus,
                          const int* block_table, long long bt_stride,
                          const int* query_ids, const int* cand_ids,
                          long long cid_stride, const float* eps2,
                          float* out_d, int* out_i, int* out_found,
                          int n_tiles, int nblk, int dim, int k, int block_q,
                          int block_c, cudaStream_t stream) {
  const int stride = DP > 0 ? DP : dim;
  const size_t smem = sizeof(float) * ((size_t)block_c * stride + 2 * block_c +
                                       Query<DP>::smem_floats(dim, block_q));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        knn_stream_kernel<KMAX, DP, IP, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  knn_stream_kernel<KMAX, DP, IP, T><<<n_tiles, block_q, smem, stream>>>(
      queries, corpus, block_table, bt_stride, query_ids, cand_ids,
      cid_stride, eps2, out_d, out_i, out_found, nblk, dim, k, block_q,
      block_c);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch(const void* queries, const void* corpus,
                            const int* block_table, long long bt_stride,
                            const int* query_ids, const int* cand_ids,
                            long long cid_stride, const float* eps2,
                            float* out_d, int* out_i, int* out_found,
                            int n_tiles, int nblk, int dim, int k, int block_q,
                            int block_c, int ip, cudaStream_t stream) {
  cudaError_t err;
  DISPATCH_IP(ip, DISPATCH_KMAX_DP(k, dim,
      err = (launch<KMAX, DP, IP, T>(
          static_cast<const T*>(queries), static_cast<const T*>(corpus),
          block_table, bt_stride, query_ids, cand_ids, cid_stride, eps2,
          out_d, out_i, out_found, n_tiles, nblk, dim, k, block_q, block_c,
          stream))));
  return err;
}

// `bf16` selects the operand type of queries and corpus (0: float,
// 1: __nv_bfloat16); `ip` the metric (0: squared L2, 1: -q.c).
extern "C" int knn_stream_topk_launch(
    const void* queries, const void* corpus, const int* block_table,
    long long bt_stride, const int* query_ids, const int* cand_ids,
    long long cid_stride, const float* eps2, float* out_d, int* out_i,
    int* out_found, int n_tiles, int nblk, int dim, int k, int block_q,
    int block_c, int ip, int bf16, void* stream) {
  if (n_tiles == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(queries, corpus, block_table, bt_stride,
                                     query_ids, cand_ids, cid_stride, eps2,
                                     out_d, out_i, out_found, n_tiles, nblk,
                                     dim, k, block_q, block_c, ip, s)
           : dispatch<float>(queries, corpus, block_table, bt_stride,
                             query_ids, cand_ids, cid_stride, eps2, out_d,
                             out_i, out_found, n_tiles, nblk, dim, k, block_q,
                             block_c, ip, s);
  return (int)err;
}
