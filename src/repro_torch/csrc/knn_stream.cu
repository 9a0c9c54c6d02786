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
// one query and keeps its top-k in registers (RunningTopK, templated on KMAX
// in {8, 16, 32} so no register array is indexed at runtime).  A slot whose
// ids are all -1 (unused schedule slots, rows outside the tile's cell union)
// is skipped before its corpus block is loaded, which subsumes the Pallas
// per-slot merge skip.  Two kernels share that skeleton:
//  - narrow rows (dim <= 32): the query row sits in registers (Query<DP>,
//    zero-padded to DP dims) and each corpus block is staged once in shared
//    memory and read by every thread as float4 broadcasts;
//  - wide rows (any dim > 32): the query tile and the corpus rows are staged
//    in d-chunks of WD dims (8 loads in flight per thread), a group of WG
//    candidates at a time.  Each thread
//    keeps the partial dots of its query with the group's WG candidates in
//    registers across the chunks, then pushes the group in column order, so
//    the tie rule is the narrow kernel's.  Shared memory is
//    WD * (block_q + 1) + WG * (WD + 1) floats at any width.
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
  constexpr int stride = DP;
  float* c_s = smem;                                   // [block_c][stride]
  float* cc_s = c_s + block_c * stride;                // [block_c]
  int* id_s = reinterpret_cast<int*>(cc_s + block_c);  // [block_c]

  const long long tile = blockIdx.x;
  const long long row = tile * block_q + threadIdx.x;
  Query<DP> q;
  q.load(queries + tile * block_q * dim, block_q, dim);
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

// Copy n elements into shared memory, element e read by load(e) and written
// by store(e, v), with UNROLL loads in flight per thread: a plain strided
// loop whose trip count the compiler cannot see waits out each load's
// latency before it starts the next.
template <int UNROLL, typename Load, typename Store>
__device__ __forceinline__ void stage_copy(int n, Load load, Store store) {
  for (int e0 = threadIdx.x; e0 < n; e0 += UNROLL * blockDim.x) {
    float v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int e = e0 + u * blockDim.x;
      v[u] = e < n ? load(e) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < n) store(e, v[u]);
    }
  }
}

constexpr int WG = 32;  // candidates per group (partial dots in registers)
constexpr int WD = 32;  // dims per staged chunk
static_assert(WG <= WD, "a group's dots are parked in the query chunk's rows");

template <int KMAX, bool IP, typename T>
__global__ void knn_stream_wide_kernel(
    const T* __restrict__ queries, const T* __restrict__ corpus,
    const int* __restrict__ block_table, long long bt_stride,
    const int* __restrict__ query_ids, const int* __restrict__ cand_ids,
    long long cid_stride, const float* __restrict__ eps2_ptr,
    float* __restrict__ out_d, int* __restrict__ out_i,
    int* __restrict__ out_found, int nblk, int dim, int k, int block_q,
    int block_c) {
  extern __shared__ __align__(16) float smem[];
  const int ldq = block_q + 1;
  float* q_s = smem;                          // [WD][ldq] transposed query chunk
  float* c_s = q_s + WD * ldq;                // [WG][WD] corpus chunk
  float* cc_s = c_s + WG * WD;                // [WG]
  int* id_s = reinterpret_cast<int*>(cc_s + WG);  // [block_c rounded up to WG]
  const int n_ids = (block_c + WG - 1) / WG * WG;

  const int t = threadIdx.x;
  const long long tile = blockIdx.x;
  const long long row = tile * block_q + t;
  const T* q_tile = queries + tile * block_q * dim;

  // Stage dims d0..d0+WD of the query tile, transposed (zero past dim).
  auto stage_queries = [&](int d0, int nd) {
    stage_copy<8>(
        block_q * WD,
        [&](int e) {
          const int r = e / WD;
          const int d = e - r * WD;
          return d < nd ? to_f32(q_tile[(long long)r * dim + d0 + d]) : 0.f;
        },
        [&](int e, float v) { q_s[(e % WD) * ldq + e / WD] = v; });
  };

  float qq = 0.f;
  if (!IP) {
    for (int d0 = 0; d0 < dim; d0 += WD) {
      const int nd = min(WD, dim - d0);
      __syncthreads();
      stage_queries(d0, nd);
      __syncthreads();
      for (int d = 0; d < nd; ++d) qq = fmaf(q_s[d * ldq + t], q_s[d * ldq + t], qq);
    }
  }
  const int qid = query_ids[row];
  const float eps2 = *eps2_ptr;
  const int* table = block_table + tile * bt_stride;
  const int* ids = cand_ids + tile * cid_stride;

  RunningTopK<KMAX> top;
  top.init(k);
  int found = 0;

  for (int j = 0; j < nblk; ++j) {
    __syncthreads();  // the previous slot's readers are done with id_s
    int any = 0;
    for (int r = t; r < n_ids; r += blockDim.x) {
      const int cid = r < block_c ? ids[(long long)j * block_c + r] : -1;
      id_s[r] = cid;
      any |= cid >= 0;
    }
    if (!__syncthreads_or(any)) continue;
    const T* blk = corpus + (long long)table[j] * block_c * dim;

    for (int g0 = 0; g0 < block_c; g0 += WG) {
      bool live = false;
#pragma unroll
      for (int g = 0; g < WG; ++g) live |= id_s[g0 + g] >= 0;
      if (!live) continue;  // the same answer in every thread
      float dot[WG];
#pragma unroll
      for (int g = 0; g < WG; ++g) dot[g] = 0.f;
      float cc = 0.f;  // thread g < WG: |c|^2 of the group's row g
      for (int d0 = 0; d0 < dim; d0 += WD) {
        const int nd = min(WD, dim - d0);
        __syncthreads();  // the previous chunk's readers are done
        stage_queries(d0, nd);
        stage_copy<8>(
            WG * WD,
            [&](int e) {
              const int r = e / WD;
              const int d = e - r * WD;
              return (g0 + r < block_c && d < nd)
                         ? to_f32(blk[(long long)(g0 + r) * dim + d0 + d]) : 0.f;
            },
            [&](int e, float v) { c_s[e] = v; });
        __syncthreads();
        if (!IP && t < WG) {
          for (int d = 0; d < nd; ++d) cc = fmaf(c_s[t * WD + d], c_s[t * WD + d], cc);
        }
        const float4* c4 = reinterpret_cast<const float4*>(c_s);
        for (int d4 = 0; d4 < (nd + 3) / 4; ++d4) {
          const float x0 = q_s[(4 * d4) * ldq + t];
          const float x1 = q_s[(4 * d4 + 1) * ldq + t];
          const float x2 = q_s[(4 * d4 + 2) * ldq + t];
          const float x3 = q_s[(4 * d4 + 3) * ldq + t];
#pragma unroll
          for (int g = 0; g < WG; ++g) {
            const float4 c = c4[g * (WD / 4) + d4];
            dot[g] = fmaf(x0, c.x, dot[g]);
            dot[g] = fmaf(x1, c.y, dot[g]);
            dot[g] = fmaf(x2, c.z, dot[g]);
            dot[g] = fmaf(x3, c.w, dot[g]);
          }
        }
      }
      // Park the dots in this thread's own column of the query chunk (only
      // thread t reads column t there) so that the push loop below needs no
      // register indexing and is not unrolled WG times.
#pragma unroll
      for (int g = 0; g < WG; ++g) q_s[g * ldq + t] = dot[g];
      if (!IP && t < WG) cc_s[t] = cc;
      __syncthreads();
#pragma unroll 1
      for (int g = 0; g < WG; ++g) {
        const int cid = id_s[g0 + g];
        if (cid < 0) continue;
        const float dt = q_s[g * ldq + t];
        const float dist = IP ? -dt : fmaxf(qq + cc_s[g] - 2.f * dt, 0.f);
        if (cid != qid && dist <= eps2) {
          ++found;
          top.push(dist, cid);
        }
      }
    }
  }
  top.store(out_d, out_i, row);
  out_found[row] = found;
}

template <typename K>
static cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// Dynamic shared memory of one block (the wrapper's plan mirrors it).
static size_t smem_bytes(int dim, int block_q, int block_c) {
  const int dp = query_pad(dim);
  if (dp > 0) return sizeof(float) * ((size_t)block_c * dp + 2 * block_c);
  return sizeof(float) * ((size_t)WD * (block_q + 1) + WG * WD + WG +
                          (size_t)(block_c + WG - 1) / WG * WG);
}

template <typename T>
static cudaError_t dispatch(const void* queries, const void* corpus,
                            const int* block_table, long long bt_stride,
                            const int* query_ids, const int* cand_ids,
                            long long cid_stride, const float* eps2,
                            float* out_d, int* out_i, int* out_found,
                            int n_tiles, int nblk, int dim, int k, int block_q,
                            int block_c, int ip, cudaStream_t stream) {
  const T* q = static_cast<const T*>(queries);
  const T* c = static_cast<const T*>(corpus);
  const size_t smem = smem_bytes(dim, block_q, block_c);
  const int dp = query_pad(dim);
  cudaError_t err = cudaErrorInvalidValue;
  DISPATCH_IP(ip, DISPATCH_KMAX(k,
      if (dp > 0) {
        DISPATCH_DP(dp,
            auto kern = knn_stream_kernel<KMAX, DP, IP, T>;
            err = allow_smem(kern, smem);
            if (err == cudaSuccess) {
              kern<<<n_tiles, block_q, smem, stream>>>(
                  q, c, block_table, bt_stride, query_ids, cand_ids,
                  cid_stride, eps2, out_d, out_i, out_found, nblk, dim, k,
                  block_q, block_c);
              err = cudaGetLastError();
            });
      } else {
        auto kern = knn_stream_wide_kernel<KMAX, IP, T>;
        err = allow_smem(kern, smem);
        if (err == cudaSuccess) {
          kern<<<n_tiles, block_q, smem, stream>>>(
              q, c, block_table, bt_stride, query_ids, cand_ids, cid_stride,
              eps2, out_d, out_i, out_found, nblk, dim, k, block_q, block_c);
          err = cudaGetLastError();
        }
      }));
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
