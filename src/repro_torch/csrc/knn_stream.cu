// Streaming epsilon-filtered top-k over a per-tile block table: the dense
// engine's hot loop.
//
// Replaces: src/repro/kernels/knn_stream/kernel.py, knn_stream_topk_prefetch
// (scalar-prefetch block table, pallas_call at :220) and
// knn_stream_topk_padded (contiguous candidates, :275), both running
// _stream_kernel (:73).  The padded kernel is the identity-block-table case
// of this one: the wrapper passes one table shared by every tile (tile
// stride 0), or, for the gathered route's batched launch, a per-tile
// identity table over the tiles' gathered candidates.
//
// What it computes, per query row of tile t: the tile's candidate stream is
// position p = j * block_c + r (slot j of block_table[t], row r of the
// block_c corpus rows starting at block_table[t, j] * block_c, the
// cell-sorted corpus read in place).  Each position with cand_id >= 0 is
// scored with d = max(|q|^2 + |c|^2 - 2 q.c, 0), or d = -q.c (unclamped:
// ip scores may be negative) under the ip metric; pairs with cand_id !=
// query_id and d <= eps2 are counted into `found` and merged into the k
// best, ordered by (d, p): equal scores keep the first-seen position, the
// Pallas merge's first-argmin rule.  ids are -1 where the distance is inf.
// Queries and corpus are float, or both __nv_bfloat16
// (distance_dtype="bf16", half the corpus bytes): bf16 values are upcast as
// they are staged and all arithmetic is fp32, as the TPU's bf16 matmul with
// f32 accumulation.
//
// What bounds it on an H100: operations, not bytes.  Each staged candidate
// is used by 128 queries, so arithmetic intensity is ~64 FMA per byte
// loaded; the FMAs run on the fp32 pipe (exact fp32 distances are the
// contract, so no TF32 / bf16 tensor cores).
//
// What the design does about it: the TPU kernel carried its running top-k
// across a sequential grid axis in VMEM scratch.  Here one block of 256
// threads owns one 128-query tile and walks its candidate stream itself,
// built like knn_topk.cu on the tile of score_tile.cuh:
//  - Compaction.  The stream's positions with cand_id >= 0 are compacted, in
//    order, into a shared-memory list (LCAP positions a window, a ballot per
//    warp and a prefix over the warps), and the list is scored in tiles of
//    128 candidates.  A slot whose ids are all -1 contributes nothing, so
//    its corpus block is never loaded; rows outside the tile's cell union
//    (about two thirds of the touched blocks' rows on the SuSy batches) cost
//    no FMAs either.
//  - The score tile: 128 x 128, 8 x 8 per thread, the d axis staged in
//    8-dim chunks, transposed and double-buffered (any width), candidate
//    rows gathered through the list and the block table.
//  - The epsilon filter gates everything: a row of a thread's 8 scores whose
//    minimum exceeds eps2 costs one compare.  Passing pairs (self excluded)
//    are counted per row in each thread, reduced over the 16 threads that
//    share the row by shuffles and added into a shared per-query count.  A
//    passing score is queued only if it precedes the query's current k-th
//    entry; the top-k lists and queues live in shared memory and one warp
//    per row merges with a ballot rank (score_tile.cuh's merge_queues).
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

#include "score_tile.cuh"

namespace {

using namespace tile;

constexpr int LCAP = 4096;    // stream positions compacted per window
constexpr int WARPS = THREADS / 32;

// Compact the positions p0..p1 of the stream whose ids are >= 0 into
// list[0..n), in order; returns n (the same in every thread).
__device__ __forceinline__ int compact(const int* __restrict__ ids, long long p0,
                                       long long p1, int* list, int* wcnt) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  int base = 0;
  for (long long i0 = p0; i0 < p1; i0 += THREADS) {
    const long long p = i0 + t;
    const bool live = p < p1 && ids[p] >= 0;
    const unsigned m = __ballot_sync(FULL, live);
    if (lane == 0) wcnt[warp] = __popc(m);
    __syncthreads();
    int off = base, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = wcnt[w];
      total += c;
      if (w < warp) off += c;
    }
    if (live) list[off + __popc(m & ((1u << lane) - 1u))] = (int)p;
    __syncthreads();
    base += total;
  }
  return base;
}

template <int KMAX, bool IP, typename T>
__global__ void __launch_bounds__(THREADS, 2)
knn_stream_kernel(const T* __restrict__ queries, const T* __restrict__ corpus,
                  const int* __restrict__ block_table, long long bt_stride,
                  const int* __restrict__ query_ids, const int* __restrict__ cand_ids,
                  long long cid_stride, const float* __restrict__ eps2_ptr,
                  float* __restrict__ out_d, int* __restrict__ out_i,
                  int* __restrict__ out_found, int nblk, int dim, int k,
                  int block_c) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                         // [2][BK][LD] query chunks
  float* cs = qs + 2 * CHUNK;               // [2][BK][LD] candidate chunks
  float* top_d = cs + 2 * CHUNK;            // [TQ][KMAX] sorted scores
  int* top_c = reinterpret_cast<int*>(top_d + TQ * KMAX);  // their positions
  float* q_d = reinterpret_cast<float*>(top_c + TQ * KMAX);  // [TQ][QCAP]
  int* q_c = reinterpret_cast<int*>(q_d + TQ * QCAP);        // [TQ][QCAP]
  float* worst_d = reinterpret_cast<float*>(q_c + TQ * QCAP);  // [TQ]
  int* worst_c = reinterpret_cast<int*>(worst_d + TQ);         // [TQ]
  int* q_cnt = worst_c + TQ;                                   // [TQ]
  int* qid_s = q_cnt + TQ;                                     // [TQ]
  int* found_s = qid_s + TQ;                                   // [TQ]
  float* qq_s = reinterpret_cast<float*>(found_s + TQ);        // [TQ]
  float* cc_s = qq_s + TQ;                                     // [TC]
  int* cid_s = reinterpret_cast<int*>(cc_s + TC);              // [TC]
  int* cpos_s = cid_s + TC;                                    // [TC]
  int* crow_s = cpos_s + TC;                // [2][TC] corpus rows of a tile
  int* list = crow_s + 2 * TC;              // [LCAP] compacted positions
  int* wcnt = list + LCAP;                  // [WARPS]

  const int t = threadIdx.x;
  const int tx = t & 15;
  const int ty = t >> 4;
  const long long tile = blockIdx.x;
  const T* q_tile = queries + tile * TQ * dim;
  const int* table = block_table + tile * bt_stride;
  const int* ids = cand_ids + tile * cid_stride;
  const long long n_pos = (long long)nblk * block_c;
  const float eps2 = *eps2_ptr;

  if (t < TQ) {
    qid_s[t] = query_ids[tile * TQ + t];
    worst_d[t] = CUDART_INF_F;
    worst_c[t] = INT_MAX;
    q_cnt[t] = 0;
    found_s[t] = 0;
  }
  for (int e = t; e < TQ * KMAX; e += THREADS) {
    top_d[e] = CUDART_INF_F;
    top_c[e] = INT_MAX;
  }
  // Corpus row of compacted entry l of the window (-1 past its n entries).
  auto row_of = [&](int l, int n) {
    if (l >= n) return -1;
    const int p = list[l];
    const int j = p / block_c;
    return table[j] * block_c + (p - j * block_c);
  };

  float reg_q[4], reg_c[4];
  int buf = 0;
  for (long long p0 = 0; p0 < n_pos; p0 += LCAP) {
    const int n = compact(ids, p0, min(n_pos, p0 + LCAP), list, wcnt);
    if (n == 0) continue;
    if (t < TC) crow_s[t] = row_of(t, n);
    __syncthreads();
    load_chunk(q_tile, dim, 0, TQ, 0, dim, reg_q);
    load_chunk_rows(corpus, dim, crow_s, 0, dim, reg_c);
    store_chunk(qs + buf * CHUNK, reg_q);
    store_chunk(cs + buf * CHUNK, reg_c);

    for (int l0 = 0, par = 0; l0 < n; l0 += TC, par ^= 1) {
      const bool more_t = l0 + TC < n;
      if (t < TC) crow_s[(par ^ 1) * TC + t] = more_t ? row_of(l0 + TC + t, n) : -1;
      __syncthreads();

      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      float norm = 0.f;  // threads < 128: |c|^2 of column t; others |q|^2 of row t - 128
      for (int d0 = 0; d0 < dim; d0 += BK) {
        // Prefetch the next chunk (of this tile, or the first of the next).
        const bool more_d = d0 + BK < dim;
        const bool next = more_d || more_t;
        if (next) {
          const int nd0 = more_d ? d0 + BK : 0;
          load_chunk(q_tile, dim, 0, TQ, nd0, dim, reg_q);
          load_chunk_rows(corpus, dim, crow_s + (more_d ? par : par ^ 1) * TC, nd0, dim,
                          reg_c);
        }
        fma_chunk<!IP>(qs + buf * CHUNK, cs + buf * CHUNK, min(BK, dim - d0), acc, norm);
        if (next) {
          store_chunk(qs + (buf ^ 1) * CHUNK, reg_q);
          store_chunk(cs + (buf ^ 1) * CHUNK, reg_c);
        }
        __syncthreads();
        buf ^= 1;
      }

      // Scores of the tile; columns past the list's end score NaN, which no
      // comparison lets through.
      if (t < TC) {
        const int p = l0 + t < n ? list[l0 + t] : -1;
        cpos_s[t] = p;
        cid_s[t] = p >= 0 ? ids[p] : -1;
        cc_s[t] = norm;
      } else {
        qq_s[t - TC] = norm;
      }
      __syncthreads();
      const int nv = n - l0;
      float cmask[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) cmask[j] = slot_of(tx, j) < nv ? 0.f : CUDART_NAN_F;
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

      // The epsilon filter: bit 8i+j of `pass` marks a pair within eps2
      // that is not the query itself.  One compare per row settles the
      // common case of none (fminf skips the NaN columns).
      unsigned long long pass = 0ull;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float low = acc[i][0];
#pragma unroll
        for (int j = 1; j < 8; ++j) low = fminf(low, acc[i][j]);
        if (!(low <= eps2)) continue;
        const int qid = qid_s[slot_of(ty, i)];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (acc[i][j] <= eps2 && cid_s[slot_of(tx, j)] != qid)
            pass |= 1ull << (8 * i + j);
        }
      }
      // found: each row's passes, summed over the 16 threads of the row.
      if (__any_sync(FULL, pass != 0ull)) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          int c = __popc((unsigned)(pass >> (8 * i)) & 0xffu);
#pragma unroll
          for (int off = 8; off > 0; off >>= 1) c += __shfl_xor_sync(FULL, c, off);
          if (tx == 0 && c) found_s[slot_of(ty, i)] += c;
        }
      }

      // Queue the passes that precede the row's k-th entry and merge them;
      // a full queue is drained and its rejected passes filtered again.
      while (true) {
        int tried = 0, overflow = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (!((pass >> (8 * i)) & 0xffull)) continue;
          const int row = slot_of(ty, i);
          const float wd = worst_d[row];
          const int wc = worst_c[row];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const unsigned long long bit = 1ull << (8 * i + j);
            if (!(pass & bit)) continue;
            const int pos = cpos_s[slot_of(tx, j)];
            if (!before(acc[i][j], pos, wd, wc)) {
              pass &= ~bit;  // the k-th entry only improves: it stays out
              continue;
            }
            tried = 1;
            const int slot = atomicAdd(&q_cnt[row], 1);
            if (slot < QCAP) {
              q_d[row * QCAP + slot] = acc[i][j];
              q_c[row * QCAP + slot] = pos;
              pass &= ~bit;
            } else {
              overflow = 1;
            }
          }
        }
        if (!__syncthreads_or(tried)) break;
        merge_queues<KMAX>(top_d, top_c, q_d, q_c, q_cnt, worst_d, worst_c, k,
                           [](int, int) { return false; });
        if (!__syncthreads_or(overflow)) break;
      }
    }
  }

  __syncthreads();
  const long long row0 = tile * TQ;
  for (int e = t; e < TQ * k; e += THREADS) {
    const int r = e / k;
    const int p = e - r * k;
    const float d = top_d[r * KMAX + p];
    out_d[(row0 + r) * k + p] = d;
    out_i[(row0 + r) * k + p] = isinf(d) ? -1 : ids[top_c[r * KMAX + p]];
  }
  if (t < TQ) out_found[row0 + t] = found_s[t];
}

// Dynamic shared memory of one block (the wrapper's plan mirrors it).
template <int KMAX>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (4 * CHUNK + 2 * TQ * KMAX + 2 * TQ * QCAP + 6 * TQ + 5 * TC + LCAP + WARPS);
}

template <int KMAX, bool IP, typename T>
cudaError_t launch(const void* queries, const void* corpus, const int* block_table,
                   long long bt_stride, const int* query_ids, const int* cand_ids,
                   long long cid_stride, const float* eps2, float* out_d, int* out_i,
                   int* out_found, int n_tiles, int nblk, int dim, int k, int block_c,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<KMAX>();
  auto kern = knn_stream_kernel<KMAX, IP, T>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<n_tiles, THREADS, smem, stream>>>(
      static_cast<const T*>(queries), static_cast<const T*>(corpus), block_table,
      bt_stride, query_ids, cand_ids, cid_stride, eps2, out_d, out_i, out_found, nblk,
      dim, k, block_c);
  return cudaGetLastError();
}

}  // namespace

// `bf16` selects the operand type of queries and corpus (0: float,
// 1: __nv_bfloat16); `ip` the metric (0: squared L2, 1: -q.c).  One block
// per 128-query tile.
extern "C" int knn_stream_topk_launch(
    const void* queries, const void* corpus, const int* block_table,
    long long bt_stride, const int* query_ids, const int* cand_ids,
    long long cid_stride, const float* eps2, float* out_d, int* out_i,
    int* out_found, int n_tiles, int nblk, int dim, int k, int block_c, int ip,
    int bf16, void* stream) {
  if (n_tiles == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  DISPATCH_IP(ip, DISPATCH_KMAX(k,
      if (bf16) {
        err = (launch<KMAX, IP, __nv_bfloat16>(
            queries, corpus, block_table, bt_stride, query_ids, cand_ids, cid_stride,
            eps2, out_d, out_i, out_found, n_tiles, nblk, dim, k, block_c, s));
      } else {
        err = (launch<KMAX, IP, float>(
            queries, corpus, block_table, bt_stride, query_ids, cand_ids, cid_stride,
            eps2, out_d, out_i, out_found, n_tiles, nblk, dim, k, block_c, s));
      }));
  return (int)err;
}
