// Batched pairwise squared-L2 (or negated inner product) distance tiles:
// the cell-tiled dense backend's distance pass.
//
// Replaces: src/repro/kernels/pairwise_l2/kernel.py, pairwise_sq_l2 (:75)
// and pairwise_sq_l2_dyn_shortc (:107), both _pallas_pairwise (:128,
// pallas_call at :151) running _pairwise_kernel (:32).  The static and the
// runtime epsilon^2 forms are one kernel here: epsilon^2 is always read from
// device memory.
//
// What it computes, for each batch entry b (one query tile of the dense
// engine against its shared candidate block): the (Q, C) f32 matrix
// out[i][j] = sum over d-chunks of (|q_i|^2 + |c_j|^2 - 2 q_i.c_j) restricted
// to the chunk's block_d dims (unclamped), or sum of -q_i.c_j under ip.  With
// SHORTC, before each chunk after the first, a 128 x 128 output tile whose
// smallest partial sum exceeds epsilon^2 stops accumulating: its entries
// keep their partial sums, which only a consumer filtering at epsilon^2 may
// read.  `chunks` (optional) receives the chunks each tile accumulated.
//
// What bounds it on an H100: at the dense engine's 18-dim shapes (128
// queries x 2048 candidates per tile) the 1 MiB f32 output tile is written
// once for ~9.4 MFLOP, about 9 FLOP per byte, under the fp32 balance point
// of ~20: bytes.  At FMA width (518 dims) it turns operations-bound.
//
// What the design does about it: the TPU kernel accumulated the d-chunk
// axis as a sequential grid dimension into its output block.  Here one
// block of 256 threads owns one 128 x 128 output tile and loops over the
// chunks itself, on the tile of score_tile.cuh: 8 x 8 products per thread,
// the d axis staged in 8-dim sub-chunks, transposed and double-buffered
// (the next sub-chunk, of this block_d chunk or the next, loads into
// registers while the current one is scored), four float4 shared loads per
// 64 FMAs.  Each row's and column's squared norm over a chunk is summed once,
// by one thread, not by the 16 that share it.  The chunk's dot products live
// in registers; the running sum of earlier chunks waits in shared memory
// (only when there is more than one chunk), so the accumulators alone set
// the register budget (two blocks per SM).  SHORTC's tile minimum is a
// warp-shuffle plus shared-memory reduction.  The tile is written once with
// float4 stores: each warp writes whole 256-byte row segments.  Exact fp32
// FMA on the CUDA cores: no TF32, no tensor cores.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "score_tile.cuh"

namespace {

using namespace tile;

constexpr int WARPS = THREADS / 32;

template <bool IP>
__global__ void __launch_bounds__(THREADS, 2)
pairwise_kernel(const float* __restrict__ q, const float* __restrict__ c,
                const float* __restrict__ eps2_ptr, float* __restrict__ out,
                int* __restrict__ chunks, int n_q, int n_c, int dim, int block_d,
                int shortc) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // [2][BK][LD] query sub-chunks
  float* cs = qs + 2 * CHUNK;        // [2][BK][LD] candidate sub-chunks
  float* qq_s = cs + 2 * CHUNK;      // [TQ] chunk norms of the rows
  float* cc_s = qq_s + TQ;           // [TC] and of the columns
  float* red = cc_s + TC;            // [WARPS] per-warp minima
  float* tot = red + WARPS;          // [64][THREADS] earlier chunks' sums

  const int t = threadIdx.x;
  const int tx = t & 15;
  const int ty = t >> 4;
  const int n_ct = n_c / TC;
  const int n_qt = n_q / TQ;
  const long long tile = blockIdx.x;
  const int ct = (int)(tile % n_ct);
  const int qt = (int)((tile / n_ct) % n_qt);
  const long long b = tile / ((long long)n_ct * n_qt);
  const float* qb = q + (b * n_q + (long long)qt * TQ) * dim;
  const float* cb = c + (b * n_c + (long long)ct * TC) * dim;

  const int n_chunks = (dim + block_d - 1) / block_d;
  const float eps2 = shortc ? *eps2_ptr : 0.f;

  float reg_q[4], reg_c[4];
  load_chunk(qb, dim, 0, TQ, 0, min(dim, block_d), reg_q);
  load_chunk(cb, dim, 0, TC, 0, min(dim, block_d), reg_c);
  store_chunk(qs, reg_q);
  store_chunk(cs, reg_c);
  __syncthreads();
  int buf = 0;

  float acc[8][8];  // the running sum; during a chunk, the chunk's dots
  int done = 0;
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch > 0) {
      if (shortc) {
        float mn = CUDART_INF_F;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) mn = fminf(mn, acc[i][j]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) mn = fminf(mn, __shfl_xor_sync(FULL, mn, off));
        if ((t & 31) == 0) red[t >> 5] = mn;
        __syncthreads();
        float tile_min = red[0];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) tile_min = fminf(tile_min, red[w]);
        __syncthreads();  // red is rewritten at the next chunk
        if (!(tile_min <= eps2)) break;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) tot[(i * 8 + j) * THREADS + t] = acc[i][j];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    float norm = 0.f;  // threads < 128: |c|^2 of column t; others |q|^2 of row t - 128

    const int d_end = min(dim, (ch + 1) * block_d);
    for (int d0 = ch * block_d; d0 < d_end; d0 += BK) {
      // Prefetch the next sub-chunk (of this chunk, or the first of the next).
      const bool more_d = d0 + BK < d_end;
      const bool next = more_d || ch + 1 < n_chunks;
      if (next) {
        const int nd0 = more_d ? d0 + BK : d_end;
        const int n_end = more_d ? d_end : min(dim, d_end + block_d);
        load_chunk(qb, dim, 0, TQ, nd0, n_end, reg_q);
        load_chunk(cb, dim, 0, TC, nd0, n_end, reg_c);
      }
      fma_chunk<!IP>(qs + buf * CHUNK, cs + buf * CHUNK, min(BK, d_end - d0), acc, norm);
      if (next) {
        store_chunk(qs + (buf ^ 1) * CHUNK, reg_q);
        store_chunk(cs + (buf ^ 1) * CHUNK, reg_c);
      }
      __syncthreads();
      buf ^= 1;
    }

    if (!IP) {
      if (t < TC) {
        cc_s[t] = norm;
      } else {
        qq_s[t - TC] = norm;
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float qq = IP ? 0.f : qq_s[slot_of(ty, i)];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float part = IP ? -acc[i][j] : (qq + cc_s[slot_of(tx, j)]) - 2.f * acc[i][j];
        acc[i][j] = (ch > 0 ? tot[(i * 8 + j) * THREADS + t] : 0.f) + part;
      }
    }
    done = ch + 1;  // qq_s / cc_s are rewritten only after the next chunk's barriers
  }

  float* ob = out + (b * n_q + (long long)qt * TQ) * n_c + (long long)ct * TC;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* orow = ob + (long long)slot_of(ty, i) * n_c;
    *reinterpret_cast<float4*>(orow + 4 * tx) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(orow + 64 + 4 * tx) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  if (chunks != nullptr && t == 0) chunks[tile] = done;
}

// Dynamic shared memory of one block (the wrapper's plan mirrors it): the
// running sum of earlier chunks only when there is more than one chunk.
size_t smem_bytes(int n_chunks) {
  return sizeof(float) * (4 * CHUNK + TQ + TC + WARPS +
                          (n_chunks > 1 ? 64 * THREADS : 0));
}

template <bool IP>
cudaError_t launch(const float* q, const float* c, const float* eps2, float* out,
                   int* chunks, long long n_tiles, int n_q, int n_c, int dim,
                   int block_d, int shortc, cudaStream_t stream) {
  const size_t smem = smem_bytes((dim + block_d - 1) / block_d);
  const cudaError_t err = cudaFuncSetAttribute(
      pairwise_kernel<IP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  pairwise_kernel<IP><<<(unsigned)n_tiles, THREADS, smem, stream>>>(
      q, c, eps2, out, chunks, n_q, n_c, dim, block_d, shortc);
  return cudaGetLastError();
}

}  // namespace

// Tiles are 128 x 128: n_q and n_c are multiples of 128.  `ip` selects the
// metric (0: squared L2, 1: -q.c; SHORTC is l2 only).
extern "C" int pairwise_l2_launch(const float* q, const float* c,
                                  const float* eps2, float* out, int* chunks,
                                  int batch, int n_q, int n_c, int dim,
                                  int block_d, int shortc, int ip, void* stream) {
  const long long n_tiles = (long long)batch * (n_q / TQ) * (n_c / TC);
  if (n_tiles == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(ip ? launch<true>(q, c, eps2, out, chunks, n_tiles, n_q, n_c, dim,
                                 block_d, 0, s)
                  : launch<false>(q, c, eps2, out, chunks, n_tiles, n_q, n_c, dim,
                                  block_d, shortc, s));
}
