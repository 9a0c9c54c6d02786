// Sampled pairwise-distance histogram for epsilon selection (paper §V-C2).
//
// Replaces: src/repro/kernels/bin_hist/kernel.py, distance_bin_histogram
// (pallas_call at :80, body _hist_kernel :23).
//
// What it computes: for every (sampled query s, corpus point p) pair with
// query_id[s] >= 0 and query_id[s] != p, d = sqrt(max(|q|^2 + |p|^2 -
// 2 q.p, 0)) goes to bin floor(d / bin_width) when that is < n_bins.  The
// result is one (n_bins,) count vector.
//
// What bounds it on an H100: operations.  The whole corpus is read once
// (N * dim * 4 bytes) while every point meets all S sampled queries, so
// the fp32 FMAs of the dots, then the root, the divide and the count of
// each pair dominate.
//
// What the design does about it:
//  - One kernel for every width, on the 128 x 128 register score tile of
//    score_tile.cuh: tile rows are sampled queries, tile columns points;
//    the d axis is staged in double-buffered transposed 8-dim chunks, each
//    thread does 64 FMAs per four float4 shared loads (a ragged last chunk
//    only over its own dims).  Every dot and norm is the fmaf sum over d
//    ascending from 0.
//  - Persistent blocks: block (x, y) takes row tile y and walks the x-th
//    contiguous split of 128-point tiles (the wrapper sizes the splits to
//    fill whole waves of two blocks per SM), so the bins are flushed to
//    device memory once per split, not once per tile.
//  - Counting: each warp counts into its own shared int sub-histogram, so
//    the warps' atomics never meet; at the block's end the sub-histograms
//    are summed and folded into the 64-bit global counters, one atomicAdd
//    per non-zero bin.  Integer counts stay exact at any sample size (the
//    JAX f32 sum is exact only below 2^24 per bin); the wrapper converts to
//    f32 at the end.
//  - The epilogue keeps the plain version's per-pair arithmetic (IEEE root
//    and divide) and runs the same steps for every pair: only the count is
//    predicated.  A warp's pairs mix in- and out-of-range distances, so a
//    branch around the root and the divide saved nothing and cost the
//    branch.
#include <cuda_runtime.h>

#include "score_tile.cuh"

namespace {

using namespace tile;

constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS, 2)
bin_hist_kernel(const float* __restrict__ queries, const float* __restrict__ points,
                const int* __restrict__ query_ids, const float* __restrict__ bw_ptr,
                unsigned long long* __restrict__ counts, int n_q, int n_p, int dim,
                int n_bins, long long per_split) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                         // [2][BK][LD] query chunks
  float* cs = qs + 2 * CHUNK;               // [2][BK][LD] point chunks
  float* qq_s = cs + 2 * CHUNK;             // [TQ] query norms
  float* pp_s = qq_s + TQ;                  // [TC] point norms
  int* qid_s = reinterpret_cast<int*>(pp_s + TC);  // [TQ]
  int* bins = qid_s + TQ;                   // [WARPS][n_bins]

  const int t = threadIdx.x;
  const int tx = t & 15;
  const int ty = t >> 4;
  int* my_bins = bins + (t >> 5) * n_bins;
  const long long q0 = (long long)blockIdx.y * TQ;
  const long long c_begin = blockIdx.x * per_split;
  const long long c_end = min((long long)n_p, c_begin + per_split);

  for (int b = t; b < WARPS * n_bins; b += THREADS) bins[b] = 0;
  if (t < TQ) qid_s[t] = q0 + t < n_q ? query_ids[q0 + t] : -1;
  const float bw = *bw_ptr;
  const float nb = (float)n_bins;

  float reg_q[4], reg_c[4];
  if (c_begin < c_end) {
    load_chunk(queries, dim, q0, n_q, 0, dim, reg_q);
    load_chunk(points, dim, c_begin, c_end, 0, dim, reg_c);
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
    float norm = 0.f;  // threads < 128: |p|^2 of column t; others |q|^2 of row t - 128

    for (int d0 = 0; d0 < dim; d0 += BK) {
      // Prefetch the next chunk (of this tile, or the first of the next).
      const bool more_d = d0 + BK < dim;
      const bool next = more_d || c0 + TC < c_end;
      if (next) {
        const int nd0 = more_d ? d0 + BK : 0;
        load_chunk(queries, dim, q0, n_q, nd0, dim, reg_q);
        load_chunk(points, dim, more_d ? c0 : c0 + TC, c_end, nd0, dim, reg_c);
      }
      fma_chunk<true>(qs + buf * CHUNK, cs + buf * CHUNK, min(BK, dim - d0), acc, norm);
      if (next) {
        store_chunk(qs + (buf ^ 1) * CHUNK, reg_q);
        store_chunk(cs + (buf ^ 1) * CHUNK, reg_c);
      }
      __syncthreads();
      buf ^= 1;
    }

    if (t < TC) {
      pp_s[t] = norm;
    } else {
      qq_s[t - TC] = norm;
    }
    __syncthreads();
    const int n_cols = (int)min((long long)TC, c_end - c0);  // points of this tile
    float pp[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) pp[j] = pp_s[slot_of(tx, j)];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = slot_of(ty, i);
      const int qid = qid_s[row];
      if (qid < 0) continue;
      const long long self = (long long)qid - c0;  // the query's own column, if here
      const int self_col = (self >= 0 && self < TC) ? (int)self : -1;
      const float qq = qq_s[row];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = slot_of(tx, j);
        const float b = floorf(sqrtf(fmaxf(qq + pp[j] - 2.f * acc[i][j], 0.f)) / bw);
        if (col < n_cols && col != self_col && b >= 0.f && b < nb) {
          atomicAdd(&my_bins[(int)b], 1);
        }
      }
    }
    // The next tile writes qq_s / pp_s only after its d loop's barriers.
  }

  __syncthreads();
  for (int b = t; b < n_bins; b += THREADS) {
    unsigned long long sum = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += (unsigned)bins[w * n_bins + b];
    if (sum) atomicAdd(&counts[b], sum);
  }
}

// Dynamic shared memory of one block (the wrapper's plan mirrors it).
size_t smem_bytes(int n_bins) {
  return sizeof(float) * (4 * CHUNK + 3 * TQ) + sizeof(int) * (size_t)WARPS * n_bins;
}

}  // namespace

// Splits are per_split points wide (a multiple of 128); the grid is
// (n_splits, ceil(n_q / 128)).
extern "C" int bin_hist_launch(const float* queries, const float* points,
                               const int* query_ids, const float* bin_width,
                               unsigned long long* counts, int n_q, int n_p,
                               int dim, int n_bins, int n_splits,
                               long long per_split, void* stream) {
  if (n_p == 0 || n_q == 0) return (int)cudaGetLastError();
  const size_t smem = smem_bytes(n_bins);
  cudaError_t err = cudaFuncSetAttribute(
      bin_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_splits, (n_q + TQ - 1) / TQ);
  bin_hist_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      queries, points, query_ids, bin_width, counts, n_q, n_p, dim, n_bins, per_split);
  return (int)cudaGetLastError();
}
