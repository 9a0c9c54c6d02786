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
// the fp32 FMA pipe, the sqrt/divide per pair and the shared-memory atomic
// per counted pair dominate.
//
// What the design does about it: the TPU kernel accumulated a (1, n_bins)
// f32 block across a sequential grid.  Here each thread block owns blockDim
// points (one per thread, stored transposed in shared memory so the reads
// are bank-conflict free), walks the sampled queries in shared-memory tiles
// read as broadcasts, and counts into shared-memory int bins; one atomicAdd
// per bin per block folds them into 64-bit global counters.  Counting in
// integers keeps the result exact at any sample size (the JAX f32 sum is
// exact only below 2^24 per bin); the wrapper converts to f32 at the end.
#include <cuda_runtime.h>

#define QTILE 64

__global__ void bin_hist_kernel(const float* __restrict__ queries,
                                const float* __restrict__ points,
                                const int* __restrict__ query_ids,
                                const float* __restrict__ bw_ptr,
                                unsigned long long* __restrict__ counts,
                                int n_q, int n_p, int dim, int n_bins) {
  extern __shared__ float smem[];
  const int tp = blockDim.x;
  float* p_s = smem;                        // [dim][tp] (transposed)
  float* q_s = p_s + dim * tp;              // [QTILE][dim]
  float* qq_s = q_s + QTILE * dim;          // [QTILE]
  int* qid_s = reinterpret_cast<int*>(qq_s + QTILE);  // [QTILE]
  int* bins = qid_s + QTILE;                // [n_bins]

  const int t = threadIdx.x;
  const long long p0 = (long long)blockIdx.x * tp;
  const long long pid = p0 + t;
  const bool active = pid < n_p;

  for (int b = t; b < n_bins; b += tp) bins[b] = 0;
  for (int e = t; e < tp * dim; e += tp) {
    const int r = e / dim;
    const int d = e - r * dim;
    p_s[d * tp + r] = (p0 + r < n_p) ? points[(p0 + r) * dim + d] : 0.f;
  }
  __syncthreads();
  float pp = 0.f;
  for (int d = 0; d < dim; ++d) {
    const float v = p_s[d * tp + t];
    pp = fmaf(v, v, pp);
  }
  const float bw = *bw_ptr;

  for (int s0 = 0; s0 < n_q; s0 += QTILE) {
    const int ns = min(QTILE, n_q - s0);
    __syncthreads();  // the previous query tile's readers are done
    for (int e = t; e < ns * dim; e += tp) q_s[e] = queries[(long long)s0 * dim + e];
    for (int s = t; s < ns; s += tp) qid_s[s] = query_ids[s0 + s];
    __syncthreads();
    for (int s = t; s < ns; s += tp) {
      float v = 0.f;
      for (int d = 0; d < dim; ++d) v = fmaf(q_s[s * dim + d], q_s[s * dim + d], v);
      qq_s[s] = v;
    }
    __syncthreads();
    if (!active) continue;
    for (int s = 0; s < ns; ++s) {
      const int qid = qid_s[s];
      if (qid < 0 || qid == pid) continue;
      float dot = 0.f;
      for (int d = 0; d < dim; ++d) dot = fmaf(q_s[s * dim + d], p_s[d * tp + t], dot);
      const float dist = sqrtf(fmaxf(qq_s[s] + pp - 2.f * dot, 0.f));
      const float b = floorf(dist / bw);
      if (b >= 0.f && b < (float)n_bins) atomicAdd(&bins[(int)b], 1);
    }
  }
  __syncthreads();
  for (int b = t; b < n_bins; b += tp) {
    if (bins[b]) atomicAdd(&counts[b], (unsigned long long)bins[b]);
  }
}

extern "C" int bin_hist_launch(const float* queries, const float* points,
                               const int* query_ids, const float* bin_width,
                               unsigned long long* counts, int n_q, int n_p,
                               int dim, int n_bins, int block_p, void* stream) {
  if (n_p == 0) return (int)cudaGetLastError();
  const size_t smem = sizeof(float) * ((size_t)dim * block_p + QTILE * dim + QTILE) +
                      sizeof(int) * (QTILE + (size_t)n_bins);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bin_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (n_p + block_p - 1) / block_p;
  bin_hist_kernel<<<grid, block_p, smem, (cudaStream_t)stream>>>(
      queries, points, query_ids, bin_width, counts, n_q, n_p, dim, n_bins);
  return (int)cudaGetLastError();
}
