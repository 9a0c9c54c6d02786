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
// points (one per thread) and counts into shared-memory int bins; one
// atomicAdd per bin per block folds them into 64-bit global counters.
// Counting in integers keeps the result exact at any sample size (the JAX
// f32 sum is exact only below 2^24 per bin); the wrapper converts to f32 at
// the end.  Two kernels share that skeleton:
//  - narrow rows (dim <= 32): the block's points are stored whole,
//    transposed in shared memory (bank-conflict free), and the sampled
//    queries are walked in QTILE-row shared-memory tiles read as broadcasts;
//  - wide rows (any dim > 32): block (x, y) takes TP points and the y-th
//    group of HG sampled queries; points and queries are staged in d-chunks
//    of HD dims, transposed, the next chunk loading into registers while
//    the current one is scored; each thread keeps the partial dots of 4
//    points with 8 of the group's queries in registers across the chunks
//    (a register tile: three float4 shared loads per 32 FMAs).  Shared
//    memory is HD * (TP + HG + 8) + TP + 2 HG floats plus the bins at any
//    width.  Both kernels sum every dot, norm and distance in the same
//    order, so they count the same bins.
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

constexpr int HG = 32;      // sampled queries per group
constexpr int HD = 32;      // dims per staged chunk
constexpr int TP = 256;     // points (threads) per block
constexpr int LP = TP + 4;  // row stride of the transposed point chunk
constexpr int LQ = HG + 4;  // row stride of the transposed query chunk

// Block (x, y) scores TP points against the y-th group of HG sampled
// queries; thread t holds the 4 points 4 * (t / 4) .. + 3 against the 8
// queries 8 * (t % 4) .. + 7: a 4 x 8 register tile fed by one float4 of
// points and two of queries per dim.  While a chunk is scored, the next
// one is already loading into registers.
__global__ void __launch_bounds__(TP)
bin_hist_wide_kernel(const float* __restrict__ queries,
                     const float* __restrict__ points,
                     const int* __restrict__ query_ids,
                     const float* __restrict__ bw_ptr,
                     unsigned long long* __restrict__ counts, int n_q, int n_p,
                     int dim, int n_bins) {
  extern __shared__ __align__(16) float smem[];
  float* p_s = smem;                        // [HD][LP] transposed point chunk
  float* q_s = p_s + HD * LP;               // [HD][LQ] transposed query chunk
  float* pp_s = q_s + HD * LQ;              // [TP] point norms
  float* qq_s = pp_s + TP;                  // [HG] query norms
  int* qid_s = reinterpret_cast<int*>(qq_s + HG);  // [HG]
  int* bins = qid_s + HG;                   // [n_bins]

  const int t = threadIdx.x;
  const int pq = (t >> 2) * 4;   // this thread's first point (of the block)
  const int sq = (t & 3) * 8;    // its first query (of the group)
  const long long p0 = (long long)blockIdx.x * TP;
  const int s0 = blockIdx.y * HG;
  const int ns = min(HG, n_q - s0);

  // Staging: thread t moves dims d8, d8 + 8, d8 + 16, d8 + 24 (d8 = t % 8)
  // of point rows t / 8 + 32 k (k < 8) and of query row t / 8, so 8 lanes
  // read 32 contiguous bytes of a row and the transposed stores hit 32
  // distinct banks.
  static_assert(TP == 256 && HG == 32 && HD == 32, "staging map");
  const int d8 = t & 7;
  const int r8 = t >> 3;
  float p_reg[8][4], q_reg[4];
  auto load = [&](int d0) {
    const int nd = min(HD, dim - d0);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const long long r = p0 + r8 + 32 * k;
      const float* src = points + r * dim + d0 + d8;
#pragma unroll
      for (int j = 0; j < 4; ++j) p_reg[k][j] = (r < n_p && d8 + 8 * j < nd) ? src[8 * j] : 0.f;
    }
    const float* src = queries + (long long)(s0 + r8) * dim + d0 + d8;
#pragma unroll
    for (int j = 0; j < 4; ++j) q_reg[j] = (r8 < ns && d8 + 8 * j < nd) ? src[8 * j] : 0.f;
  };
  auto store = [&]() {
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) p_s[(d8 + 8 * j) * LP + r8 + 32 * k] = p_reg[k][j];
#pragma unroll
    for (int j = 0; j < 4; ++j) q_s[(d8 + 8 * j) * LQ + r8] = q_reg[j];
  };

  for (int b = t; b < n_bins; b += TP) bins[b] = 0;
  const float bw = *bw_ptr;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float pp = 0.f;  // |p|^2 of point t
  float qq = 0.f;  // thread g < HG: |q|^2 of the group's query g

  load(0);
  for (int d0 = 0; d0 < dim; d0 += HD) {
    const int nd = min(HD, dim - d0);
    __syncthreads();  // the previous chunk's readers are done
    store();
    __syncthreads();
    if (d0 + HD < dim) load(d0 + HD);
    for (int d = 0; d < nd; ++d) pp = fmaf(p_s[d * LP + t], p_s[d * LP + t], pp);
    if (t < HG) {
      for (int d = 0; d < nd; ++d) qq = fmaf(q_s[d * LQ + t], q_s[d * LQ + t], qq);
    }
#pragma unroll 4
    for (int d = 0; d < nd; ++d) {
      const float4 p = *reinterpret_cast<const float4*>(p_s + d * LP + pq);
      const float4 qa = *reinterpret_cast<const float4*>(q_s + d * LQ + sq);
      const float4 qb = *reinterpret_cast<const float4*>(q_s + d * LQ + sq + 4);
      const float pv[4] = {p.x, p.y, p.z, p.w};
      const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(qv[j], pv[i], acc[i][j]);
    }
  }
  pp_s[t] = pp;
  if (t < HG) {
    qq_s[t] = qq;
    qid_s[t] = t < ns ? query_ids[s0 + t] : -1;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long pid = p0 + pq + i;
    if (pid >= n_p) continue;
    const float ppi = pp_s[pq + i];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qid = qid_s[sq + j];
      if (qid < 0 || qid == pid) continue;
      const float dist = sqrtf(fmaxf(qq_s[sq + j] + ppi - 2.f * acc[i][j], 0.f));
      const float b = floorf(dist / bw);
      if (b >= 0.f && b < (float)n_bins) atomicAdd(&bins[(int)b], 1);
    }
  }
  __syncthreads();
  for (int b = t; b < n_bins; b += TP) {
    if (bins[b]) atomicAdd(&counts[b], (unsigned long long)bins[b]);
  }
}

// Dynamic shared memory of one block (the wrapper's plan mirrors it).
static size_t smem_bytes(int dim, int n_bins, int block_p) {
  if (dim <= 32)
    return sizeof(float) * ((size_t)dim * block_p + QTILE * dim + QTILE) +
           sizeof(int) * (QTILE + (size_t)n_bins);
  return sizeof(float) * ((size_t)HD * LP + HD * LQ + TP + HG) +
         sizeof(int) * (HG + (size_t)n_bins);
}

extern "C" int bin_hist_launch(const float* queries, const float* points,
                               const int* query_ids, const float* bin_width,
                               unsigned long long* counts, int n_q, int n_p,
                               int dim, int n_bins, int block_p, void* stream) {
  if (n_p == 0 || n_q == 0) return (int)cudaGetLastError();
  const size_t smem = smem_bytes(dim, n_bins, block_p);
  const bool narrow = dim <= 32;
  auto kern = narrow ? bin_hist_kernel : bin_hist_wide_kernel;
  const int threads = narrow ? block_p : TP;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n_p + threads - 1) / threads, narrow ? 1 : (n_q + HG - 1) / HG);
  kern<<<grid, threads, smem, (cudaStream_t)stream>>>(
      queries, points, query_ids, bin_width, counts, n_q, n_p, dim, n_bins);
  return (int)cudaGetLastError();
}
