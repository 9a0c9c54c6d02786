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
// SHORTC, before each chunk after the first, a (block_q x block_c) output
// tile whose smallest partial sum exceeds epsilon^2 stops accumulating: its
// entries keep their partial sums, which only a consumer filtering at
// epsilon^2 may read.  `chunks` (optional) receives the chunks each tile
// accumulated.
//
// What bounds it on an H100: at the dense engine's shapes (128 queries x
// 2048 candidates x 18 dims per tile) the 1 MiB f32 output tile is written
// once for ~9.4 MFLOP, about 9 FLOP per byte, under the fp32 balance point
// of ~20: bytes.  At FMA width (518 dims) it turns operations-bound.
//
// What the design does about it: the TPU kernel accumulated the d-chunk
// axis as a sequential grid dimension into its output block.  Here one
// thread block owns one (block_q x block_c) output tile and loops over the
// chunks itself, keeping the tile in registers (8 x 8 per thread) and
// writing it once, coalesced, at the end.  Query and candidate sub-chunks of
// BK dims are staged transposed in shared memory; each thread reads 8 + 8
// values per dim and does 64 FMAs (plus 16 for the chunk norms).  SHORTC's
// tile minimum is a warp-shuffle plus shared-memory reduction.  Exact fp32
// FMA on the CUDA cores: no TF32, no tensor cores.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TM = 8;    // query rows per thread
constexpr int TN = 8;    // candidate columns per thread
constexpr int BK = 8;    // dims staged per shared-memory step
constexpr int MAX_THREADS = 256;

template <bool IP>
__global__ void __launch_bounds__(MAX_THREADS)
pairwise_kernel(const float* __restrict__ q, const float* __restrict__ c,
                const float* __restrict__ eps2_ptr, float* __restrict__ out,
                int* __restrict__ chunks, int n_q, int n_c, int dim,
                int block_q, int block_c, int block_d, int shortc) {
  extern __shared__ __align__(16) float smem[];
  const int ldq = block_q + 4;
  const int ldc = block_c + 4;
  float* qs = smem;                 // [BK][ldq], transposed query sub-chunk
  float* cs = qs + BK * ldq;        // [BK][ldc], transposed candidate sub-chunk
  float* red = cs + BK * ldc;       // [32] per-warp minima

  const int nx = block_c / TN;
  const int ny = block_q / TM;
  const int tx = threadIdx.x % nx;
  const int ty = threadIdx.x / nx;
  const int n_ct = n_c / block_c;
  const int n_qt = n_q / block_q;
  const long long tile = blockIdx.x;
  const int ct = (int)(tile % n_ct);
  const int qt = (int)((tile / n_ct) % n_qt);
  const long long b = tile / ((long long)n_ct * n_qt);
  const float* qb = q + (b * n_q + (long long)qt * block_q) * dim;
  const float* cb = c + (b * n_c + (long long)ct * block_c) * dim;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int n_chunks = (dim + block_d - 1) / block_d;
  const float eps2 = shortc ? *eps2_ptr : 0.f;
  int done = 0;
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (shortc && ch > 0) {
      float mn = CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) mn = fminf(mn, acc[i][j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
      if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mn;
      __syncthreads();
      float tile_min = red[0];
      for (int w = 1; w < (int)(blockDim.x >> 5); ++w) tile_min = fminf(tile_min, red[w]);
      __syncthreads();  // red is rewritten at the next chunk
      if (!(tile_min <= eps2)) break;
    }
    float dot[TM][TN];
    float qq[TM];
    float cc[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      qq[i] = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) dot[i][j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) cc[j] = 0.f;

    const int d_begin = ch * block_d;
    const int d_end = min(dim, d_begin + block_d);
    for (int d0 = d_begin; d0 < d_end; d0 += BK) {
      __syncthreads();  // the previous step's readers are done with qs/cs
      for (int e = threadIdx.x; e < block_q * BK; e += blockDim.x) {
        const int r = e / BK;
        const int d = d0 + (e - r * BK);
        qs[(e - r * BK) * ldq + r] = d < d_end ? qb[(long long)r * dim + d] : 0.f;
      }
      for (int e = threadIdx.x; e < block_c * BK; e += blockDim.x) {
        const int r = e / BK;
        const int d = d0 + (e - r * BK);
        cs[(e - r * BK) * ldc + r] = d < d_end ? cb[(long long)r * dim + d] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int dd = 0; dd < BK; ++dd) {
        float a[TM];
        float v[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = qs[dd * ldq + ty + i * ny];
#pragma unroll
        for (int j = 0; j < TN; ++j) v[j] = cs[dd * ldc + tx + j * nx];
#pragma unroll
        for (int i = 0; i < TM; ++i) qq[i] = fmaf(a[i], a[i], qq[i]);
#pragma unroll
        for (int j = 0; j < TN; ++j) cc[j] = fmaf(v[j], v[j], cc[j]);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) dot[i][j] = fmaf(a[i], v[j], dot[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        acc[i][j] += IP ? -dot[i][j] : (qq[i] + cc[j]) - 2.f * dot[i][j];
    done = ch + 1;
  }

  float* ob = out + (b * n_q + (long long)qt * block_q) * n_c + (long long)ct * block_c;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      ob[(long long)(ty + i * ny) * n_c + tx + j * nx] = acc[i][j];
  if (chunks != nullptr && threadIdx.x == 0) chunks[tile] = done;
}

}  // namespace

extern "C" int pairwise_l2_launch(const float* q, const float* c,
                                  const float* eps2, float* out, int* chunks,
                                  int batch, int n_q, int n_c, int dim,
                                  int block_q, int block_c, int block_d,
                                  int shortc, int ip, void* stream) {
  const long long n_tiles = (long long)batch * (n_q / block_q) * (n_c / block_c);
  if (n_tiles == 0) return (int)cudaGetLastError();
  const int threads = (block_q / TM) * (block_c / TN);
  const size_t smem = sizeof(float) * ((size_t)BK * (block_q + 4) +
                                       (size_t)BK * (block_c + 4) + 32);
  const cudaStream_t s = (cudaStream_t)stream;
  if (ip) {
    pairwise_kernel<true><<<(unsigned)n_tiles, threads, smem, s>>>(
        q, c, eps2, out, chunks, n_q, n_c, dim, block_q, block_c, block_d, 0);
  } else {
    pairwise_kernel<false><<<(unsigned)n_tiles, threads, smem, s>>>(
        q, c, eps2, out, chunks, n_q, n_c, dim, block_q, block_c, block_d,
        shortc);
  }
  return (int)cudaGetLastError();
}
