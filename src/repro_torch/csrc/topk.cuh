// Shared device code of the port's top-k kernels: the register top-k, the
// register query row and the row staging of knn_stream.cu's narrow kernel,
// and the template dispatch of knn_stream.cu and knn_topk.cu.
//
// RunningTopK keeps one query's k smallest (distance, id) pairs in
// registers, sorted ascending.  The buffer is KMAX long (a compile-time
// ceiling, so every index into it is static and nothing spills to local
// memory); only its first k <= KMAX entries are live and `worst` caches
// entry k-1.  Insertion shifts only strictly larger entries, so equal
// distances keep their arrival order: fed candidates in column order, the
// buffer reproduces the Pallas merge's first-argmin tie rule over
// [running buffer | new block] (kernels/knn_stream/kernel.py:_merge_topk).
//
// Query<DP> holds one thread's query row.  For DP > 0 the row lives in
// registers, zero-padded to DP dims, and candidate rows are staged in
// shared memory at a stride of DP floats (zero-padded too) and read as
// float4 broadcasts: one shared load per four FMAs, so the fp32 pipe, not
// the load unit, sets the pace.  The padding adds exact zeros to every sum.
// Rows wider than 32 dims take knn_stream.cu's d-chunked kernel instead.
//
// Operands may be float or __nv_bfloat16 (the dense engine's bf16 distance
// mode).  bf16 values are upcast exactly on load and every sum runs in
// fp32, so each distance is an exact-f32 function of the bf16-cast inputs;
// the float instantiations are the same code as before bf16 was added.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int KMAX>
struct RunningTopK {
  float d[KMAX];
  int i[KMAX];
  float worst;
  int k;

  __device__ __forceinline__ void init(int k_live) {
    k = k_live;
#pragma unroll
    for (int p = 0; p < KMAX; ++p) {
      d[p] = CUDART_INF_F;
      i[p] = -1;
    }
    worst = CUDART_INF_F;
  }

  __device__ __forceinline__ void push(float dist, int id) {
    if (!(dist < worst)) return;
#pragma unroll
    for (int p = KMAX - 1; p > 0; --p) {
      if (d[p - 1] > dist) {
        d[p] = d[p - 1];
        i[p] = i[p - 1];
      } else if (d[p] > dist) {
        d[p] = dist;
        i[p] = id;
      }
    }
    if (d[0] > dist) {
      d[0] = dist;
      i[0] = id;
    }
#pragma unroll
    for (int p = 0; p < KMAX; ++p) {
      if (p == k - 1) worst = d[p];
    }
  }

  // Row `row` of (rows, k) outputs; ids are -1 wherever the distance is inf.
  __device__ __forceinline__ void store(float* out_d, int* out_i,
                                        long long row) const {
#pragma unroll
    for (int p = 0; p < KMAX; ++p) {
      if (p < k) {
        out_d[row * k + p] = d[p];
        out_i[row * k + p] = isinf(d[p]) ? -1 : i[p];
      }
    }
  }
};

template <int DP>
struct Query {
  static_assert(DP > 0 && DP % 4 == 0, "register-resident rows only");
  float v[DP];
  float qq;

  // `tile` is the block's (rows, dim) query rows; row threadIdx.x is this
  // thread's (zero past rows_valid).
  template <typename T>
  __device__ __forceinline__ void load(const T* tile, long long rows_valid,
                                       int dim) {
    const int t = threadIdx.x;
    qq = 0.f;
#pragma unroll
    for (int d = 0; d < DP; ++d) {
      v[d] = (d < dim && t < rows_valid) ? to_f32(tile[(long long)t * dim + d]) : 0.f;
      qq = fmaf(v[d], v[d], qq);
    }
  }

  // q.c for one staged row (DP floats, 16-byte aligned).
  __device__ __forceinline__ float dot(const float* c) const {
    float s = 0.f;
    const float4* c4 = reinterpret_cast<const float4*>(c);
#pragma unroll
    for (int j = 0; j < DP / 4; ++j) {
      const float4 x = c4[j];
      s = fmaf(v[4 * j], x.x, s);
      s = fmaf(v[4 * j + 1], x.y, s);
      s = fmaf(v[4 * j + 2], x.z, s);
      s = fmaf(v[4 * j + 3], x.w, s);
    }
    return s;
  }
};

// Stage n rows of `src` ((n, dim), row-major) into `dst` at stride `stride`
// (zero-padding columns dim..stride-1 and rows n..n_alloc-1), then write
// each row's squared norm into `norms`.  Ends with __syncthreads().
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, int n,
                                           int n_alloc, int dim, int stride,
                                           float* dst, float* norms) {
  for (int e = threadIdx.x; e < n_alloc * stride; e += blockDim.x) {
    const int r = e / stride;
    const int d = e - r * stride;
    dst[e] = (r < n && d < dim) ? to_f32(src[(long long)r * dim + d]) : 0.f;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < n_alloc; r += blockDim.x) {
    float s = 0.f;
    for (int d = 0; d < dim; ++d) s = fmaf(dst[r * stride + d], dst[r * stride + d], s);
    norms[r] = s;
  }
  __syncthreads();
}

// Smallest register-resident query width holding `dim`, or 0 (wider rows).
static inline int query_pad(int dim) {
  return dim <= 8 ? 8 : dim <= 16 ? 16 : dim <= 24 ? 24 : dim <= 32 ? 32 : 0;
}

// Run `__VA_ARGS__` with constexpr DP = dp (one of 8/16/24/32) in scope.
#define DISPATCH_DP(dp, ...)                                      \
  do {                                                            \
    switch (dp) {                                                 \
      case 8: { constexpr int DP = 8; __VA_ARGS__; } break;       \
      case 16: { constexpr int DP = 16; __VA_ARGS__; } break;     \
      case 24: { constexpr int DP = 24; __VA_ARGS__; } break;     \
      case 32: { constexpr int DP = 32; __VA_ARGS__; } break;     \
    }                                                             \
  } while (0)

// Run `__VA_ARGS__` with constexpr KMAX (smallest of 8/16/32 holding k) in
// scope.
#define DISPATCH_KMAX(k, ...)                                             \
  do {                                                                    \
    if ((k) <= 8) {                                                       \
      constexpr int KMAX = 8;                                             \
      __VA_ARGS__;                                                        \
    } else if ((k) <= 16) {                                               \
      constexpr int KMAX = 16;                                            \
      __VA_ARGS__;                                                        \
    } else {                                                              \
      constexpr int KMAX = 32;                                            \
      __VA_ARGS__;                                                        \
    }                                                                     \
  } while (0)

// Run `__VA_ARGS__` with constexpr bool IP (the metric: true for the
// negated inner product -q.c, false for squared L2) in scope.
#define DISPATCH_IP(ip, ...)                                              \
  do {                                                                    \
    if (ip) {                                                             \
      constexpr bool IP = true;                                           \
      __VA_ARGS__;                                                        \
    } else {                                                              \
      constexpr bool IP = false;                                          \
      __VA_ARGS__;                                                        \
    }                                                                     \
  } while (0)
