// Shared helpers of the port's CUDA kernels: complex float2 arithmetic and
// block-wide reductions.  Complex tensors from PyTorch (complex64) are
// interleaved re/im pairs, i.e. float2 arrays.
#pragma once

#include <cuda_runtime.h>

#define TG_THREADS 256

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a += b * c
__device__ __forceinline__ void cfma(float2& a, float2 b, float2 c) {
  a.x = fmaf(b.x, c.x, fmaf(-b.y, c.y, a.x));
  a.y = fmaf(b.x, c.y, fmaf(b.y, c.x, a.y));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sum of N floats per thread (blockDim.x == TG_THREADS); the
// totals land in v[] of thread 0.
template <int N>
__device__ void block_sum(float (&v)[N]) {
  __shared__ float part[TG_THREADS / 32][N];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = warp_sum(v[j]);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) part[warp][j] = v[j];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      v[j] = lane < TG_THREADS / 32 ? part[lane][j] : 0.0f;
      v[j] = warp_sum(v[j]);
    }
  }
  __syncthreads();
}

// Peak with first-max tie-break: the larger value wins; on equal values
// the smaller lag wins (the reference's first-maximum semantics).
__device__ __forceinline__ void peak_merge(float& v, int& lag, float v2,
                                           int lag2) {
  if (v2 > v || (v2 == v && lag2 < lag)) {
    v = v2;
    lag = lag2;
  }
}

// Block-wide (peak, first lag at the peak, sum); result in thread 0.
static __device__ void block_peak_sum(float& pk, int& lag, float& tot) {
  __shared__ float s_pk[TG_THREADS / 32], s_tot[TG_THREADS / 32];
  __shared__ int s_lag[TG_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    float v2 = __shfl_down_sync(0xffffffffu, pk, o);
    int l2 = __shfl_down_sync(0xffffffffu, lag, o);
    peak_merge(pk, lag, v2, l2);
    tot += __shfl_down_sync(0xffffffffu, tot, o);
  }
  if (lane == 0) {
    s_pk[warp] = pk;
    s_lag[warp] = lag;
    s_tot[warp] = tot;
  }
  __syncthreads();
  if (warp == 0) {
    pk = lane < TG_THREADS / 32 ? s_pk[lane] : -1.0f;
    lag = lane < TG_THREADS / 32 ? s_lag[lane] : 0x7fffffff;
    tot = lane < TG_THREADS / 32 ? s_tot[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) {
      float v2 = __shfl_down_sync(0xffffffffu, pk, o);
      int l2 = __shfl_down_sync(0xffffffffu, lag, o);
      peak_merge(pk, lag, v2, l2);
      tot += __shfl_down_sync(0xffffffffu, tot, o);
    }
  }
  __syncthreads();
}

// Dynamic shared memory above 48 KB needs an explicit opt-in per kernel.
template <typename K>
__host__ cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
