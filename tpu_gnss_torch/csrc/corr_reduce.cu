// Correlate-reduce from precomputed data spectra for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpu_gnss/ops/mxu_corr.py corr_reduce
// (_kernel_factory, the "v1" of fold_corr_reduce).  Per (row, SV): the
// product M = cw[sv] * g[row, b] of the wrap-folded code spectrum with the
// conjugated data spectrum of each of the n_acc blocks, the inverse
// four-step DFT R[t, q] = sum_k2 e2[k2, q] tw[t, k2] sum_k1 e1[t, k1]
// M[k1, k2] (lag = n1*q + t), |R|^2 summed over the n_acc blocks, then peak,
// first-max lag and total over the P valid lags.  Inputs are in the
// reference's [k1, k2] row-major layout (spectrum index k1*n2 + k2),
// indexed as they are.
//
// What bounds it on this card: float32 FMA throughput.  Each (row, SV) is
// n_acc * (n1*n1*n2 + n1*n2*q_cols) complex MACs (2.8 M at NF = 16384,
// P = 5456) against 2 * 8 * NF bytes of spectra per block.
//
// Design: one block per (row, SV), which loops over the n_acc blocks (the
// TPU kernel's sequential grid).  For each block, a few k2-columns of the
// product at a time are staged in shared memory [n1, stage]; stage 1 (times
// the twiddles) fills B[k2, t] in shared memory; stage 2 produces only the
// q_cols = ceil(P/n1) lag columns and adds |.|^2 to a shared accumulator.
// One block reduction (peak_merge / block_peak_sum) gives peak, the
// smallest lag among peak cells, and total.  Shared memory: 8*NF + 8*stage*n1
// + 4*n1*q_cols bytes (about 166 KB at NF = 16384).  Plain CUDA-core float32
// FMAs; no tensor cores yet.

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(TG_THREADS)
corr_reduce_kernel(const float* __restrict__ g_r, const float* __restrict__ g_i,
                   const float* __restrict__ cw_r,
                   const float* __restrict__ cw_i,
                   const float2* __restrict__ e1, const float2* __restrict__ tw,
                   const float2* __restrict__ e2, float* __restrict__ peak,
                   int* __restrict__ lag_out, float* __restrict__ tot_out,
                   int n_acc, int n_sv, int n1, int n2, int q_cols, int period,
                   int stage) {
  extern __shared__ float2 sm[];
  const int nf = n1 * n2, npw = n1 * q_cols;
  float2* sb = sm;                          // [n2, n1]     inverse stage 1
  float2* sp = sm + nf;                     // [n1, stage]  product columns
  float* pw = reinterpret_cast<float*>(sp + stage * n1);  // [q, t]
  const int row = blockIdx.x / n_sv, sv = blockIdx.x - row * n_sv;
  const float* cr = cw_r + static_cast<size_t>(sv) * nf;
  const float* ci = cw_i + static_cast<size_t>(sv) * nf;
  for (int i = threadIdx.x; i < npw; i += blockDim.x) pw[i] = 0.f;

  for (int b = 0; b < n_acc; ++b) {
    const size_t off = (static_cast<size_t>(row) * n_acc + b) * nf;
    const float* gr = g_r + off;
    const float* gi = g_i + off;
    for (int k0 = 0; k0 < n2; k0 += stage) {
      const int nc = min(stage, n2 - k0);
      __syncthreads();                      // sp reuse
      // M[k1, k0 + c] for c < nc: runs of nc contiguous spectrum bins
      for (int i = threadIdx.x; i < n1 * nc; i += blockDim.x) {
        const int k1 = i / nc, c = i - k1 * nc;
        const int j = k1 * n2 + k0 + c;
        sp[k1 * stage + c] =
            cmul(make_float2(cr[j], ci[j]), make_float2(gr[j], gi[j]));
      }
      __syncthreads();
      // B[k2, t] = tw[t, k2] * sum_k1 e1[t, k1] M[k1, k2]; e1 is symmetric,
      // so e1[k1 * n1 + t] reads it along t (coalesced)
      for (int i = threadIdx.x; i < nc * n1; i += blockDim.x) {
        const int c = i / n1, t = i - c * n1;
        float2 acc = make_float2(0.f, 0.f);
        for (int k1 = 0; k1 < n1; ++k1)
          cfma(acc, sp[k1 * stage + c], e1[k1 * n1 + t]);
        const int k2 = k0 + c;
        sb[k2 * n1 + t] = cmul(acc, tw[t * n2 + k2]);
      }
    }
    __syncthreads();
    // R[t, q] = sum_k2 B[k2, t] e2[k2, q]; cell i = q*n1 + t = lag
    for (int i = threadIdx.x; i < npw; i += blockDim.x) {
      const int q = i / n1, t = i - q * n1;
      float2 acc = make_float2(0.f, 0.f);
      for (int k2 = 0; k2 < n2; ++k2)
        cfma(acc, sb[k2 * n1 + t], e2[k2 * n2 + q]);
      pw[i] += acc.x * acc.x + acc.y * acc.y;
    }
  }
  __syncthreads();
  float pk = -1.0f, tot = 0.0f;
  int lag = 0x7fffffff;
  const int nvalid = min(npw, period);      // lag = n1*q + t = i
  for (int i = threadIdx.x; i < nvalid; i += blockDim.x) {
    const float v = pw[i];
    tot += v;
    peak_merge(pk, lag, v, i);
  }
  block_peak_sum(pk, lag, tot);
  if (threadIdx.x == 0) {
    const size_t o = static_cast<size_t>(row) * n_sv + sv;
    peak[o] = pk;
    lag_out[o] = lag;
    tot_out[o] = tot;
  }
}

}  // namespace

extern "C" int corr_reduce_launch(
    const float* g_r, const float* g_i, const float* cw_r, const float* cw_i,
    const float2* e1, const float2* tw, const float2* e2, float* peak,
    int* lag, float* tot, int rows, int n_acc, int n_sv, int n1, int n2,
    int q_cols, int period, void* stream) {
  const int stage = max(1, min(n2, 2048 / n1));
  const size_t smem =
      sizeof(float2) * (size_t(n1) * n2 + size_t(stage) * n1) +
      sizeof(float) * size_t(n1) * q_cols;
  cudaError_t err = allow_smem(corr_reduce_kernel, smem);
  if (err != cudaSuccess) return err;
  corr_reduce_kernel<<<rows * n_sv, TG_THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      g_r, g_i, cw_r, cw_i, e1, tw, e2, peak, lag, tot, n_acc, n_sv, n1, n2,
      q_cols, period, stage);
  return cudaGetLastError();
}
