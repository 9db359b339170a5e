// Fused folded-acquisition correlate-reduce for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpu_gnss/ops/mxu_corr.py fold_corr_reduce
// (_fused_kernel_factory).  Per Doppler row: forward four-step DFT of the
// wiped+folded, zero-padded block, conj, product with every SV's
// wrap-folded code spectrum, inverse four-step DFT trimmed to the q_cols
// lag columns, |.|^2 summed over n_acc blocks, then peak, first-max lag
// and total over the P valid lags.  Same index maps as four_step_np:
// spectrum k = k1*n2 + k2, time n = n1*u + v, lag = n1*q + t; the DFT
// factors arrive as tables built from it, so the conventions cannot drift.
//
// What bounds it on this card: float32 FMA throughput.  A row's inverse stage
// is n_sv * (n2*n1*n1 + n1*n2*q_cols) complex MACs (2.7 M per SV at
// NF = 16384), against a few hundred KB of data per row.
//
// Design: two passes.
//  Pass A, one block per (row, acc block): the forward DFT of that block,
//    written conjugated to a float2 scratch [rows, n_acc, n2, n1] in the
//    code planes' [k2, k1] layout.  This scratch round trip through device
//    memory is what the TPU kernel avoided; it is the first target of a
//    later performance change.
//  Pass B, one block per (row, SV): for each acc block, the spectrum
//    product is staged a few k2-rows at a time in shared memory, the first
//    inverse stage (times the twiddles) fills B[k2, t] in shared memory,
//    the second stage produces only the q_cols lag columns, and |.|^2
//    accumulates in shared memory.  A block reduction gives peak, smallest
//    lag among peak cells, and total.  Up to ~166 KB of dynamic shared
//    memory at NF = 16384.
// Plain CUDA-core float32 FMAs; no tensor cores yet (a later change).

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(TG_THREADS)
fcr_forward(const float* __restrict__ x_r, const float* __restrict__ x_i,
            const float2* __restrict__ f2, const float2* __restrict__ wt,
            const float2* __restrict__ f1, float2* __restrict__ g, int n1,
            int n2, int u_rows) {
  extern __shared__ float2 sm[];
  float2* y = sm;                    // [u_rows, n1]  time block
  float2* z = sm + u_rows * n1;      // [n2, n1]     after stage 1 + twiddle
  const size_t blk = blockIdx.x;     // row * n_acc + acc
  const int ny = u_rows * n1, nf = n1 * n2;
  const float* br = x_r + blk * ny;
  const float* bi = x_i + blk * ny;
  for (int i = threadIdx.x; i < ny; i += blockDim.x)
    y[i] = make_float2(br[i], bi[i]);
  __syncthreads();
  // Z[k2, v] = wt[k2, v] * sum_u f2[k2, u] Y[u, v]
  for (int i = threadIdx.x; i < nf; i += blockDim.x) {
    const int k2 = i / n1, v = i - k2 * n1;
    float2 acc = make_float2(0.f, 0.f);
    for (int u = 0; u < u_rows; ++u)
      cfma(acc, f2[k2 * u_rows + u], y[u * n1 + v]);
    z[i] = cmul(acc, wt[i]);
  }
  __syncthreads();
  // G^T[k2, k1] = sum_v Z[k2, v] f1[v, k1]; stored conjugated
  float2* out = g + blk * nf;
  for (int i = threadIdx.x; i < nf; i += blockDim.x) {
    const int k2 = i / n1, k1 = i - k2 * n1;
    float2 acc = make_float2(0.f, 0.f);
    const float2* zr = z + k2 * n1;
    for (int v = 0; v < n1; ++v) cfma(acc, zr[v], f1[v * n1 + k1]);
    out[i] = make_float2(acc.x, -acc.y);
  }
}

__global__ void __launch_bounds__(TG_THREADS)
fcr_reduce(const float2* __restrict__ g, const float* __restrict__ cw_r,
           const float* __restrict__ cw_i, const float2* __restrict__ e1,
           const float2* __restrict__ tw, const float2* __restrict__ e2,
           float* __restrict__ peak, int* __restrict__ lag_out,
           float* __restrict__ tot_out, int n_acc, int n_sv, int n1, int n2,
           int q_cols, int period, int stage_rows) {
  extern __shared__ float2 sm[];
  const int nf = n1 * n2, npw = n1 * q_cols;
  float2* sb = sm;                          // [n2, n1]   inverse stage 1
  float2* sp = sm + nf;                     // [stage_rows, n1] product rows
  float* pw = reinterpret_cast<float*>(sp + stage_rows * n1);  // [q, t]
  const int row = blockIdx.x / n_sv, sv = blockIdx.x - row * n_sv;
  const float* cr = cw_r + static_cast<size_t>(sv) * nf;
  const float* ci = cw_i + static_cast<size_t>(sv) * nf;
  for (int i = threadIdx.x; i < npw; i += blockDim.x) pw[i] = 0.f;

  for (int b = 0; b < n_acc; ++b) {
    const float2* gb = g + (static_cast<size_t>(row) * n_acc + b) * nf;
    for (int k0 = 0; k0 < n2; k0 += stage_rows) {
      const int nr = min(stage_rows, n2 - k0);
      __syncthreads();                      // sp reuse
      for (int i = threadIdx.x; i < nr * n1; i += blockDim.x) {
        const int j = k0 * n1 + i;
        sp[i] = cmul(make_float2(cr[j], ci[j]), gb[j]);
      }
      __syncthreads();
      // B[k2, t] = tw[k2, t] * sum_k1 M[k2, k1] e1[k1, t]
      for (int i = threadIdx.x; i < nr * n1; i += blockDim.x) {
        const int r = i / n1, t = i - r * n1;
        float2 acc = make_float2(0.f, 0.f);
        const float2* mr = sp + r * n1;
        for (int k1 = 0; k1 < n1; ++k1) cfma(acc, mr[k1], e1[k1 * n1 + t]);
        const int j = (k0 + r) * n1 + t;
        sb[j] = cmul(acc, tw[j]);
      }
    }
    __syncthreads();
    // R[t, q] = sum_k2 B[k2, t] e2[k2, q]; cell i = q*n1 + t = lag
    for (int i = threadIdx.x; i < npw; i += blockDim.x) {
      const int q = i / n1, t = i - q * n1;
      float2 acc = make_float2(0.f, 0.f);
      for (int k2 = 0; k2 < n2; ++k2)
        cfma(acc, sb[k2 * n1 + t], e2[k2 * q_cols + q]);
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

extern "C" int fold_corr_reduce_launch(
    const float* x_r, const float* x_i, const float* cw_r, const float* cw_i,
    const float2* f2, const float2* wt, const float2* f1, const float2* e1,
    const float2* tw, const float2* e2, float2* scratch, float* peak,
    int* lag, float* tot, int rows, int n_acc, int n_sv, int n1, int n2,
    int u_rows, int q_cols, int period, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem_a =
      sizeof(float2) * (size_t(u_rows) * n1 + size_t(n1) * n2);
  cudaError_t err = allow_smem(fcr_forward, smem_a);
  if (err != cudaSuccess) return err;
  fcr_forward<<<rows * n_acc, TG_THREADS, smem_a, st>>>(
      x_r, x_i, f2, wt, f1, scratch, n1, n2, u_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int stage_rows = max(1, min(n2, 2048 / n1));
  const size_t smem_b =
      sizeof(float2) * (size_t(n1) * n2 + size_t(stage_rows) * n1) +
      sizeof(float) * size_t(n1) * q_cols;
  err = allow_smem(fcr_reduce, smem_b);
  if (err != cudaSuccess) return err;
  fcr_reduce<<<rows * n_sv, TG_THREADS, smem_b, st>>>(
      scratch, cw_r, cw_i, e1, tw, e2, peak, lag, tot, n_acc, n_sv, n1, n2,
      q_cols, period, stage_rows);
  return cudaGetLastError();
}
