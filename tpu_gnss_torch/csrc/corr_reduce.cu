// Correlate-reduce from precomputed data spectra for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpu_gnss/ops/mxu_corr.py corr_reduce
// (_kernel_factory, the "v1" of fold_corr_reduce).  Per (row, SV): the
// product M = cw[sv] * g[row, b] of the wrap-folded code spectrum with the
// conjugated data spectrum of each of the n_acc blocks, the inverse
// four-step DFT R[t, q] = sum_k2 e2[k2, q] tw[t, k2] sum_k1 e1[t, k1]
// M[k1, k2] (lag = n1*q + t), |R|^2 summed over the n_acc blocks, then peak,
// first-max lag and total over the P valid lags.  Inputs are in the
// reference's [k1, k2] row-major layout (spectrum index k1*n2 + k2).
//
// Design: one block per row and group of SVs (one SV when its tasks fill
// the block's 8 warps, up to 8 at n1 = 16) runs the inverse stage pair of
// four_step_mma.cuh (TF32 tensor-core MMAs, f32 accumulation; its header
// says why that keeps the decisions) over the n_acc blocks, the TPU
// kernel's sequential grid; the product is formed while it is staged, read
// in the inputs' own [k1, k2] layout.  The tables are those of
// fold_corr_reduce's inverse pass.
//
// What bounds it: the latency of the shared stage pair (its note in
// four_step_mma.cuh), not the tensor cores; each (row, SV) is n_acc *
// (n1*n1*n2 + n1*n2*q_cols) complex MACs (2.8 M at NF = 16384, P = 5456)
// against 16 * NF bytes of spectra and code planes per block, read from
// L2.

#include "four_step_mma.cuh"

namespace {

template <int NQ>
__global__ void __launch_bounds__(TG_THREADS, 1)
corr_reduce_kernel(const float* __restrict__ g_r,
                   const float* __restrict__ g_i,
                   const float* __restrict__ cw_r,
                   const float* __restrict__ cw_i, fsm::Geo geo,
                   fsm::Plan plan, float* __restrict__ peak,
                   int* __restrict__ lag, float* __restrict__ tot, int n_acc,
                   int n_sv, int q_cols, int period) {
  const int groups = fsm::cdiv(n_sv, plan.gi);
  const int row = blockIdx.x / groups;
  const int sv0 = (blockIdx.x - row * groups) * plan.gi;
  const int n1 = geo.m, n2 = geo.j, nf = n1 * n2;
  const size_t off = size_t(row) * n_acc * nf;
  fsm::reduce_block<NQ, 4>(
      geo, plan, min(plan.gi, n_sv - sv0), n_acc, n1, q_cols, period,
      [&](int item, int acc, int k1, int k2, bool valid, float* dst) {
        const int sv = sv0 + item;
        valid = valid && sv < n_sv;
        const size_t i = valid ? size_t(k1) * n2 + k2 : 0;
        const size_t c = valid ? size_t(sv) * nf + i : 0;
        const size_t b = valid ? off + size_t(acc) * nf + i : 0;
        fsm::cp_async4(dst, cw_r + c, valid);
        fsm::cp_async4(dst + 32, cw_i + c, valid);
        fsm::cp_async4(dst + 64, g_r + b, valid);
        fsm::cp_async4(dst + 96, g_i + b, valid);
      },
      [](const float* r) {
        return cmul(make_float2(r[0], r[32]), make_float2(r[64], r[96]));
      },
      peak, lag, tot, size_t(row) * n_sv + sv0);
}

}  // namespace

extern "C" int corr_reduce_launch(
    const float* g_r, const float* g_i, const float* cw_r, const float* cw_i,
    const float* ia1, const float2* itw, const float* ib2, float* peak,
    int* lag, float* tot, int rows, int n_acc, int n_sv, int n1, int n2,
    int q_cols, int period, void* stream) {
  const fsm::Geo inv = fsm::make_geo(n1, n1, n2, q_cols, ia1, itw, ib2);
  const fsm::Plan plan = fsm::make_plan(inv, 4, n_sv, fsm::MAX_WARPS);
  const int blocks = rows * fsm::cdiv(n_sv, plan.gi);
  cudaError_t err = cudaSuccess;
  FSM_DISPATCH_NQ(inv.nq,
    const size_t smem = fsm::reduce_bytes<NQ>(plan, n_acc);
    err = allow_smem(corr_reduce_kernel<NQ>, smem);
    if (err != cudaSuccess) return err;
    corr_reduce_kernel<NQ><<<blocks, plan.warps * 32, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        g_r, g_i, cw_r, cw_i, inv, plan, peak, lag, tot, n_acc, n_sv,
        q_cols, period);
  )
  return cudaGetLastError();
}
