// Fused folded-acquisition correlate-reduce for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpu_gnss/ops/mxu_corr.py fold_corr_reduce
// (_fused_kernel_factory).  Per Doppler row: forward four-step DFT of the
// wiped+folded, zero-padded block, conj, product with every SV's
// wrap-folded code spectrum, inverse four-step DFT trimmed to the q_cols
// lag columns, |.|^2 summed over n_acc blocks, then peak, first-max lag
// and total over the P valid lags.  Same index maps as four_step_np:
// spectrum k = k1*n2 + k2, time n = n1*u + v, lag = n1*q + t; the DFT
// factors arrive as tables built from it (ops/mxu_corr.mma_tables).
//
// Design: two passes, both the tensor-core stage pair of four_step_mma.cuh
// (TF32 operands, f32 accumulation; its header says why that keeps the
// decisions).
//  Pass A (fcr_forward): G^T[k2, k1] = ((F2 @ Y) * Wt) @ F1, conjugated,
//    into a complex64 scratch [rows, n_acc, n2, n1] in the code planes'
//    [k2, k1] layout.  One warp per (16 k2, run of k1 columns) task and
//    FWD_WARPS tasks per block, so the grid is rows * n_acc * ceil(tasks /
//    FWD_WARPS) blocks: 292 at nottingham's 73 rows, more than the 132 SMs.
//  Pass B (fcr_reduce): one block per row and group of SVs runs the
//    inverse stage pair on the product of the code planes and the scratch,
//    formed while it is staged in the [k2, k1] layout they share, and
//    reduces; blocks of one row run next to each other, so the row's
//    scratch is read from L2.
//
// What bounds it: pass B, the latency of the shared stage pair (its note
// in four_step_mma.cuh); pass A is small beside it (0.049 of 0.71 ms of
// device time at nottingham, H100).  The scratch round trip costs 16 bytes
// per spectrum bin and row (write and read), from L2 when it fits.

#include "four_step_mma.cuh"

namespace {

constexpr int FWD_WARPS = 4;

template <int NQ>
__global__ void __launch_bounds__(FWD_WARPS * 32)
fcr_forward(const float* __restrict__ x_r, const float* __restrict__ x_i,
            fsm::Geo geo, fsm::Plan plan, int blocks_per,
            float2* __restrict__ scratch) {
  extern __shared__ float4 fsm_smem[];
  const int blk = blockIdx.x / blocks_per;      // row * n_acc + acc
  const int part = blockIdx.x - blk * blocks_per;
  const int n1 = geo.j, n2 = geo.m;
  const int task = part * FWD_WARPS + (threadIdx.x >> 5);
  const bool active = task < plan.tasks;
  const size_t xoff = size_t(blk) * geo.k * n1;  // [u_rows, n1] time block
  float2* out = scratch + size_t(blk) * n1 * n2;
  fsm::four_step<NQ, 2>(
      geo, plan, 0, active ? task : 0, active, 1, fsm_smem,
      [&](int, int, int u, int v, bool valid, float* dst) {
        const size_t i = valid ? xoff + size_t(u) * n1 + v : 0;
        fsm::cp_async4(dst, x_r + i, valid);
        fsm::cp_async4(dst + 32, x_i + i, valid);
      },
      [](const float* r) { return make_float2(r[0], r[32]); },
      [&](int, int, int k2, int k1, float re, float im) {
        if (k2 < n2 && k1 < n1) out[size_t(k2) * n1 + k1] = make_float2(re, -im);
      });
}

template <int NQ>
__global__ void __launch_bounds__(TG_THREADS, 1)
fcr_reduce(const float2* __restrict__ g, const float* __restrict__ cw_r,
           const float* __restrict__ cw_i, fsm::Geo geo, fsm::Plan plan,
           float* __restrict__ peak, int* __restrict__ lag,
           float* __restrict__ tot, int n_acc, int n_sv, int q_cols,
           int period) {
  const int groups = fsm::cdiv(n_sv, plan.gi);
  const int row = blockIdx.x / groups;
  const int sv0 = (blockIdx.x - row * groups) * plan.gi;
  const int n1 = geo.m, nf = n1 * geo.j;
  const float2* gr = g + size_t(row) * n_acc * nf;
  // B1[k1, k2] = cw[sv][k2, k1] * G^T[row, acc][k2, k1]
  fsm::reduce_block<NQ, 4>(
      geo, plan, min(plan.gi, n_sv - sv0), n_acc, n1, q_cols, period,
      [&](int item, int acc, int k1, int k2, bool valid, float* dst) {
        const int sv = sv0 + item;
        valid = valid && sv < n_sv;
        const size_t i = valid ? size_t(k2) * n1 + k1 : 0;
        const size_t c = valid ? size_t(sv) * nf + i : 0;
        const float* gi = reinterpret_cast<const float*>(
            gr + (valid ? size_t(acc) * nf + i : 0));
        fsm::cp_async4(dst, cw_r + c, valid);
        fsm::cp_async4(dst + 32, cw_i + c, valid);
        fsm::cp_async4(dst + 64, gi, valid);
        fsm::cp_async4(dst + 96, gi + 1, valid);
      },
      [](const float* r) {
        return cmul(make_float2(r[0], r[32]), make_float2(r[64], r[96]));
      },
      peak, lag, tot, size_t(row) * n_sv + sv0);
}

}  // namespace

extern "C" int fold_corr_reduce_launch(
    const float* x_r, const float* x_i, const float* cw_r, const float* cw_i,
    const float* fa1, const float2* ftw, const float* fb2, const float* ia1,
    const float2* itw, const float* ib2, float2* scratch, float* peak,
    int* lag, float* tot, int rows, int n_acc, int n_sv, int n1, int n2,
    int u_rows, int q_cols, int period, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  const fsm::Geo fwd = fsm::make_geo(n2, u_rows, n1, n1, fa1, ftw, fb2);
  const fsm::Plan fp = fsm::make_plan(fwd, 2, 1, FWD_WARPS);
  const int per = fsm::cdiv(fp.tasks, FWD_WARPS);
  FSM_DISPATCH_NQ(fwd.nq,
    err = allow_smem(fcr_forward<NQ>, fp.bytes);
    if (err != cudaSuccess) return err;
    fcr_forward<NQ><<<rows * n_acc * per, FWD_WARPS * 32, fp.bytes, st>>>(
        x_r, x_i, fwd, fp, per, scratch);
  )
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const fsm::Geo inv = fsm::make_geo(n1, n1, n2, q_cols, ia1, itw, ib2);
  const fsm::Plan plan = fsm::make_plan(inv, 4, n_sv, fsm::MAX_WARPS);
  const int blocks = rows * fsm::cdiv(n_sv, plan.gi);
  FSM_DISPATCH_NQ(inv.nq,
    const size_t smem = fsm::reduce_bytes<NQ>(plan, n_acc);
    err = allow_smem(fcr_reduce<NQ>, smem);
    if (err != cudaSuccess) return err;
    fcr_reduce<NQ><<<blocks, plan.warps * 32, smem, st>>>(
        scratch, cw_r, cw_i, inv, plan, peak, lag, tot, n_acc, n_sv, q_cols,
        period);
  )
  return cudaGetLastError();
}
