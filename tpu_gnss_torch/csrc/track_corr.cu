// Fused tracking correlator for Hopper (sm_90a): wipe + DFT + E/P/L taps.
//
// Replaces the Pallas TPU kernel tpu_gnss/ops/mxu_track.py track_corr
// (_kernel_factory).  Per (1 ms epoch, channel): carrier wipe-off from
// (phase0, delta), forward four-step DFT of the zero-padded epoch, product
// with the channel's conjugated wrap-folded code spectrum, then the prompt
// tap sum_k W[k] e^{-j2pi keff[k] tau/NF} and the early/late taps, which
// multiply that ramp by fixed tap vectors t(+-d) or, when the early/late
// lag wraps around the code period, t(+-d -+ P).  Scaled 1/NF.
//
// What bounds it on this card: float32 FMA throughput in the DFT (n2*n1*
// (u_rows + n1) complex MACs per block, 2.7 M at NF = 16384) and, at the
// small e2e shape, launch latency: one step is only e_sub * n_chan = 120
// blocks, fewer than the 132 SMs.
//
// Design: one block per (epoch, channel).  The wiped epoch and the first
// DFT stage live in dynamic shared memory (up to ~200 KB at NF = 12500);
// the second stage is fused with the spectrum product and the three tap
// sums, so the spectrum never leaves registers.  The signed-frequency
// keff = k - NF for k >= NF/2 covers odd and even n1 alike (no rank-1
// branch).  The ramp phase keff*tau/NF is range-reduced exactly: with
// tau = ti + tf, (keff*ti mod NF)/NF is integer arithmetic and keff*tf/NF
// is below half a cycle, so float32 keeps it to ~1e-7 cycles at any NF.
// Channels are taken as they are (no padding).

#include "common.cuh"

namespace {

__device__ __forceinline__ float frac1(float x) { return x - floorf(x); }

__global__ void __launch_bounds__(TG_THREADS)
track_corr_kernel(const float* __restrict__ blk_r,
                  const float* __restrict__ blk_i,
                  const float* __restrict__ params,
                  const float* __restrict__ cw_r,
                  const float* __restrict__ cw_i,
                  const float2* __restrict__ f2, const float2* __restrict__ wt,
                  const float2* __restrict__ f1,
                  const float2* __restrict__ taps, float* __restrict__ out,
                  int n_chan, int n1, int n2, int u_rows, int nf) {
  extern __shared__ float2 sm[];
  float2* y = sm;                   // [u_rows, n1] wiped epoch
  float2* z = sm + u_rows * n1;     // [n2, n1]     stage 1 + twiddle
  const int e = blockIdx.x / n_chan, c = blockIdx.x - e * n_chan;
  const float* par = params + (static_cast<size_t>(e) * n_chan + c) * 5;
  const float phase0 = par[0], delta = par[1], tau = par[2];
  const bool wrap_e = par[3] > 0.5f, wrap_l = par[4] > 0.5f;
  const int ny = u_rows * n1;
  const float* br = blk_r + static_cast<size_t>(e) * ny;
  const float* bi = blk_i + static_cast<size_t>(e) * ny;
  // carrier wipe: sample n = n1*u + v, phase factored as in the reference
  for (int i = threadIdx.x; i < ny; i += blockDim.x) {
    const int u = i / n1, v = i - u * n1;
    float su, cu, sv, cv;
    const float pu = phase0 + delta * static_cast<float>(u * n1);
    sincospif(-2.0f * frac1(pu), &su, &cu);
    sincospif(-2.0f * frac1(delta * static_cast<float>(v)), &sv, &cv);
    const float2 lo = cmul(make_float2(cu, su), make_float2(cv, sv));
    y[i] = cmul(make_float2(br[i], bi[i]), lo);
  }
  __syncthreads();
  const int nyz = n2 * n1;
  for (int i = threadIdx.x; i < nyz; i += blockDim.x) {
    const int k2 = i / n1, v = i - k2 * n1;
    float2 acc = make_float2(0.f, 0.f);
    for (int u = 0; u < u_rows; ++u)
      cfma(acc, f2[k2 * u_rows + u], y[u * n1 + v]);
    z[i] = cmul(acc, wt[i]);
  }
  __syncthreads();
  const float ti = floorf(tau), tf = tau - ti;
  const long long tii = static_cast<long long>(ti);
  const size_t cbase = static_cast<size_t>(c) * nyz;
  const float2* te = taps + (wrap_e ? nyz : 0);        // t(d) or t(d-P)
  const float2* tl = taps + (wrap_l ? 3 * nyz : 2 * nyz);
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < nyz; i += blockDim.x) {
    const int k2 = i / n1, k1 = i - k2 * n1;
    float2 gk = make_float2(0.f, 0.f);
    const float2* zr = z + k2 * n1;
    for (int v = 0; v < n1; ++v) cfma(gk, zr[v], f1[v * n1 + k1]);
    const float2 p = cmul(make_float2(cw_r[cbase + i], cw_i[cbase + i]), gk);
    const long long k = static_cast<long long>(k1) * n2 + k2;
    const long long keff = k >= nf / 2 ? k - nf : k;
    long long m = (keff * tii) % nf;
    if (m < 0) m += nf;
    const float fnf = static_cast<float>(nf);
    const float ph = frac1(static_cast<float>(m) / fnf
                           + static_cast<float>(keff) * tf / fnf);
    float s, co;
    sincospif(-2.0f * ph, &s, &co);
    const float2 w = cmul(p, make_float2(co, s));
    const float2 we = cmul(w, te[i]);
    const float2 wl = cmul(w, tl[i]);
    acc[0] += w.x;
    acc[1] += w.y;
    acc[2] += we.x;
    acc[3] += we.y;
    acc[4] += wl.x;
    acc[5] += wl.y;
  }
  block_sum<6>(acc);
  if (threadIdx.x == 0) {
    float* o = out + (static_cast<size_t>(e) * n_chan + c) * 6;
    const float inv = 1.0f / static_cast<float>(nf);
#pragma unroll
    for (int j = 0; j < 6; ++j) o[j] = acc[j] * inv;
  }
}

}  // namespace

extern "C" int track_corr_launch(const float* blk_r, const float* blk_i,
                                 const float* params, const float* cw_r,
                                 const float* cw_i, const float2* f2,
                                 const float2* wt, const float2* f1,
                                 const float2* taps, float* out, int e_sub,
                                 int n_chan, int n1, int n2, int u_rows,
                                 int nf, void* stream) {
  const size_t smem = sizeof(float2) * (size_t(u_rows) * n1 + size_t(n1) * n2);
  cudaError_t err = allow_smem(track_corr_kernel, smem);
  if (err != cudaSuccess) return err;
  track_corr_kernel<<<e_sub * n_chan, TG_THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      blk_r, blk_i, params, cw_r, cw_i, f2, wt, f1, taps, out, n_chan, n1, n2,
      u_rows, nf);
  return cudaGetLastError();
}
