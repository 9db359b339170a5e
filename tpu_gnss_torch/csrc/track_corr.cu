// Fused tracking correlator for Hopper (sm_90a): wipe + DFT + E/P/L taps.
//
// Replaces the Pallas TPU kernel tpu_gnss/ops/mxu_track.py track_corr
// (_kernel_factory).  Per (1 ms epoch, channel) item: carrier wipe-off from
// (phase0, delta), forward four-step DFT of the zero-padded epoch, product
// with the channel's conjugated wrap-folded code spectrum, then the prompt
// tap sum_k W[k] e^{-j2pi keff[k] tau/NF} and the early/late taps, which
// multiply that ramp by fixed tap vectors t(+-d) or, when the early/late
// lag wraps around the code period, t(+-d -+ P).  Scaled 1/NF.
//
// Design: one block per item runs the forward stage pair of
// four_step_mma.cuh (TF32 tensor-core MMAs, f32 accumulation), m = k2,
// k = u, j = v, n = k1 with A1 = F2, tw = Wt, B2 = F1: the tables of
// fold_corr_reduce's pass A (ops/mxu_corr.mma_tables(nf, period)[0]).  Its
// tasks (16 k2 rows x a run of k1 columns) fill up to 8 warps and run in
// rounds above that (2 at NF = 16384).
//  * The wipe is formed while the epoch is staged: each thread copies the
//    raw planes of its own fragment slots with cp.async, and combine
//    multiplies each landed sample by the LO phasor lo_u[u] * lo_v[v]
//    (sample n1*u + v), two tables the block fills once in shared memory.
//  * The ramp and the taps factor over k = k1*n2 + k2, keff = k - NF*h
//    (h = [k >= NF/2]), as in the TPU kernel's rank-1 path:
//      e^{-j2pi keff x/NF} = c(x)[k1] * r(x)[k2] * (h ? e^{+j2pi x} : 1),
//    c(x)[k1] = e^{-j2pi k1 x/n1}, r(x)[k2] = e^{-j2pi k2 x/NF}.  The
//    block builds the three lags' factors (x = tau, tau + d_e, tau + d_l)
//    once in shared memory: tau's from its integer part ti and fraction
//    tf, range-reduced exactly ((k1*ti mod n1)/n1 and (k2*ti mod NF)/NF in
//    int32, n2*NF < 2^31 checked by the wrapper; k*tf/n below one cycle),
//    times the host's float64-built tap factors of d_e and d_l
//    (ops/mxu_track.tap_factors), chosen by the wrap flags.  An element
//    then costs the code product and three
//    complex products of shared factors: no sin/cos, no modulo, no tap
//    grids read from memory.
//  * The epilogue: four_step hands G[k2, k1] over from the stage-2
//    accumulators (the [k2, k1] layout of spec_planes' code planes); each
//    lane parks its values in its own slots of a per-warp shared buffer,
//    and once four_step has returned (its MMA registers dead) applies the
//    code planes and the factors with six sums in registers.  The block
//    reduces the sums over its warps in a fixed order, so the result does
//    not change from run to run (no float atomics, no second pass).
//
// What bounds it: as four_step_mma.cuh says, latency and issue, not the
// tensor cores (n2*n1*(u_rows + n1) complex MACs per item, 2.8 M at
// NF = 16384: 0.27 GFLOP for 120 items is ~0.6 us at the TF32 peak); at
// the e2e shape (NF = 2048, 120 items) a launch is a few microseconds of
// latency for 120 blocks on the 132 SMs.

#include "four_step_mma.cuh"

namespace {

// e^{-j 2 pi frac(cycles)}
__device__ __forceinline__ float2 phasor(float cycles) {
  float s, c;
  sincospif(-2.0f * (cycles - floorf(cycles)), &s, &c);
  return make_float2(c, s);
}

template <int NQ>
__global__ void __launch_bounds__(TG_THREADS, 1)
track_corr_kernel(const float* __restrict__ blk_r,
                  const float* __restrict__ blk_i,
                  const float* __restrict__ params,
                  const float* __restrict__ cw_r,
                  const float* __restrict__ cw_i,
                  const float2* __restrict__ tapf, fsm::Geo geo,
                  fsm::Plan plan, float* __restrict__ out, int n_chan,
                  int nf) {
  extern __shared__ float4 fsm_smem[];
  __shared__ float part[fsm::MAX_WARPS][6];
  const int item = blockIdx.x;                       // e * n_chan + c
  const int e = item / n_chan, c = item - e * n_chan;
  const int n2 = geo.m, n1 = geo.j, nyz = n2 * n1, nfac = n1 + n2 + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = blockDim.x;
  // after four_step's own buffers: lo_u [8*ks], lo_v [8*js], the factors
  // fac [3 lags][n1 columns, n2 rows, 1 upper-half phasor] and each warp's
  // parked Out values [4*NQ][32]
  float2* lo_u = reinterpret_cast<float2*>(fsm_smem + plan.bytes / 16);
  float2* lo_v = lo_u + 8 * geo.ks;
  float2* fac = lo_v + 8 * geo.js;
  float2* park = fac + 3 * nfac + warp * 4 * NQ * 32 + lane;
  {
    const float* par = params + size_t(item) * 5;
    const float phase0 = par[0], delta = par[1], tau = par[2];
    for (int i = threadIdx.x; i < 8 * geo.ks; i += nt)
      lo_u[i] = phasor(phase0 + delta * static_cast<float>(i * n1));
    for (int i = threadIdx.x; i < 8 * geo.js; i += nt)
      lo_v[i] = phasor(delta * static_cast<float>(i));
    // tap factor sets of the host table: d, d - P, -d, -d + P
    const float2* fe = tapf + (par[3] > 0.5f ? 1 : 0) * nfac;
    const float2* fl = tapf + (par[4] > 0.5f ? 3 : 2) * nfac;
    const float ti = floorf(tau), tf = tau - ti;
    int tim = static_cast<int>(fmodf(ti, static_cast<float>(nf)));
    tim = tim < 0 ? tim + nf : tim;
    for (int i = threadIdx.x; i < nfac; i += nt) {
      float2 a;
      if (i < n1) {                                  // column k1
        a = phasor(static_cast<float>((i * (tim % n1)) % n1) / n1 +
                   static_cast<float>(i) * tf / n1);
      } else if (i < n1 + n2) {                      // row k2
        const int k2 = i - n1;
        a = phasor(static_cast<float>((k2 * tim) % nf) / nf +
                   static_cast<float>(k2) * tf / nf);
      } else {                                       // e^{+j2pi tau}
        a = phasor(-tf);
      }
      fac[i] = a;
      fac[nfac + i] = cmul(a, __ldg(fe + i));
      fac[2 * nfac + i] = cmul(a, __ldg(fl + i));
    }
  }
  // (four_step's first barrier orders the tables before their reads)
  const size_t xoff = size_t(e) * geo.k * n1;        // [u_rows, n1] epoch
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int r = 0; r < plan.rounds; ++r) {
    const int task = r * plan.wpi + warp;
    const bool active = task < plan.tasks;
    fsm::four_step<NQ, 2>(
        geo, plan, 0, active ? task : 0, active, 1, fsm_smem,
        [&](int, int, int u, int v, bool valid, float* dst) {
          const size_t i = valid ? xoff + size_t(u) * n1 + v : 0;
          fsm::cp_async4(dst, blk_r + i, valid);
          fsm::cp_async4(dst + 32, blk_i + i, valid);
        },
        [&](int, int u, int v, const float* s) {
          return cmul(make_float2(s[0], s[32]), cmul(lo_u[u], lo_v[v]));
        },
        [&](int, int slot, int, int, float re, float im) {
          park[slot * 32] = make_float2(re, im);
        });
    if (!active) continue;
    const size_t cbase = size_t(c) * nyz;            // code planes [k2, k1]
#pragma unroll 8
    for (int slot = 0; slot < 4 * NQ; ++slot) {
      int k2, k1;
      fsm::out_place<NQ>(geo, task, slot, lane, k2, k1);
      if (k2 >= n2 || k1 >= n1) continue;
      const int i = k2 * n1 + k1;
      const float2 p =
          cmul(make_float2(__ldg(cw_r + cbase + i), __ldg(cw_i + cbase + i)),
               park[slot * 32]);
      const bool upper = k1 * n2 + k2 >= nf / 2;
#pragma unroll
      for (int x = 0; x < 3; ++x) {
        const float2* f = fac + x * nfac;
        float2 w = cmul(f[k1], f[n1 + k2]);
        if (upper) w = cmul(w, f[n1 + n2]);
        w = cmul(p, w);
        acc[2 * x] += w.x;
        acc[2 * x + 1] += w.y;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) acc[j] = warp_sum(acc[j]);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 6; ++j) part[warp][j] = acc[j];
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    float s = 0.0f;
    for (int w = 0; w < nt / 32; ++w) s += part[w][threadIdx.x];
    out[size_t(item) * 6 + threadIdx.x] = s / static_cast<float>(nf);
  }
}

}  // namespace

extern "C" int track_corr_launch(const float* blk_r, const float* blk_i,
                                 const float* params, const float* cw_r,
                                 const float* cw_i, const float* fa1,
                                 const float2* ftw, const float* fb2,
                                 const float2* tapf, float* out, int e_sub,
                                 int n_chan, int n1, int n2, int u_rows,
                                 int nf, void* stream) {
  const fsm::Geo geo = fsm::make_geo(n2, u_rows, n1, n1, fa1, ftw, fb2);
  const fsm::Plan plan = fsm::make_plan(geo, 2, 1, fsm::MAX_WARPS);
  const int threads = plan.warps * 32;
  cudaError_t err = cudaSuccess;
  FSM_DISPATCH_NQ(geo.nq,
    const size_t smem = plan.bytes +
        sizeof(float2) * (8 * (geo.ks + geo.js) + 3 * (n1 + n2 + 1) +
                          4 * NQ * threads);
    err = allow_smem(track_corr_kernel<NQ>, smem);
    if (err != cudaSuccess) return err;
    track_corr_kernel<NQ><<<e_sub * n_chan, threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
        blk_r, blk_i, params, cw_r, cw_i, tapf, geo, plan, out, n_chan, nf);
  )
  return cudaGetLastError();
}
