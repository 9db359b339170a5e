// Tracking loop update of the channel bank, one step (sm_90a).
//
// Replaces the fused body of the lax.scan at tpu_gnss/track/channel.py:
// 323-541 after its correlators (there is no Pallas kernel for it: XLA
// fuses it inside the one program per chunk that jax.jit makes of
// track_epochs).  Per channel, from the step's correlator taps and the
// packed state: the Costas, FLL and DLL discriminators averaged over the
// step's epochs, the loop filters, the strong-signal AGC, the carrier and
// code NCO advance and the running prompt power; it writes the new state
// in place, the step's rows of the seven EpochOut planes, and the next
// step's track_corr parameters.  The plain version is
// track/channel.py loop_update_plain; track_corr and this kernel are the
// two launches of a step, which track/graph.py captures as one CUDA graph
// per chunk.
//
// What bounds it on this card: launch latency.  A step moves ~2-4 KB
// (taps 24 bytes and parameters 20 bytes per epoch and channel, 12 state
// words and 7 output words per epoch and channel), so its bytes bound is
// far under 1 us, and its arithmetic is a few hundred float operations
// per channel.
//
// Design: one thread per channel (one block up to 256 channels), each
// looping over the step's e_sub epochs in float32 in the plain version's
// order of operations.  Products and sums go through __fmul_rn /
// __fadd_rn so that nvcc cannot contract them into FMAs the plain version
// does not do; a division by a host scalar is a product with its float32
// reciprocal, and a mean is the sum times float32(1 / e_sub), as PyTorch's
// CUDA kernels compute them.  Every value that changes during a run is in
// device memory (the state and aid_offset): a graph that captured this
// launch reads them at each replay.  The flags active and agc_on are
// 0.0 / 1.0 rows of the float state.

#include "common.cuh"

namespace {

constexpr int kStateRows = 12;  // ChannelState._fields
constexpr float kCodeLen = 1023.0f;

enum Row {
  kActive, kCarrierPhase, kCarrierSeed, kCodePhase, kPllAcc, kDllAcc,
  kCarrierFreq, kCodeDev, kPwrAvg, kIpPrev, kQpPrev, kAgcOn
};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// torch.remainder (and jnp.remainder) for m > 0: fmod, then + m where the
// result is negative; fmodf is exact.
__device__ __forceinline__ float rem(float x, float m) {
  const float r = fmodf(x, m);
  return r < 0.0f ? add(r, m) : r;
}

struct Opts {
  int e_sub, n_chan, p, carrier_aiding, agc;
  float inv_fs, pll_k1, pll_k2, dll_k1, dll_k2, fll_k2pi, spacing,
      nom_step_mod, nom_epoch_mod, scale, agc_lo, agc_hi;
};

// The next step's track_corr parameters [e_sub, n_chan, 5] of channel c
// (track/channel.py step_params).
__device__ void write_params(float* par, int c, float carrier_phase,
                             float carrier_freq, float code_phase,
                             float code_dev, const Opts& o) {
  const float delta = mul(carrier_freq, o.inv_fs);
  const float rate = mul(code_dev, o.inv_fs);
  for (int e = 0; e < o.e_sub; ++e) {
    const float ef = static_cast<float>(e);
    const float es = mul(ef, static_cast<float>(o.p));
    const float chips0 =
        add(add(code_phase, mul(rate, es)), mul(o.nom_epoch_mod, ef));
    const float s0p = mul(rem(chips0, kCodeLen), o.scale);
    const float s0e = mul(rem(add(chips0, o.spacing), kCodeLen), o.scale);
    const float s0l = mul(rem(sub(chips0, o.spacing), kCodeLen), o.scale);
    float* q = par + (static_cast<size_t>(e) * o.n_chan + c) * 5;
    q[0] = rem(add(carrier_phase, mul(delta, es)), 1.0f);
    q[1] = delta;
    q[2] = s0p;
    q[3] = s0e < s0p ? 1.0f : 0.0f;
    q[4] = s0l > s0p ? 1.0f : 0.0f;
  }
}

__global__ void __launch_bounds__(256)
loop_update_kernel(const float* __restrict__ taps, float* __restrict__ state,
                   const float* __restrict__ aid_offset,
                   float* __restrict__ par, float* __restrict__ outs, int s,
                   int n_rows, Opts o) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= o.n_chan) return;
  float st[kStateRows];
#pragma unroll
  for (int k = 0; k < kStateRows; ++k) st[k] = state[k * o.n_chan + c];

  if (taps != nullptr) {
    const float two_pi = static_cast<float>(2.0 * 3.14159265358979323846);
    const float inv_two_pi = 1.0f / two_pi;
    const float inv_fll = 1.0f / static_cast<float>(
                                     2.0 * 3.14159265358979323846 * 1e-3);
    const float inv_e = 1.0f / static_cast<float>(o.e_sub);
    const bool act = st[kActive] > 0.5f;
    float pll_sum = 0.0f, fll_sum = 0.0f, n_valid = 0.0f, e_sum = 0.0f,
          l_sum = 0.0f, pwr_sum = 0.0f;
    float ipp = st[kIpPrev], qpp = st[kQpPrev];
    const size_t plane = static_cast<size_t>(n_rows) * o.n_chan;
    float* row0 = outs + static_cast<size_t>(s) * o.e_sub * o.n_chan + c;
    for (int e = 0; e < o.e_sub; ++e) {
      const float* t = taps + (static_cast<size_t>(e) * o.n_chan + c) * 6;
      const float ip = t[0], qp = t[1];
      const float em = hypotf(t[2], t[3]), lm = hypotf(t[4], t[5]);
      // Costas: atan(Q/I), data-bit insensitive
      pll_sum = add(pll_sum, atanf(qp / (fabsf(ip) < 1e-9f ? 1e-9f : ip)));
      // FLL: cross/dot of consecutive 1 ms prompts, the first pair
      // spanning the step boundary through the stored previous prompt
      const float cross = sub(mul(ipp, qp), mul(qpp, ip));
      const float dot = add(mul(ipp, ip), mul(qpp, qp));
      const float pair =
          mul(atanf(cross / (fabsf(dot) < 1e-9f ? 1e-9f : dot)), inv_fll);
      const float valid = add(mul(ipp, ipp), mul(qpp, qpp)) > 0.0f
                              ? 1.0f : 0.0f;
      fll_sum = add(fll_sum, mul(pair, valid));
      n_valid = add(n_valid, valid);
      e_sum = add(e_sum, em);
      l_sum = add(l_sum, lm);
      pwr_sum = add(pwr_sum, add(mul(ip, ip), mul(qp, qp)));
      ipp = ip;
      qpp = qp;
      float* r = row0 + static_cast<size_t>(e) * o.n_chan;
      r[0] = ip;
      r[plane] = qp;
      r[2 * plane] = em;
      r[3 * plane] = lm;
    }
    float pll_err = mul(pll_sum, inv_e);
    const float fll_err = fll_sum / fmaxf(n_valid, 1.0f);
    const float e_mag = mul(e_sum, inv_e), l_mag = mul(l_sum, inv_e);
    const float denom = fmaxf(add(e_mag, l_mag), 1e-9f);
    const float dll_err = mul(o.spacing, sub(e_mag, l_mag)) / denom;

    // loop filters: freq = seed + k1*e + acc; halved Costas gain while
    // agc_on (the decision is one step delayed)
    if (o.agc) pll_err = mul(pll_err, st[kAgcOn] > 0.5f ? 0.5f : 1.0f);
    const float pll_acc =
        add(st[kPllAcc],
            act ? add(mul(o.pll_k2, pll_err), mul(o.fll_k2pi, fll_err))
                : 0.0f);
    const float carrier_freq =
        act ? add(st[kCarrierSeed],
                  mul(add(mul(o.pll_k1, pll_err), pll_acc), inv_two_pi))
            : st[kCarrierFreq];
    const float dll_acc =
        add(st[kDllAcc], act ? mul(o.dll_k2, dll_err) : 0.0f);
    // carrier aiding with the MOTION Doppler: the common oscillator
    // offset comes off first
    const float aid =
        o.carrier_aiding
            ? mul(mul(sub(carrier_freq, aid_offset[0]),
                      1.0f / static_cast<float>(1575.42e6)),
                  static_cast<float>(1.023e6))
            : 0.0f;
    const float code_dev =
        act ? add(add(aid, mul(o.dll_k1, dll_err)), dll_acc) : st[kCodeDev];

    // NCO phase advance
    const float step_len = static_cast<float>(o.p * o.e_sub);
    const float rate = mul(code_dev, o.inv_fs);
    const float carrier_phase =
        act ? rem(add(st[kCarrierPhase],
                      mul(mul(carrier_freq, o.inv_fs), step_len)),
                  1.0f)
            : st[kCarrierPhase];
    const float code_phase =
        act ? rem(add(add(st[kCodePhase], mul(rate, step_len)),
                      o.nom_step_mod),
                  kCodeLen)
            : st[kCodePhase];
    const float pwr = mul(pwr_sum, inv_e);
    const float pwr_avg =
        act ? add(mul(0.875f, st[kPwrAvg]), mul(0.125f, pwr)) : st[kPwrAvg];
    float agc_on = st[kAgcOn];
    if (o.agc && act) {
      agc_on = pwr_avg > o.agc_hi ? 1.0f
               : pwr_avg < o.agc_lo ? 0.0f : agc_on;
    }

    // per-epoch outputs: the loop's rates and the code phase at each
    // epoch's start, from the step's starting phase and its new rate
    for (int e = 0; e < o.e_sub; ++e) {
      const float ef = static_cast<float>(e);
      float* r = row0 + static_cast<size_t>(e) * o.n_chan;
      r[4 * plane] = carrier_freq;
      r[5 * plane] = code_dev;
      r[6 * plane] =
          rem(add(add(st[kCodePhase],
                      mul(rate, mul(ef, static_cast<float>(o.p)))),
                  mul(o.nom_epoch_mod, ef)),
              kCodeLen);
    }
    st[kCarrierPhase] = carrier_phase;
    st[kCodePhase] = code_phase;
    st[kPllAcc] = pll_acc;
    st[kDllAcc] = dll_acc;
    st[kCarrierFreq] = carrier_freq;
    st[kCodeDev] = code_dev;
    st[kPwrAvg] = pwr_avg;
    if (act) {
      st[kIpPrev] = ipp;
      st[kQpPrev] = qpp;
    }
    st[kAgcOn] = agc_on;
#pragma unroll
    for (int k = 0; k < kStateRows; ++k) state[k * o.n_chan + c] = st[k];
  }
  if (par != nullptr) {
    write_params(par, c, st[kCarrierPhase], st[kCarrierFreq],
                 st[kCodePhase], st[kCodeDev], o);
  }
}

}  // namespace

// taps [e_sub, n_chan, 6] or null (write par only); state [12, n_chan] in
// place; aid_offset [1]; par [e_sub, n_chan, 5] or null; outs
// [7, n_rows, n_chan] (rows s*e_sub ... written).
extern "C" int loop_update_launch(
    const float* taps, float* state, const float* aid_offset, float* par,
    float* outs, int s, int n_rows, int e_sub, int n_chan, int p,
    int carrier_aiding, int agc, float fs, float pll_k1, float pll_k2,
    float dll_k1, float dll_k2, float fll_k2pi, float spacing,
    float nom_step_mod, float nom_epoch_mod, float scale, float agc_lo,
    float agc_hi, void* stream) {
  Opts o{e_sub, n_chan, p, carrier_aiding, agc, 1.0f / fs, pll_k1, pll_k2,
         dll_k1, dll_k2, fll_k2pi, spacing, nom_step_mod, nom_epoch_mod,
         scale, agc_lo, agc_hi};
  const int threads = n_chan < 256 ? ((n_chan + 31) / 32) * 32 : 256;
  loop_update_kernel<<<(n_chan + threads - 1) / threads, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      taps, state, aid_offset, par, outs, s, n_rows, o);
  return cudaGetLastError();
}
