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
// What bounds it on this card: latency.  A step moves ~2-4 KB (taps 24
// bytes and parameters 20 bytes per epoch and channel, 12 state words and
// 7 output words per epoch and channel), so its bytes bound is a few
// nanoseconds, and its arithmetic is ~100 float operations per channel
// and epoch.  What costs is the chain of dependent steps: a load from
// device memory, the per-epoch terms (2 hypotf, 2 atanf, 2 divisions),
// the sums, the filter, and the stores.
//
// Design: a block covers C channels x e_sub epochs, one thread per
// (channel, epoch), the channel index fastest (tid = e*C + c), so that the
// stores of the output rows and the parameters coalesce; the geometry is
// track/channel.py loop_geometry.  Four phases, three barriers:
//   1. every load, issued at once: the block's taps into shared memory,
//      the state and aid_offset by the channel's epoch-0 thread;
//   2. thread (c, e) computes epoch e's terms and output rows 0-3, and
//      parks the terms in its own taps slot (behind a barrier, since
//      thread (c, e+1) reads epoch e's prompt for its FLL pair);
//   3. the epoch-0 thread of each channel sums its terms in epoch order,
//      runs the filter, AGC and NCO advance, writes the state and
//      publishes the loop's new values in shared memory;
//   4. thread (c, e) writes epoch e's output rows 4-6 and parameters.
// Every operation keeps its operands and order from one thread walking
// the epochs: products and sums go through __fmul_rn / __fadd_rn so that
// nvcc cannot contract them into FMAs the plain version does not do, the
// sums run in epoch order, a division by a host scalar is a product with
// its float32 reciprocal, and a mean is the sum times float32(1 / e_sub),
// as PyTorch's CUDA kernels compute them.  Every value that changes
// during a run is in device memory (the state and aid_offset): a graph
// that captured this launch reads them at each replay.  The flags active
// and agc_on are 0.0 / 1.0 rows of the float state.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kStateRows = 12;  // ChannelState._fields
constexpr int kTaps = 6;        // taps (and parked terms) per epoch
constexpr int kPub = 7;         // shared values per channel (Pub)
constexpr int kMaxThreads = 1024;
constexpr float kCodeLen = 1023.0f;

enum Row {
  kActive, kCarrierPhase, kCarrierSeed, kCodePhase, kPllAcc, kDllAcc,
  kCarrierFreq, kCodeDev, kPwrAvg, kIpPrev, kQpPrev, kAgcOn
};

// the parked per-epoch terms, in a taps slot
enum Term { kPll, kFll, kValid, kEMag, kLMag, kPwr };

// per channel in shared memory: the last epoch's prompt, then what the
// filter publishes for the epilogue
enum Pub {
  kIpLast, kQpLast, kFreq, kDev, kCodeOld, kCodeNew, kCarrierNew
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

// Epoch e's track_corr parameters of channel c for the next step
// (track/channel.py step_params), into par [e_sub, n_chan, 5].
__device__ void write_params(float* par, int c, int e, float carrier_phase,
                             float carrier_freq, float code_phase,
                             float code_dev, const Opts& o) {
  const float delta = mul(carrier_freq, o.inv_fs);
  const float rate = mul(code_dev, o.inv_fs);
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

// Phase 1's copy of taps [e_sub, n_chan, 6], channels c0 .. c0+cb-1, into
// s_taps [e_sub][C][6]: one 16-byte load per thread and pass where the
// block holds every channel (the slice is then the whole array) and the
// array is aligned, one float per thread and pass otherwise.
__device__ __forceinline__ void stage_taps(float* s_taps,
                                           const float* __restrict__ taps,
                                           int c0, int cb, int C,
                                           const Opts& o) {
  const int total = o.e_sub * cb * kTaps;
  if (C == o.n_chan && total % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(taps) & 15) == 0) {
    const float4* src = reinterpret_cast<const float4*>(taps);
    float4* dst = reinterpret_cast<float4*>(s_taps);
    for (int i = threadIdx.x; i < total / 4; i += blockDim.x) {
      dst[i] = src[i];
    }
    return;
  }
  const int row = cb * kTaps;
  const float* src = taps + static_cast<size_t>(c0) * kTaps;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int e = i / row, j = i - e * row;
    s_taps[e * C * kTaps + j] =
        src[static_cast<size_t>(e) * o.n_chan * kTaps + j];
  }
}

__global__ void __launch_bounds__(kMaxThreads)
loop_update_kernel(const float* __restrict__ taps, float* __restrict__ state,
                   const float* __restrict__ aid_offset,
                   float* __restrict__ par, float* __restrict__ outs, int s,
                   int n_rows, int C, Opts o) {
  extern __shared__ __align__(16) float smem[];
  float* s_taps = smem;                          // [e_sub][C][6]
  float* s_pub = smem + o.e_sub * C * kTaps;     // [7][C]
  const int cl = threadIdx.x % C, e = threadIdx.x / C;
  const int c0 = blockIdx.x * C;
  const int cb = min(C, o.n_chan - c0);
  const int c = c0 + cl;
  const bool live = cl < cb;

  if (taps == nullptr) {
    // the step's parameters from the state as it is (step 0 of a chunk)
    if (par != nullptr && live) {
      write_params(par, c, e, state[kCarrierPhase * o.n_chan + c],
                   state[kCarrierFreq * o.n_chan + c],
                   state[kCodePhase * o.n_chan + c],
                   state[kCodeDev * o.n_chan + c], o);
    }
    return;
  }

  // --- 1. every load at once ---------------------------------------------
  stage_taps(s_taps, taps, c0, cb, C, o);
  const bool lead = live && e == 0;   // the channel's filter thread
  float st[kStateRows];
  float aid_v = 0.0f;
  if (lead) {
#pragma unroll
    for (int k = 0; k < kStateRows; ++k) st[k] = state[k * o.n_chan + c];
    if (o.carrier_aiding) aid_v = aid_offset[0];
  }
  __syncthreads();

  // --- 2. the terms of epoch e -------------------------------------------
  const size_t plane = static_cast<size_t>(n_rows) * o.n_chan;
  float* row = outs +
               (static_cast<size_t>(s) * o.e_sub + e) * o.n_chan + c;
  float term[kTaps];
  float ip = 0.0f, qp = 0.0f;
  if (live) {
    const float inv_fll = 1.0f / static_cast<float>(
                                     2.0 * 3.14159265358979323846 * 1e-3);
    const float* t = s_taps + (e * C + cl) * kTaps;
    ip = t[0];
    qp = t[1];
    const float em = hypotf(t[2], t[3]), lm = hypotf(t[4], t[5]);
    // FLL: cross/dot of consecutive 1 ms prompts, the first pair
    // spanning the step boundary through the stored previous prompt
    float ipp, qpp;
    if (e > 0) {
      ipp = t[-C * kTaps];
      qpp = t[1 - C * kTaps];
    } else {
      ipp = st[kIpPrev];
      qpp = st[kQpPrev];
    }
    // Costas: atan(Q/I), data-bit insensitive
    term[kPll] = atanf(qp / (fabsf(ip) < 1e-9f ? 1e-9f : ip));
    const float cross = sub(mul(ipp, qp), mul(qpp, ip));
    const float dot = add(mul(ipp, ip), mul(qpp, qp));
    const float pair =
        mul(atanf(cross / (fabsf(dot) < 1e-9f ? 1e-9f : dot)), inv_fll);
    term[kValid] = add(mul(ipp, ipp), mul(qpp, qpp)) > 0.0f ? 1.0f : 0.0f;
    term[kFll] = mul(pair, term[kValid]);
    term[kEMag] = em;
    term[kLMag] = lm;
    term[kPwr] = add(mul(ip, ip), mul(qp, qp));
    row[0] = ip;
    row[plane] = qp;
    row[2 * plane] = em;
    row[3 * plane] = lm;
  }
  __syncthreads();  // every epoch's prompt has been read
  if (live) {
    float* t = s_taps + (e * C + cl) * kTaps;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) t[k] = term[k];
    if (e == o.e_sub - 1) {
      s_pub[kIpLast * C + cl] = ip;
      s_pub[kQpLast * C + cl] = qp;
    }
  }
  __syncthreads();

  // --- 3. the filter, one thread per channel -----------------------------
  if (lead) {
    const float two_pi = static_cast<float>(2.0 * 3.14159265358979323846);
    const float inv_two_pi = 1.0f / two_pi;
    const float inv_e = 1.0f / static_cast<float>(o.e_sub);
    const bool act = st[kActive] > 0.5f;
    float pll_sum = 0.0f, fll_sum = 0.0f, n_valid = 0.0f, e_sum = 0.0f,
          l_sum = 0.0f, pwr_sum = 0.0f;
    for (int k = 0; k < o.e_sub; ++k) {
      const float* t = s_taps + (k * C + cl) * kTaps;
      pll_sum = add(pll_sum, t[kPll]);
      fll_sum = add(fll_sum, t[kFll]);
      n_valid = add(n_valid, t[kValid]);
      e_sum = add(e_sum, t[kEMag]);
      l_sum = add(l_sum, t[kLMag]);
      pwr_sum = add(pwr_sum, t[kPwr]);
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
            ? mul(mul(sub(carrier_freq, aid_v),
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

    s_pub[kFreq * C + cl] = carrier_freq;
    s_pub[kDev * C + cl] = code_dev;
    s_pub[kCodeOld * C + cl] = st[kCodePhase];
    s_pub[kCodeNew * C + cl] = code_phase;
    s_pub[kCarrierNew * C + cl] = carrier_phase;
    st[kCarrierPhase] = carrier_phase;
    st[kCodePhase] = code_phase;
    st[kPllAcc] = pll_acc;
    st[kDllAcc] = dll_acc;
    st[kCarrierFreq] = carrier_freq;
    st[kCodeDev] = code_dev;
    st[kPwrAvg] = pwr_avg;
    if (act) {
      st[kIpPrev] = s_pub[kIpLast * C + cl];
      st[kQpPrev] = s_pub[kQpLast * C + cl];
    }
    st[kAgcOn] = agc_on;
#pragma unroll
    for (int k = 0; k < kStateRows; ++k) state[k * o.n_chan + c] = st[k];
  }
  __syncthreads();

  // --- 4. epoch e's outputs from the new rates, and its parameters -------
  if (live) {
    const float carrier_freq = s_pub[kFreq * C + cl];
    const float code_dev = s_pub[kDev * C + cl];
    const float ef = static_cast<float>(e);
    const float rate = mul(code_dev, o.inv_fs);
    // the code phase at the epoch's start, from the step's starting
    // phase and its new rate
    row[4 * plane] = carrier_freq;
    row[5 * plane] = code_dev;
    row[6 * plane] =
        rem(add(add(s_pub[kCodeOld * C + cl],
                    mul(rate, mul(ef, static_cast<float>(o.p)))),
                mul(o.nom_epoch_mod, ef)),
            kCodeLen);
    if (par != nullptr) {
      write_params(par, c, e, s_pub[kCarrierNew * C + cl], carrier_freq,
                   s_pub[kCodeNew * C + cl], code_dev, o);
    }
  }
}

}  // namespace

// taps [e_sub, n_chan, 6] or null (write par only); state [12, n_chan] in
// place; aid_offset [1]; par [e_sub, n_chan, 5] or null; outs
// [7, n_rows, n_chan] (rows s*e_sub ... written).  The geometry is
// track/channel.py loop_geometry's: blocks of chans_per_block channels x
// e_sub epochs, smem_bytes of dynamic shared memory (within the default
// 48 KB, so nothing is set on the function inside a graph capture).
extern "C" int loop_update_launch(
    const float* taps, float* state, const float* aid_offset, float* par,
    float* outs, int s, int n_rows, int e_sub, int n_chan, int p,
    int carrier_aiding, int agc, float fs, float pll_k1, float pll_k2,
    float dll_k1, float dll_k2, float fll_k2pi, float spacing,
    float nom_step_mod, float nom_epoch_mod, float scale, float agc_lo,
    float agc_hi, int chans_per_block, int blocks, int threads,
    int smem_bytes, void* stream) {
  if (chans_per_block < 1 || threads != chans_per_block * e_sub ||
      threads > kMaxThreads || blocks * chans_per_block < n_chan ||
      smem_bytes < static_cast<int>(sizeof(float)) * chans_per_block *
                       (kTaps * e_sub + kPub) ||
      smem_bytes > 48 * 1024) {
    return cudaErrorInvalidValue;
  }
  Opts o{e_sub, n_chan, p, carrier_aiding, agc, 1.0f / fs, pll_k1, pll_k2,
         dll_k1, dll_k2, fll_k2pi, spacing, nom_step_mod, nom_epoch_mod,
         scale, agc_lo, agc_hi};
  loop_update_kernel<<<blocks, threads, smem_bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      taps, state, aid_offset, par, outs, s, n_rows, chans_per_block, o);
  return cudaGetLastError();
}
