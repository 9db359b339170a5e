// Packed 1-bit unpack + bipolar map + quadrature square-wave mix (sm_90a).
//
// Replaces the Pallas TPU kernel tpu_gnss/ops/onebit.py mix_packed_pallas
// (_mix_kernel_factory).  Sample i is bit (i % 32) of word i / 32, LSB
// first; s = 1 - 2*bit, and the 4-phase LO of the offline table gives
// out[i] = (s * I_sign[p], s * Q_sign[p]) with p = floor((i*lo_rate) mod 4
// + phase0) mod 4 quarter cycles.  The port takes plain LSB-first words,
// not the TPU kernel's 128-lane bit planes.
//
// Bit-exact with the plain version (ops/onebit.py mix_packed_plain ->
// acquire/search.py mix_baseband), which computes in float32
//   part1 = fmod(float(i / 4096) * c1, 4), part2 = fmod(float(i % 4096) * c2, 4),
//   ph = fmod(fmod(part1 + part2, 4) + phase0, 4), p = int(ph),
// with c1 = float32((4096 * lo_rate) mod 4) and c2 = float32(lo_rate).
//  * part2 depends only on i % 4096: it comes from a 4096-entry float32
//    table the host builds with the same roundings (ops/onebit.part2_table).
//  * part1 depends only on i / 4096, one value per warp (a warp's 1024
//    samples lie in one 4096-sample segment); __fmul_rn is never contracted
//    into an FMA and fmodf is exact.
//  * Both remaining fmods take a float32 sum of a value in [0, 4) and one in
//    [0, 4]: the sum lies in [0, 8] (it can round to exactly 8), and there
//    x - 4 is exact (Sterbenz), so two compare-and-subtracts equal fmod(x, 4)
//    for every such x, 8 -> 0 included.  The wrapper requires
//    0 <= phase0 < 4 (float64), which rounds to at most 4.0 in float32.
//
// What bounds it on this card: device-memory bandwidth, 8 bytes written
// per sample and 1/8 byte read.
//
// Design: each warp takes 1024 samples: one coalesced 128-byte load of its
// 32 words, the words spread with __shfl_sync, and sixteen 16-byte stores
// per lane (two samples each), so one store instruction of the warp writes
// 512 contiguous bytes.

#include "common.cuh"

namespace {

constexpr int kPhaseSplit = 4096;   // acquire/search.py PHASE_SPLIT
constexpr int kWarpSamples = 1024;  // 32 words

// fmod(x, 4) for x in [0, 8]
__device__ __forceinline__ float mod4(float x) {
  x = x >= 4.0f ? x - 4.0f : x;
  return x >= 4.0f ? x - 4.0f : x;
}

__global__ void __launch_bounds__(TG_THREADS)
mix_packed_kernel(const unsigned* __restrict__ words,
                  const float* __restrict__ part2, float4* __restrict__ out,
                  int n_bits, float c1, float phase0, int i_mask,
                  int q_mask) {
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * (TG_THREADS / 32) + (threadIdx.x >> 5);
  const int base = tile * kWarpSamples;
  if (base >= n_bits) return;
  const int n_words = (n_bits + 31) >> 5;
  const int wi = (base >> 5) + lane;
  const unsigned word = wi < n_words ? __ldg(words + wi) : 0u;
  const float part1 =
      fmodf(__fmul_rn(static_cast<float>(base / kPhaseSplit), c1), 4.0f);
  const float* p2 = part2 + (base % kPhaseSplit) + 2 * lane;
  const int sh = (2 * lane) & 31;
#pragma unroll
  for (int t = 0; t < kWarpSamples / 64; ++t) {
    const unsigned w = __shfl_sync(0xffffffffu, word, 2 * t + (lane >> 4));
    const int i0 = base + 64 * t + 2 * lane;
    const float2 q = __ldg(reinterpret_cast<const float2*>(p2 + 64 * t));
    float v[4];
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const float ph =
          mod4(__fadd_rn(mod4(__fadd_rn(part1, b ? q.y : q.x)), phase0));
      const int p = static_cast<int>(ph);    // truncation, as .to(int64)
      const unsigned bit = (w >> (sh + b)) & 1u;
      v[2 * b] = (bit ^ ((i_mask >> p) & 1)) ? -1.0f : 1.0f;
      v[2 * b + 1] = (bit ^ ((q_mask >> p) & 1)) ? -1.0f : 1.0f;
    }
    if (i0 + 1 < n_bits) {
      out[i0 >> 1] = make_float4(v[0], v[1], v[2], v[3]);
    } else if (i0 < n_bits) {
      reinterpret_cast<float2*>(out)[i0] = make_float2(v[0], v[1]);
    }
  }
}

}  // namespace

extern "C" int mix_packed_launch(const unsigned* words, const float* part2,
                                 float2* out, int n_bits, float c1,
                                 float phase0, int i_mask, int q_mask,
                                 void* stream) {
  const int tiles = (n_bits + kWarpSamples - 1) / kWarpSamples;
  const int per_block = TG_THREADS / 32;
  mix_packed_kernel<<<(tiles + per_block - 1) / per_block, TG_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      words, part2, reinterpret_cast<float4*>(out), n_bits, c1, phase0,
      i_mask, q_mask);
  return cudaGetLastError();
}
