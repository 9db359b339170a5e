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
// acquire/search.py mix_baseband): the phase is the same float32 sequence,
//   part1 = fmod(float(i / 4096) * c1, 4), part2 = fmod(float(i % 4096) * c2, 4),
//   ph = fmod(fmod(part1 + part2, 4) + phase0, 4), p = int(ph),
// with c1 = float32((4096 * lo_rate) mod 4) and c2 = float32(lo_rate) from
// the host.  __fmul_rn / __fadd_rn are never contracted into an FMA, and
// fmodf is exact, so each step rounds exactly as the plain version's
// separate PyTorch ops do.
//
// What bounds it on this card: device-memory bandwidth.  4 bytes are read
// per 32 samples and 8 bytes written per sample; the phase arithmetic is
// a few dozen instructions per sample.
//
// Design: one thread per sample in a grid-stride loop, so consecutive
// threads write consecutive float2 samples (coalesced 8-byte stores) and a
// warp's 32 threads read one word (a single broadcast load).

#include "common.cuh"

namespace {

constexpr int kPhaseSplit = 4096;   // acquire/search.py PHASE_SPLIT

__global__ void __launch_bounds__(TG_THREADS)
mix_packed_kernel(const unsigned* __restrict__ words, float2* __restrict__ out,
                  int n_bits, float c1, float c2, float phase0, int i_mask,
                  int q_mask) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_bits;
       i += stride) {
    const unsigned bit = (__ldg(words + (i >> 5)) >> (i & 31)) & 1u;
    const float part1 =
        fmodf(__fmul_rn(static_cast<float>(i / kPhaseSplit), c1), 4.0f);
    const float part2 =
        fmodf(__fmul_rn(static_cast<float>(i % kPhaseSplit), c2), 4.0f);
    const float ph =
        fmodf(__fadd_rn(fmodf(__fadd_rn(part1, part2), 4.0f), phase0), 4.0f);
    const int p = static_cast<int>(ph);      // truncation, as .to(int64)
    const float s = bit ? -1.0f : 1.0f;
    out[i] = make_float2(((i_mask >> p) & 1) ? -s : s,
                         ((q_mask >> p) & 1) ? -s : s);
  }
}

}  // namespace

extern "C" int mix_packed_launch(const unsigned* words, float2* out,
                                 int n_bits, float c1, float c2,
                                 float phase0, int i_mask, int q_mask,
                                 void* stream) {
  const int blocks = min((n_bits + TG_THREADS - 1) / TG_THREADS, 132 * 16);
  mix_packed_kernel<<<blocks, TG_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      words, out, n_bits, c1, c2, phase0, i_mask, q_mask);
  return cudaGetLastError();
}
