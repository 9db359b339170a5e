// Four-step DFT stage pair on Hopper's tensor cores (sm_90a), shared by
// fold_corr_reduce.cu (its forward and inverse passes) and corr_reduce.cu.
//
// Replaces the MXU matmul chains of the Pallas TPU kernels
// tpu_gnss/ops/mxu_corr.py fold_corr_reduce (_fused_kernel_factory) and
// corr_reduce (_kernel_factory), which run each four-step stage as bf16
// matmuls with f32 accumulation (complex_mm, four real dots).  Here one
// routine computes, per item, for a 16-row tile of m and a run of n columns
// per warp,
//
//     Out[m, n] = sum_j (tw[m, j] * sum_k A1[m, k] B1[k, j]) * B2[j, n]
//
// The inverse stage is m = t, k = k1, j = k2, n = q (A1 = E1^T, B1 = the
// product of a code spectrum and a data spectrum, tw = the inverse
// twiddles, B2 = E2); the forward stage of fold_corr_reduce is m = k2,
// k = u, j = v, n = k1 (A1 = F2, B1 = the time block, tw = Wt, B2 = F1), as
// in ops/mxu_corr.four_step_np.
//
// Design:
//  * Every product is mma.sync.m16n8k8 with TF32 operands and f32
//    accumulators; a complex product is four real MMAs on separate re/im
//    planes, as the reference's complex_mm.  All loops around the MMAs have
//    compile-time trip counts (NQ out n-tiles per warp, NJ j-tiles per
//    chunk, two k-steps per turn): the tables are zero-padded to whole
//    tiles (k to 16, j to 32, n-tiles to 8), so no MMA sits under a branch
//    and every accumulator stays in registers.
//  * B1 is staged a [128 k, 32 j] chunk at a time, double-buffered, TF32,
//    in fragment order: one 16-byte shared load gives a lane its (re, im)
//    x (b0, b1) of one 8x8 tile.  Each thread copies the raw inputs of the
//    fragments it later forms (cp.async into its own slots), so the raw
//    buffer needs no block barrier; one __syncthreads per chunk orders the
//    tile and the B2 buffers.  B1 is never transposed: the copy reads each
//    input in its own layout (k2-major or k1-major).
//  * Stage 1 leaves C[m, j] in accumulator registers.  Its fragment layout
//    is the A-operand layout of stage 2 once the k order inside each 8-step
//    is permuted (A column tq <-> j = 2*tq, column tq+4 <-> j = 2*tq+1),
//    so after the float32 twiddle and TF32 rounding C feeds stage 2 from
//    registers; the B2 fragments are built in that order on the host.  The
//    [m, j] intermediate never exists in memory and Out stays in registers
//    across all j chunks.
//  * A1 and B2 are fragment-ordered tables built once on the host
//    (ops/mxu_corr.mma_tables): A1 is read with two 16-byte loads per
//    k-step through L1, B2 staged per j chunk with cp.async; a chunk's
//    twiddles are loaded before its stage 1, which hides their latency.
//  * A block holds `gi` items (several SVs of one row when one item's
//    tasks fill fewer than 8 warps), so the B2 chunk is shared by them.
//
// What bounds it: latency and issue, not the tensor cores.  One block of 8
// warps fills an SM (up to ~240 registers a thread, ~160-220 KB of shared
// memory), and its phases run in step between the chunk barriers.  Clock
// counters per warp and chunk at NF 16384 on the H100: stage 1 ~43% (at
// about half the mma.sync rate), forming the TF32 tile ~16%, issuing the
// raw copies ~14% and the B2 copy ~10% (both paced by L2), stage 2 ~8%.
// mma.sync TF32 alone reaches ~320 TFLOP/s there (microbenchmark); this
// loop ~70-80 TFLOP/s.
//
// Precision: TF32 operands (10-bit mantissa, cvt.rna), f32 accumulation;
// twiddles are applied in float32 before rounding.  The relative error of a
// correlation power is ~1e-3, under the reference's bf16 bound (rtol 0.03
// against a float64 oracle, tests/test_mxu.py:75-79), and a numpy
// emulation of this arithmetic keeps the float64 peak, lag and row
// decisions (tests/test_torch_mxu_corr.py).
#pragma once

#include <climits>
#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace fsm {

constexpr int NJ = 4;                // j-tiles (8 j each) per staged chunk
constexpr int KT = 8 * NJ;           // j per chunk
constexpr int KSC = 16;              // k-steps (8 k each) per chunk
constexpr int KC = 8 * KSC;          // k per chunk
constexpr int MAX_WARPS = TG_THREADS / 32;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// One stage pair.  Tables (all zero beyond the valid extents):
//   a1: [mt][ks][32 lanes][2] float4, re then im of the A fragment a0..a3;
//   tw: [16*mt][8*js] float2;
//   b2: [js][ntp][32 lanes] float4 (re b0, re b1, im b0, im b1).
// ks = 2*ceil(k/16), js = 4*ceil(j/32), ntp = 8*ceil(n/64): the padding of
// ops/mxu_corr.mma_tables.  The n-tiles are split into `runs` runs of nq
// (even, at most 8); a warp's task is one m-tile and one run.
struct Geo {
  int m, k, j, n;
  int mt, ks, js, ntp, runs, nq;
  const float4* a1;
  const float2* tw;
  const float4* b2;
};

inline Geo make_geo(int m, int k, int j, int n, const float* a1,
                    const float2* tw, const float* b2) {
  const int nt = cdiv(n, 8), runs = cdiv(nt, 8);
  const int nq = 2 * cdiv(cdiv(nt, runs), 2);
  return Geo{m, k, j, n, cdiv(m, 16), 2 * cdiv(k, 16), 4 * cdiv(j, 32),
             8 * cdiv(nt, 8), runs, nq,
             reinterpret_cast<const float4*>(a1), tw,
             reinterpret_cast<const float4*>(b2)};
}

// How a block is laid out: gi items, each with wpi warps per round, in
// `rounds` rounds of its tasks; shared memory in float4 units.  NR is the
// number of raw float planes one B1 element is formed from.
struct Plan {
  int tasks, rounds, wpi, gi, warps, kspc;
  int tile4, b24, raw4;      // float4 per item tile, per B2 buffer, per item raw
  size_t bytes;              // dynamic shared memory without the |Out|^2 sums
};

__host__ __device__ inline Plan make_plan(const Geo& g, int nr, int items,
                                          int max_warps) {
  Plan p;
  p.tasks = g.mt * g.runs;
  p.rounds = cdiv(p.tasks, max_warps);
  p.wpi = cdiv(p.tasks, p.rounds);
  p.gi = 1;
  if (p.rounds == 1) {
    p.gi = max_warps / p.wpi;
    if (p.gi > items) p.gi = items;
    if (p.gi < 1) p.gi = 1;
  }
  p.warps = p.gi * p.wpi;
  p.kspc = g.ks < KSC ? g.ks : KSC;
  p.tile4 = p.kspc * NJ * 32;
  p.b24 = NJ * g.ntp * 32;
  p.raw4 = p.kspc * NJ * 2 * nr * 32 / 4;
  p.bytes = 16 * (size_t(2) * p.gi * p.tile4 + 2 * size_t(p.b24) +
                  size_t(p.gi) * p.raw4);
  return p;
}

// floats of one warp's |Out|^2 sums (n_acc > 1)
template <int NQ>
__host__ __device__ constexpr int pow_floats() { return NQ * 4 * 32; }

// Place (m, n) of Out value `slot` (= 4*q + e < 4*NQ) of a lane of the
// warp running task `task`: rows lane/4 and lane/4 + 8 of its m-tile,
// columns 2*(lane%4) and 2*(lane%4) + 1 of its q-th n-tile.
template <int NQ>
__device__ __forceinline__ void out_place(const Geo& g, int task, int slot,
                                          int lane, int& m, int& n) {
  const int e = slot & 3, q = slot >> 2;
  m = (task / g.runs) * 16 + (lane >> 2) + 8 * (e >> 1);
  n = ((task % g.runs) * NQ + q) * 8 + 2 * (lane & 3) + (e & 1);
}

__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// d += a * b on one m16n8k8 tile (TF32 operands, f32 accumulators)
__device__ __forceinline__ void mma(float (&d)[4], const float (&a)[4],
                                    float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
        "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
        "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// Asynchronous copies to shared memory (cp.async): 4 bytes, zero-filled
// when !valid (src is then not read), and 16 bytes; then group commit and
// wait until at most N groups of this thread are pending.  The "memory"
// clobbers keep the compiler from moving shared loads across them.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float4* dst, const float4* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The stage pair for n_acc inputs in turn, over all items of the block (all
// threads of the block take part).  This warp runs task `task` of item
// `item` when `active`.
//
// load(item, acc, k, j, valid, dst) issues cp_async4 of element (k, j) of
// B1 of input acc of item, one raw plane p to dst[32 * p];
// combine(item, k, j, src) forms the complex B1 value of element (k, j)
// (padding included: k < 8*ks, j < 8*js) from the landed planes
// src[32 * p].
// epi(acc, slot, m, n, re, im) receives each of the warp's Out values
// after the last chunk of input acc: slot = 4*q + e < 4*NQ numbers the
// value within the warp's lane, (m, n) is its place (out_place; rows
// m < 16*mt, columns n < 8*ntp, padding included: the caller masks).
// `smem` holds plan.bytes.
template <int NQ, int NR, class Load, class Combine, class Epi>
__device__ __forceinline__ void four_step(const Geo& g, const Plan& p,
                                          int item, int task, bool active,
                                          int n_acc, float4* smem, Load load,
                                          Combine combine, Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int nw = blockDim.x >> 5;
  float4* tiles = smem;                                 // [2][gi][tile4]
  float4* b2s = tiles + 2 * p.gi * p.tile4;             // [2][b24]
  float* raw = reinterpret_cast<float*>(b2s + 2 * p.b24);   // [gi][units][2][NR][32]
  const int nkc = cdiv(g.ks, KSC), njc = g.js / NJ;
  const int total = n_acc * njc * nkc;
  const int units = p.kspc * NJ;                        // fragment tiles per chunk
  const int mt = task / g.runs, nq0 = (task % g.runs) * NQ;

  // raw inputs of chunk i: this thread's elements, into its own slots
  auto copy_raw = [&](int i) {
    const int kc = i % nkc, jc = (i / nkc) % njc, acc = i / (nkc * njc);
    const int ksn = min(KSC, g.ks - kc * KSC);
    for (int u = warp; u < p.gi * units; u += nw) {
      const int it = u / units, lu = u - it * units;
      const int s = lu / NJ;
      if (s >= ksn) continue;
      const int k = kc * KC + s * 8 + tq, jj = jc * KT + (lu % NJ) * 8 + gq;
      float* dst = raw + size_t(u) * 2 * NR * 32 + lane;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        load(it, acc, k + 4 * h, jj, k + 4 * h < g.k && jj < g.j,
             dst + h * NR * 32);
    }
  };
  // TF32 fragments of chunk i from the landed raw inputs
  auto product = [&](int i) {
    const int kc = i % nkc, jc = (i / nkc) % njc;
    const int ksn = min(KSC, g.ks - kc * KSC);
    float4* tile = tiles + (i & 1) * p.gi * p.tile4;
    for (int u = warp; u < p.gi * units; u += nw) {
      const int it = u / units, lu = u - it * units;
      const int s = lu / NJ;
      if (s >= ksn) continue;
      const int k = kc * KC + s * 8 + tq, jj = jc * KT + (lu % NJ) * 8 + gq;
      const float* src = raw + size_t(u) * 2 * NR * 32 + lane;
      const float2 v0 = combine(it, k, jj, src),
                   v1 = combine(it, k + 4, jj, src + NR * 32);
      tile[it * p.tile4 + lu * 32 + lane] =
          make_float4(tf32(v0.x), tf32(v1.x), tf32(v0.y), tf32(v1.y));
    }
  };
  auto copy_b2 = [&](int jcount) {                      // j chunk jcount
    const float4* src = g.b2 + size_t(jcount % njc) * p.b24;
    float4* dst = b2s + (jcount & 1) * p.b24;
    for (int e = threadIdx.x; e < p.b24; e += blockDim.x)
      cp_async16(dst + e, src + e);
  };

  float outr[NQ][4], outi[NQ][4], cr[NJ][4], ci[NJ][4];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) outr[q][e] = outi[q][e] = 0.f;

  copy_raw(0);
  cp_commit();
  copy_b2(0);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  product(0);
  if (1 < total) copy_raw(1);
  cp_commit();
  __syncthreads();

  const float4* a1 = g.a1 + size_t(mt) * g.ks * 64 + lane * 2;
  const int m0 = mt * 16 + gq, jw = 8 * g.js;
  for (int i = 0; i < total; ++i) {
    const int kc = i % nkc, jc = (i / nkc) % njc, acc = i / (nkc * njc);
    const int jcount = i / nkc;
    const bool last_k = kc == nkc - 1;
    // the next j chunk's B2, into the buffer its predecessor's stage 2 freed
    if (kc == 0 && jcount + 1 < total / nkc) copy_b2(jcount + 1);
    cp_commit();
    if (active) {
      if (kc == 0) {
#pragma unroll
        for (int t = 0; t < NJ; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) cr[t][e] = ci[t][e] = 0.f;
      }
      // stage 1: C[m, j] += A1[m, k] B1[k, j] over this chunk's k-steps
      const float4* bt = tiles + ((i & 1) * p.gi + item) * p.tile4 + lane;
      const float4* ap = a1 + size_t(kc) * KSC * 64;
      const int ksn = min(KSC, g.ks - kc * KSC);
      // this chunk's twiddles (rows m0, m0 + 8; columns jb, jb + 1 of each
      // j-tile), loaded before stage 1 so that it hides their latency
      float4 tw[NJ][2];
#pragma unroll
      for (int t = 0; t < NJ; ++t) {
        const float2* w = g.tw + size_t(m0) * jw + jc * KT + t * 8 + 2 * tq;
        tw[t][0] = __ldg(reinterpret_cast<const float4*>(w));
        tw[t][1] = __ldg(reinterpret_cast<const float4*>(w + 8 * jw));
      }
      for (int s0 = 0; s0 < ksn; s0 += 2) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int s = s0 + h;
          const float4 xr = __ldg(ap + s * 64), xi = __ldg(ap + s * 64 + 1);
          const float ar[4] = {xr.x, xr.y, xr.z, xr.w};
          const float ai[4] = {xi.x, xi.y, xi.z, xi.w};
          const float an[4] = {-xi.x, -xi.y, -xi.z, -xi.w};
          float4 b[NJ];
#pragma unroll
          for (int t = 0; t < NJ; ++t) b[t] = bt[(s * NJ + t) * 32];
          // four waves, so dependent MMAs on one accumulator are NJ apart
#pragma unroll
          for (int t = 0; t < NJ; ++t) mma(cr[t], ar, b[t].x, b[t].y);
#pragma unroll
          for (int t = 0; t < NJ; ++t) mma(ci[t], ar, b[t].z, b[t].w);
#pragma unroll
          for (int t = 0; t < NJ; ++t) mma(cr[t], an, b[t].z, b[t].w);
#pragma unroll
          for (int t = 0; t < NJ; ++t) mma(ci[t], ai, b[t].x, b[t].y);
        }
      }
      if (last_k) {
        // twiddle in float32 and round: C becomes stage 2's A fragments
        // (elements c0, c2, c1, c3 = A rows g, g+8 at k = 2*tq, 2*tq+1)
#pragma unroll
        for (int t = 0; t < NJ; ++t) {
          const float4 w0 = tw[t][0], w1 = tw[t][1];
          const float wr[4] = {w0.x, w0.z, w1.x, w1.z};
          const float wi[4] = {w0.y, w0.w, w1.y, w1.w};
          float r[4], im[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            r[e] = cr[t][e] * wr[e] - ci[t][e] * wi[e];
            im[e] = cr[t][e] * wi[e] + ci[t][e] * wr[e];
          }
          cr[t][0] = tf32(r[0]);
          cr[t][1] = tf32(r[2]);
          cr[t][2] = tf32(r[1]);
          cr[t][3] = tf32(r[3]);
          ci[t][0] = tf32(im[0]);
          ci[t][1] = tf32(im[2]);
          ci[t][2] = tf32(im[1]);
          ci[t][3] = tf32(im[3]);
        }
        // stage 2: Out[m, n] += C[m, j] B2[j, n] over this chunk's j
        const float4* bp = b2s + (jcount & 1) * p.b24 + nq0 * 32 + lane;
#pragma unroll
        for (int s = 0; s < NJ; ++s) {
          const float an[4] = {-ci[s][0], -ci[s][1], -ci[s][2], -ci[s][3]};
          float4 b[NQ];
#pragma unroll
          for (int q = 0; q < NQ; ++q) b[q] = bp[(s * g.ntp + q) * 32];
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            mma(outr[q], cr[s], b[q].x, b[q].y);
            mma(outi[q], cr[s], b[q].z, b[q].w);
          }
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            mma(outr[q], an, b[q].z, b[q].w);
            mma(outi[q], ci[s], b[q].x, b[q].y);
          }
        }
        if (jc == njc - 1) {
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              int m, n;
              out_place<NQ>(g, task, q * 4 + e, lane, m, n);
              epi(acc, q * 4 + e, m, n, outr[q][e], outi[q][e]);
              outr[q][e] = outi[q][e] = 0.f;
            }
          }
        }
      }
    }
    cp_wait<1>();                 // this thread's raw inputs of chunk i+1
    if (i + 1 < total) product(i + 1);
    if (i + 2 < total) copy_raw(i + 2);
    cp_commit();
    cp_wait<1>();                 // this iteration's B2 copy
    __syncthreads();              // tile i+1 and B2 complete; tile i free
  }
}

// Dynamic shared memory of a reduce launch: four_step's, and for n_acc > 1
// each warp's |Out|^2 sums.
template <int NQ>
__host__ __device__ inline size_t reduce_bytes(const Plan& p, int n_acc) {
  return p.bytes +
         (n_acc > 1 ? sizeof(float) * p.warps * pow_floats<NQ>() : 0);
}

// The inverse stage pair of the block's items (`items` <= p.gi valid) over
// their n_acc inputs, |Out|^2 summed over them, then per item the peak,
// the first lag at the peak and the total over the valid lags (t < n1,
// q < q_cols, lag = n1*q + t < period), written to index out0 + item.
template <int NQ, int NR, class Load, class Combine>
__device__ __forceinline__ void reduce_block(const Geo& g, const Plan& p,
                                             int items, int n_acc, int n1,
                                             int q_cols, int period,
                                             Load load, Combine combine,
                                             float* peak, int* lag_out,
                                             float* tot_out, size_t out0) {
  extern __shared__ float4 fsm_smem[];
  __shared__ float s_pk[MAX_WARPS], s_tot[MAX_WARPS];
  __shared__ int s_lag[MAX_WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int item = warp / p.wpi, w_in = warp % p.wpi;
  float* pw = reinterpret_cast<float*>(fsm_smem + p.bytes / 16) +
              warp * pow_floats<NQ>() + lane;
  float pk = -1.0f, tot = 0.0f;
  int lag = INT_MAX;
  for (int r = 0; r < p.rounds; ++r) {
    const int task = r * p.wpi + w_in;
    const bool active = item < items && task < p.tasks;
    four_step<NQ, NR>(
        g, p, item, active ? task : 0, active, n_acc, fsm_smem, load,
        combine, [&](int acc, int slot, int m, int n, float re, float im) {
          float v = re * re + im * im;
          if (n_acc > 1) {
            float* sl = pw + slot * 32;
            if (acc > 0) v += *sl;
            if (acc < n_acc - 1) {
              *sl = v;
              return;
            }
          }
          const int l = n1 * n + m;
          if (m < n1 && n < q_cols && l < period) {
            tot += v;
            peak_merge(pk, lag, v, l);
          }
        });
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_down_sync(0xffffffffu, pk, o);
    const int l2 = __shfl_down_sync(0xffffffffu, lag, o);
    peak_merge(pk, lag, v2, l2);
    tot += __shfl_down_sync(0xffffffffu, tot, o);
  }
  if (lane == 0) {
    s_pk[warp] = pk;
    s_lag[warp] = lag;
    s_tot[warp] = tot;
  }
  __syncthreads();
  if (int(threadIdx.x) < items) {
    const int w0 = threadIdx.x * p.wpi;
    pk = s_pk[w0];
    lag = s_lag[w0];
    tot = s_tot[w0];
    for (int w = w0 + 1; w < w0 + p.wpi; ++w) {
      peak_merge(pk, lag, s_pk[w], s_lag[w]);
      tot += s_tot[w];
    }
    peak[out0 + threadIdx.x] = pk;
    lag_out[out0 + threadIdx.x] = lag;
    tot_out[out0 + threadIdx.x] = tot;
  }
}

// Run the statements for the geometry's nq (2, 4, 6 or 8) as NQ.
#define FSM_DISPATCH_NQ(nq, ...)                         \
  switch (nq) {                                          \
    case 2: { constexpr int NQ = 2; __VA_ARGS__ } break; \
    case 4: { constexpr int NQ = 4; __VA_ARGS__ } break; \
    case 6: { constexpr int NQ = 6; __VA_ARGS__ } break; \
    default: { constexpr int NQ = 8; __VA_ARGS__ } break; \
  }

}  // namespace fsm
