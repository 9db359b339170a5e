"""Timing-only variants of the tracking correlator on one CUDA card.

    python3 tools/track_corr_variants.py [--variants A,B,...] [--shared]

Copies ``tpu_gnss_torch/csrc`` into ``build/track_corr_variants/``, patches
the copy with ``#ifdef`` blocks, builds one kernel library per variant
(all nvcc processes started together) and times ``track_corr`` through
its wrapper with each library in turn, two rounds, at the e2e (NF 2048),
nottingham (NF 16384), odd-n1 (NF 12500), LIVE (NF 10000) and SYNTHETIC
(NF 16384, u_rows 64) steps of ``chip_smoke.track_case``.  Each line
gives the device time per call (``chip_smoke.time_ms``) and the largest
error against the plain version over max|P|.  ``--shared`` also times
``fold_corr_reduce`` (e2e, nottingham) and ``corr_reduce`` (nottingham),
which share ``four_step_mma.cuh``.

Variants that remove a phase (their outputs are wrong; they show what
the phase costs):

* ``NO_STAGE1``: no stage-1 MMAs (nor the A and B1 fragment loads they feed);
* ``NO_A_LOADS``: stage-1 A fragments from registers, not from the table;
* ``NO_TABLES``: no LO phasor or ramp factor tables;
* ``NO_EPILOGUE``: no code product, ramp, taps or sums;
* ``NO_RAW``: the epoch copies zero-fill instead of reading memory;
* ``NO_B2``: no stage-2 B fragment copies.

Variants that were tried as optimisations (outputs stay right):

* ``PREFETCH_L2``: the item's epoch prefetched into L2 at kernel start;
* ``CW_EARLY``: the lane's code-plane values copied into its park slots
  before the stage pair, the product formed in the epilogue hook;
* ``A_PIPE``: stage-1 A fragments loaded one turn ahead;
* ``J_SKIP``: MMAs and copies of all-padding j-tiles skipped;
* ``USE_NJV``: the same at compile time: ``four_step`` takes the count of
  j-tiles per chunk as a template parameter, 2 where j <= 16 (the e2e
  shape);
* ``USE_PRE``: the LO and ramp tables built by a hook that ``four_step``
  calls after issuing its first copies, so the build overlaps them.

Names joined with ``+`` combine variants (``USE_NJV+USE_PRE``).

Prints the card's ``nvidia-smi`` name and power limit, each variant's
``ptxas`` registers and spills, and one line per (shape, variant, round).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FSM_PATCHES = [
    ("      if (s >= ksn) continue;\n",
     "      if (s >= ksn) continue;\n#ifdef J_SKIP\n"
     "      if (jc * KT + (lu % NJ) * 8 >= g.j) continue;\n#endif\n", 2),
    ("      const int ksn = min(KSC, g.ks - kc * KSC);\n"
     "      // this chunk's twiddles",
     "      const int ksn = min(KSC, g.ks - kc * KSC);\n#ifdef J_SKIP\n"
     "      const int jv = min(NJ, cdiv(g.j - jc * KT, 8));\n#else\n"
     "      constexpr int jv = NJ;\n#endif\n"
     "      // this chunk's twiddles", 1),
    ("      for (int s0 = 0; s0 < ksn; s0 += 2) {\n#pragma unroll\n"
     "        for (int h = 0; h < 2; ++h) {\n          const int s = s0 + h;\n"
     "          const float4 xr = __ldg(ap + s * 64), xi = __ldg(ap + s * 64 + 1);\n",
     "#ifdef A_PIPE\n      float4 nx[4];\n#pragma unroll\n"
     "      for (int h = 0; h < 4; ++h) nx[h] = __ldg(ap + (h >> 1) * 64 + (h & 1));\n"
     "#endif\n      for (int s0 = 0; s0 < ksn; s0 += 2) {\n#ifdef A_PIPE\n"
     "        float4 cx[4];\n#pragma unroll\n"
     "        for (int h = 0; h < 4; ++h) cx[h] = nx[h];\n"
     "        const int sn = s0 + 2 < ksn ? s0 + 2 : s0;\n#pragma unroll\n"
     "        for (int h = 0; h < 4; ++h)\n"
     "          nx[h] = __ldg(ap + (sn + (h >> 1)) * 64 + (h & 1));\n#endif\n"
     "#pragma unroll\n        for (int h = 0; h < 2; ++h) {\n"
     "          const int s = s0 + h;\n#ifdef A_PIPE\n"
     "          const float4 xr = cx[2 * h], xi = cx[2 * h + 1];\n"
     "#elif defined(NO_A_LOADS)\n"
     "          const float4 xr = make_float4(__int_as_float(lane + s), 0.f, 1.f, 0.5f), xi = xr;\n"
     "#else\n"
     "          const float4 xr = __ldg(ap + s * 64), xi = __ldg(ap + s * 64 + 1);\n"
     "#endif\n", 1),
    ("for (int t = 0; t < NJ; ++t) mma(",
     "for (int t = 0; t < NJ; ++t) if (t < jv) mma(", 4),
    ("for (int t = 0; t < NJ; ++t) b[t] = bt[",
     "for (int t = 0; t < NJ; ++t) if (t < jv) b[t] = bt[", 1),
    ("        for (int s = 0; s < NJ; ++s) {\n",
     "        for (int s = 0; s < NJ; ++s) {\n          if (s >= jv) continue;\n", 1),
    ("          // four waves, so dependent MMAs on one accumulator are NJ apart\n",
     "#ifndef NO_STAGE1\n", 1),
    ("          for (int t = 0; t < NJ; ++t) if (t < jv) mma(ci[t], ai, b[t].x, b[t].y);\n",
     "          for (int t = 0; t < NJ; ++t) if (t < jv) mma(ci[t], ai, b[t].x, b[t].y);\n"
     "#endif\n", 1),
    ("    for (int e = threadIdx.x; e < p.b24; e += blockDim.x)\n"
     "      cp_async16(dst + e, src + e);",
     "#ifndef NO_B2\n    for (int e = threadIdx.x; e < p.b24; e += blockDim.x)\n"
     "      cp_async16(dst + e, src + e);\n#endif", 1),
]

TRACK_PATCHES = [
    ("  float2* park = fac + 3 * nfac + warp * 4 * NQ * 32 + lane;\n",
     "  float2* park = fac + 3 * nfac + warp * 4 * NQ * 32 + lane;\n"
     "#ifdef PREFETCH_L2\n  {\n    const size_t x0 = size_t(e) * geo.k * n1;\n"
     "    const int lines = (geo.k * n1 + 31) / 32;\n"
     "    for (int l = threadIdx.x; l < 2 * lines; l += nt) {\n"
     "      const float* a = (l < lines ? blk_r : blk_i) + x0 + size_t(l % lines) * 32;\n"
     "      asm volatile(\"prefetch.global.L2 [%0];\" ::\"l\"(a));\n    }\n  }\n#endif\n", 1),
    ("    for (int i = threadIdx.x; i < 8 * geo.ks; i += nt)",
     "#ifndef NO_TABLES\n    for (int i = threadIdx.x; i < 8 * geo.ks; i += nt)", 1),
    ("      fac[2 * nfac + i] = cmul(a, __ldg(fl + i));\n    }\n",
     "      fac[2 * nfac + i] = cmul(a, __ldg(fl + i));\n    }\n#endif\n", 1),
    ("    const bool active = task < plan.tasks;\n    fsm::four_step<NQ, 2>(",
     "    const bool active = task < plan.tasks;\n#ifdef CW_EARLY\n    if (active) {\n"
     "      for (int slot = 0; slot < 4 * NQ; ++slot) {\n        int k2, k1;\n"
     "        fsm::out_place<NQ>(geo, task, slot, lane, k2, k1);\n"
     "        const bool ok = k2 < n2 && k1 < n1;\n"
     "        const size_t i = ok ? size_t(c) * nyz + k2 * n1 + k1 : 0;\n"
     "        float* d = reinterpret_cast<float*>(park + slot * 32);\n"
     "        fsm::cp_async4(d, cw_r + i, ok);\n        fsm::cp_async4(d + 1, cw_i + i, ok);\n"
     "      }\n    }\n#endif\n    fsm::four_step<NQ, 2>(", 1),
    ("          park[slot * 32] = make_float2(re, im);\n",
     "#ifdef CW_EARLY\n          park[slot * 32] = cmul(park[slot * 32], make_float2(re, im));\n"
     "#else\n          park[slot * 32] = make_float2(re, im);\n#endif\n", 1),
    ("      const float2 p =\n          cmul(make_float2(__ldg(cw_r + cbase + i), "
     "__ldg(cw_i + cbase + i)),\n               park[slot * 32]);",
     "#ifdef CW_EARLY\n      const float2 p = park[slot * 32];\n      (void)i;\n      (void)cbase;\n"
     "#else\n      const float2 p =\n          cmul(make_float2(__ldg(cw_r + cbase + i), "
     "__ldg(cw_i + cbase + i)),\n               park[slot * 32]);\n#endif", 1),
    ("    if (!active) continue;\n",
     "    if (!active) continue;\n#ifdef NO_EPILOGUE\n    continue;\n#endif\n", 1),
    ("          fsm::cp_async4(dst, blk_r + i, valid);\n"
     "          fsm::cp_async4(dst + 32, blk_i + i, valid);",
     "#ifdef NO_RAW\n          fsm::cp_async4(dst, blk_r, false);\n"
     "          fsm::cp_async4(dst + 32, blk_i, false);\n#else\n"
     "          fsm::cp_async4(dst, blk_r + i, valid);\n"
     "          fsm::cp_async4(dst + 32, blk_i + i, valid);\n#endif", 1),
]

# applied after FSM_PATCHES / TRACK_PATCHES; USE_NJV and USE_PRE select
FSM_HOOK_PATCHES = [
    ("template <int NQ, int NR, class Load, class Combine, class Epi>\n"
     "__device__ __forceinline__ void four_step(const Geo& g, const Plan& p,\n"
     "                                          int item, int task, bool active,\n"
     "                                          int n_acc, float4* smem, Load load,\n"
     "                                          Combine combine, Epi epi) {",
     "struct NoPre {\n  __device__ void operator()() const {}\n};\n"
     "template <int NQ, int NR, int NJV = NJ, class Load, class Combine, class Epi,\n"
     "          class Pre = NoPre>\n"
     "__device__ __forceinline__ void four_step(const Geo& g, const Plan& p,\n"
     "                                          int item, int task, bool active,\n"
     "                                          int n_acc, float4* smem, Load load,\n"
     "                                          Combine combine, Epi epi,\n"
     "                                          Pre pre = Pre()) {", 1),
    ("      if (s >= ksn) continue;\n",
     "      if (s >= ksn) continue;\n"
     "      if (NJV < NJ && (lu % NJ) >= NJV) continue;\n", 2),
    ("  copy_b2(0);\n  cp_commit();\n  cp_wait<0>();",
     "  copy_b2(0);\n  cp_commit();\n  pre();\n  cp_wait<0>();", 1),
    ("      for (int t = 0; t < NJ; ++t) {\n        const float2* w = g.tw",
     "      for (int t = 0; t < NJV; ++t) {\n        const float2* w = g.tw", 1),
    ("for (int t = 0; t < NJ; ++t) if (t < jv) b[t] = bt[",
     "for (int t = 0; t < NJV; ++t) if (t < jv) b[t] = bt[", 1),
    ("for (int t = 0; t < NJ; ++t) if (t < jv) mma(",
     "for (int t = 0; t < NJV; ++t) if (t < jv) mma(", 4),
    ("        for (int t = 0; t < NJ; ++t) {\n          const float4 w0 = tw[t][0]",
     "        for (int t = 0; t < NJV; ++t) {\n          const float4 w0 = tw[t][0]", 1),
    ("        for (int s = 0; s < NJ; ++s) {\n",
     "        for (int s = 0; s < NJV; ++s) {\n", 1),
]

TRACK_HOOK_PATCHES = [
    ("template <int NQ>\n__global__ void __launch_bounds__(TG_THREADS, 1)\n"
     "track_corr_kernel(",
     "template <int NQ, int NJV>\n__global__ void __launch_bounds__(TG_THREADS, 1)\n"
     "track_corr_kernel(", 1),
    ("  {\n    const float* par = params + size_t(item) * 5;",
     "  auto tables = [&] {\n    const float* par = params + size_t(item) * 5;", 1),
    ("    }\n#endif\n  }\n",
     "    }\n#endif\n  };\n#ifndef USE_PRE\n  tables();\n#endif\n", 1),
    ("fsm::four_step<NQ, 2>(", "fsm::four_step<NQ, 2, NJV>(", 1),
    ("          park[slot * 32] = make_float2(re, im);\n#endif\n        });",
     "          park[slot * 32] = make_float2(re, im);\n#endif\n        }\n"
     "#ifdef USE_PRE\n        , [&] { if (r == 0) tables(); }\n#endif\n        );", 1),
    ("  cudaError_t err = cudaSuccess;\n  FSM_DISPATCH_NQ(geo.nq,",
     "  cudaError_t err = cudaSuccess;\n#ifdef USE_NJV\n  const bool nj2 = geo.j <= 16;\n"
     "#else\n  const bool nj2 = false;\n#endif\n  FSM_DISPATCH_NQ(geo.nq,", 1),
    ("    err = allow_smem(track_corr_kernel<NQ>, smem);\n"
     "    if (err != cudaSuccess) return err;\n"
     "    track_corr_kernel<NQ><<<e_sub * n_chan, threads, smem,\n"
     "                            static_cast<cudaStream_t>(stream)>>>(",
     "    auto kern = nj2 ? &track_corr_kernel<NQ, 2> : &track_corr_kernel<NQ, 4>;\n"
     "    err = allow_smem(kern, smem);\n    if (err != cudaSuccess) return err;\n"
     "    kern<<<e_sub * n_chan, threads, smem,\n"
     "           static_cast<cudaStream_t>(stream)>>>(", 1),
]

VARIANTS = ["BASE", "NO_STAGE1", "NO_A_LOADS", "NO_TABLES", "NO_EPILOGUE",
            "NO_RAW", "NO_B2", "PREFETCH_L2", "CW_EARLY", "A_PIPE", "J_SKIP",
            "USE_NJV", "USE_PRE", "USE_NJV+USE_PRE"]
SHAPES = {"e2e": 2.048e6, "nottingham": 5.456e6, "odd-n1": 12.5e6,
          "live": 10e6, "synthetic": 8.184e6}


def patch(path: str, patches) -> None:
    with open(path) as f:
        s = f.read()
    for old, new, n in patches:
        if s.count(old) != n:
            raise SystemExit(f"{os.path.basename(path)}: the source changed "
                             f"where a patch applies:\n{old}")
        s = s.replace(old, new)
    with open(path, "w") as f:
        f.write(s)


def build(out: str, variants) -> dict:
    from tpu_gnss_torch import kernels
    src = os.path.join(out, "csrc")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(kernels.CSRC, src)
    patch(os.path.join(src, "four_step_mma.cuh"),
          FSM_PATCHES + FSM_HOOK_PATCHES)
    patch(os.path.join(src, "track_corr.cu"),
          TRACK_PATCHES + TRACK_HOOK_PATCHES)
    nvcc = kernels._nvcc()
    flags = [f for f in kernels.NVCC_FLAGS if f != "-shared"]
    cus = sorted(f for f in os.listdir(src) if f.endswith(".cu"))
    jobs = {}
    for v in variants:
        os.makedirs(os.path.join(out, v), exist_ok=True)
        for cu in cus:
            obj = os.path.join(out, v, cu[:-3] + ".o")
            cmd = ([nvcc] + flags + ["-Xptxas", "-v"]
                   + ([] if v == "BASE" else
                      [f"-D{x}" for x in v.split("+")])
                   + ["-I", src, "-c", "-o", obj, os.path.join(src, cu)])
            jobs[v, cu] = (obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for v in variants:
        objs = []
        for cu in cus:
            obj, p = jobs[v, cu]
            log = p.communicate()[0]
            if p.returncode:
                raise SystemExit(f"nvcc failed for {v} {cu}:\n{log[-3000:]}")
            regs = [ln.split("Used ")[1].split(" registers")[0]
                    for ln in log.splitlines() if "Used" in ln]
            spills = sum("0 bytes spill stores, 0 bytes spill loads" not in ln
                         for ln in log.splitlines() if "spill" in ln)
            print(f"{v} {cu}: registers {' '.join(regs)}, "
                  f"{spills} instances with spills", flush=True)
            objs.append(obj)
        so = os.path.join(out, v, "lib.so")
        subprocess.run([nvcc] + kernels.NVCC_FLAGS + ["-o", so] + objs,
                       check=True)
        lib = ctypes.CDLL(so)
        for name, argtypes in kernels._SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        libs[v] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--shared", action="store_true")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("track_corr_variants: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from tpu_gnss_torch import kernels
    from tpu_gnss_torch.ops import mxu_corr as mc
    from tpu_gnss_torch.ops import mxu_track as mt
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    variants = a.variants.split(",")
    t0 = time.perf_counter()
    libs = build(os.path.join(ROOT, "build", "track_corr_variants"),
                 variants)
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)
    dev = torch.device("cuda", 0)
    cases = [("track_corr", lab, mt.track_corr, mt.track_corr_plain,
              cs.track_case(SHAPES[lab], dev))
             for lab in a.shapes.split(",")]
    if a.shared:
        cases += [("fold_corr_reduce", lab, mc.fold_corr_reduce,
                   mc.fold_corr_reduce_plain,
                   cs.fold_case(fs, rows, 1, dev, seed=rows + 1))
                  for lab, fs, rows in (("e2e", 2.048e6, 41),
                                        ("nottingham", 5.456e6, 73))]
        cases.append(("corr_reduce", "nottingham", mc.corr_reduce,
                      mc.corr_reduce_plain,
                      cs.spectra_case(5.456e6, 73, 1, dev, seed=147)))
    for rnd in range(2):
        for name, lab, kern, plain, (args, kw) in cases:
            want = plain(*args, **kw)
            if name == "track_corr":
                ref = float(torch.hypot(want[..., 0], want[..., 1]).max())
            for v in variants:
                kernels._lib = libs[v]
                got = kern(*args, **kw)
                if name == "track_corr":
                    err = f"err {float((got - want).abs().max()) / ref:.2e}"
                else:
                    err = f"lags differing {int((got[1] != want[1]).sum())}"
                us = cs.time_ms(lambda: kern(*args, **kw)) * 1e3
                print(f"round {rnd} {name} {lab} {v}: {us:.2f} us, {err}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
