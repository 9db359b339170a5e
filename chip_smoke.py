"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero and
prints no result line):

1. Card and software: ``nvidia-smi`` name and power limit, torch and
   CUDA versions, the seconds the kernel build took and each kernel's
   ``ptxas`` line.
2. Each CUDA kernel against its plain PyTorch version on the card, at
   the main path's shapes, then the median time of both (CUDA events):
   ``fold_corr_reduce`` and ``corr_reduce`` (which no path of either
   package calls: it is driven here as an op) at the e2e (41 rows, NF
   2048, n_acc 1 and 8), nottingham (73 rows, NF 16384), SYNTHETIC (49
   rows, NF 16384, u_rows = q_cols = 64) and LIVE (41 rows, NF 10000 =
   100 x 100) shapes, ``corr_reduce`` also at the odd-n1 NF 12500; each
   line gives the achieved TFLOP/s, counted as 8 x the complex MACs of
   the un-padded four-step over the kernel time: per (row, SV, block)
   n1*n1*n2 + n1*n2*q_cols for the inverse, plus per (row, block)
   n2*u_rows*n1 + n2*n1*n1 for ``fold_corr_reduce``'s forward pass.  One
   ``torch.profiler`` pass splits ``fold_corr_reduce`` at nottingham into
   its forward and inverse-reduce kernels.  Then ``track_corr`` and
   ``mix_packed`` (``torch.equal`` at the e2e, nottingham and LIVE
   rates).
3. The main path at the e2e geometry: a 20 s, 6-SV, 2.048 Msps 1-bit
   capture through ``Receiver(device="cuda").process_source``; it must
   give >=4 detections, >=4 ephemerides and a fix within 60 m.
4. The main path at the ``nottingham`` geometry (4 s at 5.456 Msps,
   NF 16384): >=4 detections and those channels locked.
5. Launch counters: every receiver kernel (``fold_corr_reduce``,
   ``track_corr``, ``mix_packed``) launched in both main-path runs.
6. The folded search API at the nottingham geometry (32 PRNs, 73
   Doppler rows, NF 16384) on one 4 ms block of a 6-SV 1-bit scene:
   ``acquire`` (grid engine), ``acquire(engine="mxu")``,
   ``acquire_packed`` and ``detections_refined(power_grid())`` against
   ``detections_refined_fast`` agree; then an 8-block non-coherent
   search finds a weak SV.
7. The batched capture scan: 64 blocks of random bits at the
   ``synthetic`` preset (8.184 Msps, 49 Doppler rows, NF 16384) through
   ``acquire_folded_batch_mxu``, its time and rate in
   Msample*PRN*bin/s, and the grid engine ``acquire_folded_batch`` on
   the first 8 blocks against it.

The last two lines are a JSON object describing the kernels and the
result line ``{"ok": true, "device": {...}}``.  In the kernels line,
``max_abs_err`` is in the kernel's own output units and ``max_rel_err``
is the error that the tolerance bounds: max |dpeak|/peak for
``fold_corr_reduce`` and ``corr_reduce``, max error / max|P| for
``track_corr``, 0 for the bit-exact ``mix_packed``; ``launches`` counts
the run named in ``launch_run``.  Exits non-zero without a card, and
where the ``tpu_gnss_torch`` package is not beside it.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

FOLD_TOL = dict(rtol=0.03)           # peak/tot; lags must be equal
TRACK_ATOL = {2048: 2e-3, 16384: 2e-3, 12500: 4e-3}   # x max|P|


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` calls (CUDA events)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def fold_case(fs: float, rows: int, n_acc: int, dev, seed: int):
    """Folded blocks holding all 32 SVs' replicas at row-dependent code
    shifts plus noise: every (row, SV) cell has an unambiguous peak."""
    from tpu_gnss_torch.acquire.folded import (fft_len_for_period,
                                               period_replicas_np)
    from tpu_gnss_torch.ops import mxu_corr as mc
    rng = np.random.default_rng(seed)
    period = int(fs / 1000)
    nf = fft_len_for_period(period)
    n1, _ = mc.split_nf(nf)
    u_rows = mc.four_step_np(nf, period)["u_rows"]
    reps = period_replicas_np(fs, tuple(range(1, 33)))          # [32, P]
    x = 0.7 * (rng.standard_normal((rows, n_acc, period))
               + 1j * rng.standard_normal((rows, n_acc, period)))
    shifts = rng.integers(0, period, size=(rows, 32))
    for r in range(rows):
        for s in range(32):
            x[r] += np.roll(reps[s], shifts[r, s])
    xp = np.pad(x, ((0, 0), (0, 0), (0, u_rows * n1 - period)))
    shp = (rows, n_acc, u_rows, n1)
    xr = torch.from_numpy(xp.real.astype(np.float32).reshape(shp)).to(dev)
    xi = torch.from_numpy(xp.imag.astype(np.float32).reshape(shp)).to(dev)
    cr, ci = mc.fold_code_planes_T(
        np.fft.fft(reps.astype(np.float64), n=nf, axis=-1), period)
    cr, ci = torch.from_numpy(cr).to(dev), torch.from_numpy(ci).to(dev)
    return (xr, xi, cr, ci), dict(period=period, nf=nf)


def four_step_cmacs(n1, n2, q_cols, u_rows=0):
    """Complex MACs of the un-padded four-step: ``(inverse per (row, SV,
    block), forward per (row, block))``."""
    return n1 * n1 * n2 + n1 * n2 * q_cols, n2 * u_rows * n1 + n2 * n1 * n1


def compare_reduce(name, label, kernel, plain, desc, cmacs):
    """A peak/lag/total kernel against its plain version: lags equal,
    peak and total within FOLD_TOL, then both times and the kernel's
    TFLOP/s (8 x ``cmacs`` complex MACs per call)."""
    pk, lg, tt = (a.cpu() for a in kernel())
    torch.cuda.synchronize()
    ppk, plg, ptt = (a.cpu() for a in plain())
    # peaks are |corr|^2 sums of order 1e13 here, so the absolute error
    # is large in these units; the relative error says whether parity held
    err = float((pk - ppk).abs().max())
    rel = float(((pk - ppk).abs() / ppk).max())
    if not torch.equal(lg, plg):
        fail(f"{name} {label}: lags differ in {int((lg != plg).sum())} "
             "cells")
    np.testing.assert_allclose(pk.numpy(), ppk.numpy(), **FOLD_TOL)
    np.testing.assert_allclose(tt.numpy(), ptt.numpy(), **FOLD_TOL)
    ms = time_ms(kernel)
    plain_ms = time_ms(plain)
    tflops = 8 * cmacs / (ms * 1e-3) / 1e12
    log(f"{name} {label}: {desc} lags equal, max |dpeak| {err:.4e} of "
        f"peaks up to {float(ppk.max()):.4e}, max rel err {rel:.3e} (rtol "
        f"{FOLD_TOL['rtol']}), kernel {ms:.3f} ms ({tflops:.1f} TFLOP/s), "
        f"plain {plain_ms:.3f} ms")
    return dict(max_abs_err=err, max_rel_err=rel, ms=ms, plain_ms=plain_ms)


def check_fold(fs, rows, n_acc, dev, label):
    from tpu_gnss_torch.ops import mxu_corr as mc
    args, kw = fold_case(fs, rows, n_acc, dev, seed=rows + n_acc)
    t = mc.four_step_np(kw["nf"], kw["period"])
    inv, fwd = four_step_cmacs(t["n1"], t["n2"], t["q_cols"], t["u_rows"])
    return compare_reduce(
        "fold_corr_reduce", label,
        lambda: mc.fold_corr_reduce(*args, **kw),
        lambda: mc.fold_corr_reduce_plain(*args, **kw),
        f"rows={rows} n_sv=32 nf={kw['nf']} ({t['n1']}x{t['n2']}) "
        f"u_rows={t['u_rows']} q_cols={t['q_cols']} n_acc={n_acc}",
        rows * n_acc * (fwd + 32 * inv))


def check_track(fs, dev, label):
    from tpu_gnss_torch.acquire.folded import (fft_len_for_period,
                                               period_replicas_np)
    from tpu_gnss_torch.ops import mxu_track as mt
    from tpu_gnss_torch.ops.mxu_corr import four_step_np, split_nf
    from tpu_gnss_torch.track.channel import code_spectra_np
    rng = np.random.default_rng(int(fs) % 1000)
    p = int(round(fs * 1e-3))
    nf = fft_len_for_period(p)
    n1, _ = split_nf(nf)
    u_rows = four_step_np(nf, p)["u_rows"]
    n_chan, e_sub = 12, 10
    prns = list(range(1, n_chan + 1))
    # 12 SVs at integer-sample code shifts and random Dopplers; the first
    # two sit at the period edges so the early/late taps wrap
    shift = rng.integers(1, p - 1, n_chan)
    shift[:2] = (1, 0)
    dops = rng.uniform(-4000, 4000, n_chan)
    n = np.arange(e_sub * p)
    reps = period_replicas_np(fs, tuple(prns))
    iq = 0.5 * (rng.standard_normal(e_sub * p)
                + 1j * rng.standard_normal(e_sub * p))
    for c in range(n_chan):
        iq += (np.roll(np.tile(reps[c], e_sub), shift[c])
               * np.exp(2j * np.pi * dops[c] * n / fs))
    blk = np.pad(iq.reshape(e_sub, p), ((0, 0), (0, u_rows * n1 - p)))
    blk = blk.reshape(e_sub, u_rows, n1)
    d = 0.5 * p / 1023.0                # half-chip taps, in samples
    tau = np.broadcast_to((p - shift) % p + 0.25, (e_sub, n_chan))
    delta = np.broadcast_to(dops / fs, (e_sub, n_chan))
    phase0 = (delta * np.arange(e_sub)[:, None] * p) % 1.0
    params = np.stack([phase0, delta, tau, tau + d >= p, tau - d < 0],
                      axis=-1).astype(np.float32)
    spec = torch.from_numpy(code_spectra_np(prns, n_chan, fs)).to(dev)
    cw_r, cw_i = mt.spec_planes(spec, nf)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)
                                   ).to(dev)
    args = (t(blk.real), t(blk.imag), t(params), cw_r, cw_i)
    kw = dict(period=p, nf=nf, dsamp=d)
    got = mt.track_corr(*args, **kw).cpu()
    want = mt.track_corr_plain(*args, **kw).cpu()
    ref = float(torch.hypot(want[..., 0], want[..., 1]).max())
    err = float((got - want).abs().max())
    if not err <= TRACK_ATOL[nf] * ref:
        fail(f"track_corr {label}: max err {err} > "
             f"{TRACK_ATOL[nf]} x max|P| {ref}")
    ms = time_ms(lambda: mt.track_corr(*args, **kw))
    plain_ms = time_ms(lambda: mt.track_corr_plain(*args, **kw))
    log(f"track_corr {label}: e_sub={e_sub} n_chan={n_chan} nf={nf} "
        f"max err={err:.3e} (atol {TRACK_ATOL[nf]} x max|P|={ref:.1f}), "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return dict(max_abs_err=err, max_rel_err=err / ref, ms=ms,
                plain_ms=plain_ms)


def check_mix(fs, lo_rate, n_bits, sample0, dev, label):
    """mix_packed against mix_packed_plain: equal bit for bit."""
    from tpu_gnss_torch.ops import onebit
    rng = np.random.default_rng(n_bits)
    words = onebit.words_to_tensor(rng.integers(
        0, 2 ** 32, -(-n_bits // 32), dtype=np.uint32), dev)
    p0 = float((sample0 * float(lo_rate)) % 4.0)
    kw = dict(n_bits=n_bits, lo_rate=lo_rate, phase0_quarters=p0)
    got = onebit.mix_packed(words, **kw)
    want = onebit.mix_packed_plain(words, **kw)
    if not torch.equal(got, want):
        fail(f"mix_packed {label}: {int((got != want).sum())} of {n_bits} "
             "samples differ from the plain version")
    ms = time_ms(lambda: onebit.mix_packed(words, **kw))
    plain_ms = time_ms(lambda: onebit.mix_packed_plain(words, **kw))
    log(f"mix_packed {label}: {n_bits} samples ({fs / 1e6:g} Msps), "
        f"lo_rate {lo_rate:g}, phase0 {p0:.9g}: equal to the plain version, "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return dict(max_abs_err=0.0, max_rel_err=0.0, ms=ms, plain_ms=plain_ms)


def spectra_case(fs: float, rows: int, n_acc: int, dev, seed: int):
    """Conjugated data spectra [rows, n_acc, n1, n2] of fold_case's blocks
    and the [n_sv, n1, n2] wrapped code planes, for corr_reduce."""
    from tpu_gnss_torch.acquire.folded import period_replicas_np
    from tpu_gnss_torch.ops import mxu_corr as mc
    (xr, xi, _, _), kw = fold_case(fs, rows, n_acc, dev, seed)
    period, nf = kw["period"], kw["nf"]
    n1, n2 = mc.split_nf(nf)
    x = torch.complex(xr, xi).reshape(rows, n_acc, -1)
    g = torch.fft.fft(x, n=nf, dim=-1).conj().reshape(rows, n_acc, n1, n2)
    reps = period_replicas_np(fs, tuple(range(1, 33)))
    cr, ci = mc.wrap_code_planes(
        np.fft.fft(reps.astype(np.float64), n=nf, axis=-1), period)
    return ((g.real.contiguous(), g.imag.contiguous(),
             torch.from_numpy(cr).to(dev), torch.from_numpy(ci).to(dev)),
            dict(period=period))


def check_corr_reduce(fs, rows, n_acc, dev, label):
    from tpu_gnss_torch.ops import mxu_corr as mc
    args, kw = spectra_case(fs, rows, n_acc, dev, seed=2 * rows + n_acc)
    n1, n2 = args[0].shape[-2:]
    q_cols = min(n2, -(-kw["period"] // n1))
    smem = mc.stage_smem(n1, n1, n2, q_cols, planes=4, items=32,
                         n_acc=n_acc)
    return compare_reduce(
        "corr_reduce", label,
        lambda: mc.corr_reduce(*args, **kw),
        lambda: mc.corr_reduce_plain(*args, **kw),
        f"rows={rows} n_sv=32 nf={n1 * n2} ({n1}x{n2}) q_cols={q_cols} "
        f"n_acc={n_acc} dynamic smem {smem} B,",
        rows * 32 * n_acc * four_step_cmacs(n1, n2, q_cols)[0])


def profile_fold_split(dev) -> None:
    """One ``torch.profiler`` pass over ``fold_corr_reduce`` at the
    nottingham shape: the device time of each CUDA kernel it launches
    (pass A ``fcr_forward``, pass B ``fcr_reduce``), per call."""
    from torch.profiler import ProfilerActivity, profile
    from tpu_gnss_torch.ops import mxu_corr as mc
    args, kw = fold_case(5.456e6, 73, 1, dev, seed=74)
    calls = 5
    mc.fold_corr_reduce(*args, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            mc.fold_corr_reduce(*args, **kw)
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages():
        for k in ("fcr_forward", "fcr_reduce"):
            if k in ev.key:
                us = getattr(ev, "self_device_time_total", None)
                if us is None:
                    us = ev.self_cuda_time_total
                split[k] = split.get(k, 0.0) + us / 1e3 / calls
    if not split:
        log("fold_corr_reduce profiler split (nottingham): the profiler "
            "recorded no device time for the kernels")
        return
    log("fold_corr_reduce profiler split (nottingham 73x32, per call, "
        f"{calls} calls): " + ", ".join(f"{k} {v:.3f} ms"
                                        for k, v in sorted(split.items())))


def drive_corr_reduce(dev) -> int:
    """corr_reduce has no caller in either package: drive it once as an
    op at the e2e shape and count its launches."""
    from tpu_gnss_torch import kernels
    from tpu_gnss_torch.ops import mxu_corr as mc
    args, kw = spectra_case(2.048e6, 41, 1, dev, seed=7)
    kernels.LAUNCHES.reset()
    pk, lg, tt = mc.corr_reduce(*args, **kw)
    torch.cuda.synchronize()
    n = kernels.LAUNCHES.get("corr_reduce")
    if n <= 0 or not (torch.isfinite(pk).all() and torch.isfinite(tt).all()
                      and bool((lg >= 0).all())
                      and bool((lg < kw["period"]).all())):
        fail("corr_reduce op run: no launch or bad output")
    return n


# ---------------------------------------------------------------------------
# phases 3-4: the main path
# ---------------------------------------------------------------------------

def run_receiver(cfg, duration, tmpdir, name):
    from tpu_gnss_torch import kernels
    from tpu_gnss_torch.io.stream import FileSource1Bit
    from tpu_gnss_torch.receiver import Receiver
    from tpu_gnss_torch.signal import scene
    t0 = time.perf_counter()
    iq, _, rx = scene.build_scene(duration=duration, fs=cfg.fs)
    path = os.path.join(tmpdir, f"{name}.bin")
    scene.write_1bit_capture(iq, cfg.fc, cfg.fs, path)
    del iq
    log(f"{name}: {duration:g} s scene at {cfg.fs / 1e6:g} Msps built in "
        f"{time.perf_counter() - t0:.1f} s")
    recv = Receiver(cfg, device="cuda")
    kernels.LAUNCHES.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = recv.process_source(FileSource1Bit(path, cfg))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: kernels.LAUNCHES.get(k)
                for k in ("fold_corr_reduce", "track_corr", "mix_packed")}
    log(f"{name}: wall {wall:.3f} s for {duration:g} s of signal, "
        f"realtime factor {duration / wall:.2f}, launches {launches}")
    return res, rx, wall, launches


# ---------------------------------------------------------------------------
# phases 6-7: the folded search API and the batched capture scan
# ---------------------------------------------------------------------------

# 6 SVs of the folded-search scene: (prn, Doppler Hz, code phase chips,
# amplitude)
SEARCH_SVS = ((3, 1840.0, 303.4, 1.0), (9, -2460.0, 777.7, 0.8),
              (14, 420.0, 12.3, 0.7), (19, -3810.0, 1001.9, 0.6),
              (23, 4620.0, 512.5, 0.5), (31, -870.0, 641.1, 0.5))
WEAK_SV = (22, 800.0, 50.0, 0.04)     # needs the 8-block sum


def bits_scene(cfg, svs, n_samples, seed):
    """1-bit IF samples of ``svs`` at unit complex noise."""
    from tpu_gnss.signal import synth
    iq = synth.synth_baseband(
        [synth.SvSignal(prn=p, doppler_hz=d, code_phase_chips=c,
                        amplitude=a) for p, d, c, a in svs],
        cfg.fs, n_samples, noise_std=1.0, seed=seed)
    return synth.baseband_to_1bit_if(iq, cfg.fc, cfg.fs)


def folded_search(cfg, device, weak_k: int = 8):
    """Phase 6: the four folded-search forms agree, and an n_noncoherent
    search finds a weak SV.  Returns the kernel launch counts of the
    four-way run."""
    from tpu_gnss_torch import kernels
    from tpu_gnss_torch.acquire.folded import FoldedSearcher
    s = FoldedSearcher(cfg, device=device)
    log(f"folded search: fs {cfg.fs / 1e6:g} Msps, {len(cfg.prns)} PRNs, "
        f"{len(s.dops_hz)} Doppler rows, NF {s.nf}, block {s.block_len}")
    want = sorted(p for p, *_ in SEARCH_SVS)
    bits = bits_scene(cfg, SEARCH_SVS, s.block_len, seed=11)
    kernels.LAUNCHES.reset()
    sync = torch.cuda.synchronize if s.device.type == "cuda" else lambda: 0
    sync()
    t0 = time.perf_counter()
    res = {"acquire": s.acquire(bits=bits),
           "acquire mxu": s.acquire(bits=bits, engine="mxu"),
           "acquire_packed": s.acquire_packed(bits)}
    refined = s.detections_refined(s.power_grid(bits=bits))
    fast = s.detections_refined_fast(bits=bits)
    sync()
    wall = time.perf_counter() - t0
    launches = {k: kernels.LAUNCHES.get(k)
                for k in ("mix_packed", "fold_corr_reduce")}
    dets = {k: s.detections(r) for k, r in res.items()}
    for name, d in list(dets.items()) + [("detections_refined", refined),
                                         ("detections_refined_fast", fast)]:
        prns = sorted(x["prn"] for x in d)
        log(f"  {name}: PRNs {prns}, SNR "
            + " ".join(f"{x['snr']:.1f}" for x in d))
        if prns != want:
            fail(f"folded search {name}: PRNs {prns}, want {want}")
    base = {x["prn"]: x for x in dets["acquire"]}
    for name in ("acquire mxu", "acquire_packed"):
        for x in dets[name]:
            b = base[x["prn"]]
            if (x["ca_shift"], x["doppler_hz"]) != (b["ca_shift"],
                                                    b["doppler_hz"]):
                fail(f"folded search {name}: PRN {x['prn']} at "
                     f"({x['ca_shift']}, {x['doppler_hz']}), grid engine "
                     f"({b['ca_shift']}, {b['doppler_hz']})")
    np.testing.assert_allclose(res["acquire_packed"].snr.cpu().numpy(),
                               res["acquire"].snr.cpu().numpy(), rtol=1e-5)
    np.testing.assert_allclose(res["acquire mxu"].snr.cpu().numpy(),
                               res["acquire"].snr.cpu().numpy(), rtol=0.03)
    p = s.period
    for w, g in zip(refined, fast):
        dca = (g["ca_shift"] - w["ca_shift"] + p / 2) % p - p / 2
        if abs(g["doppler_hz"] - w["doppler_hz"]) >= 1.0 or abs(dca) >= 0.05:
            fail(f"folded search: refined PRN {w['prn']} differs: grid "
                 f"({w['doppler_hz']}, {w['ca_shift']}), fast "
                 f"({g['doppler_hz']}, {g['ca_shift']})")
    log(f"folded search: the four forms agree ({wall:.3f} s for all five "
        f"calls, first use included), launches {launches}")
    for k, n in launches.items():
        if n <= 0 and s.device.type == "cuda":
            fail(f"folded search: kernel {k} was never launched")
    # weak SV: 8 blocks summed non-coherently
    wbits = bits_scene(cfg, (WEAK_SV,), weak_k * s.block_len, seed=7)
    row = list(cfg.prns).index(WEAK_SV[0])
    one = s.acquire(bits=wbits)
    if WEAK_SV[0] in [x["prn"] for x in s.detections(one)]:
        fail(f"folded search: weak PRN {WEAK_SV[0]} already found in one "
             "block: the scene does not test the non-coherent sum")
    for engine in ("xla", "mxu"):
        acc = s.acquire(bits=wbits, n_noncoherent=weak_k, engine=engine)
        d = s.detections(acc, n_noncoherent=weak_k)
        log(f"  weak PRN {WEAK_SV[0]} ({engine}): SNR "
            f"{float(one.snr[row]):.2f} with 1 block, "
            f"{float(acc.snr[row]):.2f} with {weak_k}; detections "
            f"{[(x['prn'], x['doppler_hz']) for x in d]}")
        if [x["prn"] for x in d] != [WEAK_SV[0]] or \
                abs(d[0]["doppler_hz"] - WEAK_SV[1]) > 130.0:
            fail(f"folded search: weak PRN {WEAK_SV[0]} not found with "
                 f"{weak_k} blocks ({engine})")
    return launches


def batched_scan(cfg, device, n_blocks: int = 64, n_grid: int = 8,
                 reps: int = 3):
    """Phase 7: bench.py's batched capture scan through the kernel
    engine, timed, and the grid engine on the first blocks against it."""
    from tpu_gnss_torch.acquire import folded as F
    s = F.FoldedSearcher(cfg, device=device)
    rng = np.random.default_rng(0)
    blocks = torch.from_numpy(rng.integers(
        0, 2, (n_blocks, s.block_len), dtype=np.uint8)).to(s.device)
    cw_r, cw_i = s.mxu_code_planes()
    kw = dict(fs=cfg.fs, lo_rate=cfg.lo_rate, n_coherent=s.n_coherent,
              from_bits=True, period=s.period)
    scan = lambda: F.acquire_folded_batch_mxu(blocks, cw_r, cw_i,
                                              s.dops_hz, nf=s.nf, **kw)
    grid = lambda: F.acquire_folded_batch(blocks[:n_grid], s.code_ffts_p,
                                          s.dops_hz, **kw)
    res, ref = scan(), grid()
    n_sv, n_dop = len(cfg.prns), len(s.dops_hz)
    snr = res.snr.cpu().numpy()
    if snr.shape != (n_blocks, n_sv) or not np.isfinite(snr).all() \
            or not snr.max() < cfg.snr_threshold:
        fail(f"batched scan: SNR shape {snr.shape}, max {snr.max()} "
             "(noise must stay under the threshold)")
    same = ((res.ca_shift[:n_grid] == ref.ca_shift)
            & (res.doppler_hz[:n_grid] == ref.doppler_hz)).cpu().numpy()
    if same.sum() < 0.97 * same.size:
        fail(f"batched scan: kernel and grid engine agree on only "
             f"{int(same.sum())} of {same.size} (block, SV) cells")
    np.testing.assert_allclose(snr[:n_grid][same],
                               ref.snr.cpu().numpy()[same], rtol=0.03)
    if s.device.type != "cuda":
        return None
    ms = time_ms(scan, reps=reps, warm=1)
    grid_ms = time_ms(grid, reps=reps, warm=1)
    rate = n_sv * n_dop * s.block_len * n_blocks / (ms * 1e-3) / 1e6
    grid_rate = n_sv * n_dop * s.block_len * n_grid / (grid_ms * 1e-3) / 1e6
    log(f"batched scan: {n_blocks} blocks x {s.block_len} samples, "
        f"{n_sv} PRNs x {n_dop} bins, NF {s.nf}; kernel engine "
        f"{ms:.1f} ms = {rate:.1f} Msample*PRN*bin/s; grid engine "
        f"{n_grid} blocks {grid_ms:.1f} ms = {grid_rate:.1f} "
        f"Msample*PRN*bin/s; {int(same.sum())}/{same.size} cells agree")
    return dict(ms=ms, rate=rate, grid_ms=grid_ms, grid_rate=grid_rate)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpu_gnss_torch import PRESETS, ReceiverConfig, kernels
    from tpu_gnss_torch.acquire.folded import FoldedSearcher
    from tpu_gnss_torch.track.quality import pll_lock_metric

    # --- phase 1: card and software -------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    kernels.build(verbose=True)
    kernels.lib()
    nvcc = ("cached" if kernels.BUILD_SECONDS is None
            else f"{kernels.BUILD_SECONDS:.2f} s")
    log(f"kernel build + load: {time.perf_counter() - t0:.2f} s "
        f"(nvcc: {nvcc})")
    for ln in kernels.BUILD_LOG.splitlines():
        if "Used" in ln or "spill" in ln or "Compiling entry" in ln:
            log("  ptxas: " + ln.strip())
    dev = torch.device("cuda", 0)

    # --- phase 2: kernels against their plain versions -------------------
    live = PRESETS["live"]
    live_rows = len(FoldedSearcher(live, device=dev).dops_hz)
    fold_e2e = check_fold(2.048e6, 41, 1, dev, "e2e")
    check_fold(2.048e6, 41, 8, dev, "e2e-weak")
    check_fold(5.456e6, 73, 1, dev, "nottingham")
    check_fold(PRESETS["synthetic"].fs, 49, 1, dev, "synthetic")
    check_fold(live.fs, live_rows, 1, dev, "live")
    profile_fold_split(dev)
    cr_e2e = check_corr_reduce(2.048e6, 41, 1, dev, "e2e")
    check_corr_reduce(2.048e6, 41, 8, dev, "e2e-weak")
    check_corr_reduce(5.456e6, 73, 1, dev, "nottingham")
    check_corr_reduce(PRESETS["synthetic"].fs, 49, 1, dev, "synthetic")
    check_corr_reduce(live.fs, live_rows, 1, dev, "live")
    check_corr_reduce(12.5e6, 41, 1, dev, "odd-n1")
    cr_launches = drive_corr_reduce(dev)
    track_e2e = check_track(2.048e6, dev, "e2e")
    check_track(5.456e6, dev, "nottingham")
    check_track(12.5e6, dev, "odd-n1")
    mix_e2e = check_mix(2.048e6, 1.0, 2_048_000, 0, dev, "e2e")
    check_mix(5.456e6, 3.0, 5_456_000, 0, dev, "nottingham")
    check_mix(live.fs, live.lo_rate, 10_000_000 - 7, 1_000_000_007, dev,
              "live")

    with tempfile.TemporaryDirectory() as tmp:
        # --- phase 3: main path, e2e geometry ----------------------------
        fs = 2.048e6
        cfg = ReceiverConfig(fs=fs, fc=fs / 4, max_fo=5000.0, fft_len=4096,
                             snr_threshold=17.0, num_chans=12)
        res, rx, wall, launches = run_receiver(cfg, 20.0, tmp, "e2e")
        decoded = [r for r in res.channels if r.eph.valid()]
        err = (float(np.linalg.norm(np.array(
            [res.solutions[-1].x, res.solutions[-1].y,
             res.solutions[-1].z]) - np.array(rx)))
            if res.solutions else float("nan"))
        log(f"e2e: {len(res.detections)} detections "
            f"{sorted(d['prn'] for d in res.detections)}, "
            f"{len(decoded)} ephemerides, {len(res.solutions)} fixes, "
            f"final error {err:.2f} m")
        if len(res.detections) < 4 or len(decoded) < 4:
            fail("e2e: fewer than 4 detections or ephemerides")
        if not err < 60.0:
            fail(f"e2e: final fix error {err} m (limit 60 m)")
        # --- phase 4: main path, nottingham geometry ---------------------
        cfg_n = ReceiverConfig(fs=5.456e6, fc=4.092e6, max_fo=5000.0,
                               num_chans=12)
        res_n, _, wall_n, launches_n = run_receiver(cfg_n, 4.0, tmp,
                                                    "nottingham")
        locked = [r.prn for r in res_n.channels
                  if not r.lost and r.n_epochs >= 2000
                  and pll_lock_metric(r.ip_hist, r.qp_hist, 1000) > 0.45]
        det_n = sorted(d["prn"] for d in res_n.detections)
        log(f"nottingham: {len(det_n)} detections {det_n}, "
            f"locked {sorted(locked)}")
        if len(det_n) < 4 or not set(det_n) <= set(locked):
            fail("nottingham: fewer than 4 detections, or detected "
                 "channels not locked")

    # --- phase 5: launch counters ---------------------------------------
    for run, counts in (("e2e", launches), ("nottingham", launches_n)):
        for k, n in counts.items():
            if n <= 0:
                fail(f"{run}: kernel {k} was never launched on the path")
    log("launch counters: every receiver kernel launched in both "
        "main-path runs")

    # --- phase 6: the folded search API at the nottingham geometry ------
    folded_search(cfg_n, dev)
    # --- phase 7: the batched capture scan --------------------------------
    scan = batched_scan(PRESETS["synthetic"], dev)
    log(f"batched scan rate: {scan['rate']:.1f} Msample*PRN*bin/s "
        f"({scan['ms']:.1f} ms for 64 blocks) on {smi}")

    e2e_run = "e2e receiver run (phase 3)"
    kern = [
        dict(name="fold_corr_reduce", route="cuda",
             source="tpu_gnss_torch/csrc/fold_corr_reduce.cu",
             replaces="tpu_gnss/ops/mxu_corr.py:377",
             launches=launches["fold_corr_reduce"], launch_run=e2e_run,
             **fold_e2e),
        dict(name="track_corr", route="cuda",
             source="tpu_gnss_torch/csrc/track_corr.cu",
             replaces="tpu_gnss/ops/mxu_track.py:376",
             launches=launches["track_corr"], launch_run=e2e_run,
             **track_e2e),
        dict(name="mix_packed", route="cuda",
             source="tpu_gnss_torch/csrc/mix_packed.cu",
             replaces="tpu_gnss/ops/onebit.py:175",
             launches=launches["mix_packed"], launch_run=e2e_run,
             **mix_e2e),
        dict(name="corr_reduce", route="cuda",
             source="tpu_gnss_torch/csrc/corr_reduce.cu",
             replaces="tpu_gnss/ops/mxu_corr.py:430",
             launches=cr_launches,
             launch_run="op call at the e2e shape (no caller in either "
                        "package)", **cr_e2e),
    ]
    log(smi)                  # as nvidia-smi gives it
    print(json.dumps({"kernels": kern}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
