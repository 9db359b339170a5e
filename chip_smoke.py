"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero and
prints no result line):

1. Card and software: ``nvidia-smi`` name and power limit, torch and
   CUDA versions, the seconds the kernel build took and each kernel's
   ``ptxas`` line.
2. Each CUDA kernel against its plain PyTorch version on the card, at
   the main path's shapes, then the device time of both per call (CUDA
   events over calls enqueued back to back behind a sleep kernel):
   ``fold_corr_reduce`` and ``corr_reduce`` (which no path of either
   package calls: it is driven here as an op) at the e2e (41 rows, NF
   2048, n_acc 1 and 8), nottingham (73 rows, NF 16384), SYNTHETIC (49
   rows, NF 16384, u_rows = q_cols = 64), LIVE (41 rows, NF 10000 =
   100 x 100), hackrf (801 rows, NF 10000) and rtlsdr (2857 rows, NF
   8192 = 64 x 128) shapes, ``fold_corr_reduce`` also at e2e-wide (801
   rows at NF 2048: phase 16's +-100 kHz replay search) and
   ``corr_reduce`` at the odd-n1 NF 12500;
   each line gives the achieved TFLOP/s, counted as 8 x the complex MACs
   of the un-padded four-step over the kernel time: per (row, SV, block)
   n1*n1*n2 + n1*n2*q_cols for the inverse, plus per (row, block)
   n2*u_rows*n1 + n2*n1*n1 for ``fold_corr_reduce``'s forward pass.  One
   ``torch.profiler`` pass splits ``fold_corr_reduce`` at nottingham into
   its forward and inverse-reduce kernels.  Then ``track_corr`` (10
   epochs x 12 channels at the e2e, nottingham, odd-n1, 10 Msps and 2.8
   Msps rates and at e2e with 0.25-chip taps, within ``TRACK_ATOL`` x
   max|P| of the plain version; FLOPs per item counted as
   ``fold_corr_reduce``'s forward pass) and ``mix_packed``
   (``torch.equal`` at the e2e, nottingham and LIVE rates).  Every line
   gives the kernel's bound: the larger of its FLOPs at the H100's dense
   TF32 peak (495 TFLOP/s) and its bytes (each input read once, each
   output written once) at 3.35 TB/s, and the share bound / time.
2b. The host->device links: each device dequantizer on seeded data
   against the numpy computation of the same arithmetic (int8 and int4
   planes equal; the iq8, iq4 and iq2 capture-byte links with DC removal
   within 1e-6 x max|x|), with the bytes each uploads per sample.
3. The main path at the e2e geometry: a 20 s, 6-SV, 2.048 Msps 1-bit
   capture through ``Receiver(device="cuda").process_source``; it must
   give >=4 detections, >=4 ephemerides and a fix within 60 m.
4. The main path at the ``nottingham`` geometry (4 s at 5.456 Msps,
   NF 16384): >=4 detections and those channels locked.
5. Launch counters: every receiver kernel (``fold_corr_reduce``,
   ``track_corr``, ``mix_packed``, ``loop_update``) launched in both
   1-bit runs.  Every
   run of phases 3-12 sets the counts to 0 just before it and reads them
   just after, and fails if a kernel of its path was not launched.
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
8. Phase 3's baseband written as an int8 I/Q capture too, through
   ``IQFileSource`` and the default int8 link (the file's own bytes):
   phase 3's fix gate.
9. Full width at the ``hackrf`` preset (10 Msps, 32 PRNs, +-100 kHz, 801
   Doppler rows, 12 channels): a 4 s, 6-SV int8 I/Q scene with a +25 kHz
   common offset, once per link (int8, int4, int2, float32): >= 4
   detections, the same PRNs on every link, those channels locked, the
   oscillator-offset estimate within 250 Hz of the truth, and int4 / int2
   against int8 within the reference's bars (whole prompt history, no
   sign allowance); the MB uploaded per second of signal.
10. The ``rtlsdr`` preset (2.8 Msps, 2857 rows): a 4 s uint8 scene at
   -18 kHz through the int8 link, with phase 9's gates.
11. Live mode: a writer thread grows phase 3's 1-bit capture at 4x real
   time; ``FollowSource1Bit`` with ``on_solution``, ``max_history_s`` 600
   and a ``.done`` sidecar must deliver a fix in-stream, the last within
   60 m.
12. The gather correlator (``fft_correlator=False``) on the first 4 s of
   phase 3's capture must lock the channels the FFT path locks.
13. ``gps_test`` on the card: the Nottingham 5-SV golden reconstruction
   (tests/test_acquire.py:140-168) as a 1-bit capture six compat runs
   long, through the port's ``run_capture`` in the compat, native and
   folded modes on the card (six runs) and then on the CPU (two) in the
   same process: the first two runs agree (satellite, lo_shift, ca_shift
   rows equal; unrounded SNR within 2e-3, 0.03 for the folded mode's
   TF32 kernel), ``gps_test.main`` on the card prints those rows, native
   run 0 gives the golden table within one sample, the folded mode
   launches ``fold_corr_reduce``; each mode's wall per run (median of
   runs 1-5, with min and max) and Msample*PRN*bin/s.
14. Warm start: the CLI with ``--checkpoint`` on phase 3's capture, then
   ``--warm-start`` with ``--tow`` pinned on its first 8 s (the
   directed-search line, a fix within 150 m), then
   ``process_source(warm_ephemerides=, search_prns=[2, 3, 4, 5, 6])`` on 8
   s (detections inside the subset, a fix within 150 m, every receiver
   kernel launched); seconds of signal to the first fix cold against warm,
   and the cold search's device time for 5 PRNs against 32.
15. The mesh on the card: ``acquire_refined_sharded`` at the e2e (41
   rows) and hackrf (801 rows, 32 PRNs) shapes on meshes of 1, 2 and 4
   logical shards of ``cuda:0`` against ``acquire_refined_mxu`` (the same
   ``[3, n_sv]`` stack; each shard's Doppler rows launched alone against
   the full-grid launch, bit for bit, or within phase 2's near-tie rule;
   the device time of each); ``make_tracker_sharded`` at 2.048 and 10 Msps,
   12 channels on 2 and 4 shards, against ``track_epochs`` within
   ``TRACK_ATOL`` x max|P|; the receiver on a 2-shard mesh over phase 3's
   capture (phase 3's fix gate and fix epochs) and on a 4-shard mesh over
   phase 9's hackrf int8 scene (phase 9's gates and PRNs); the CUDA
   kernels and copies per 10 ms step with no mesh and 1, 2, 4 shards (at
   most 3.5 per shard: each shard's tracker replays its own graph); the
   CLI with ``--mesh-devices 1``; the multi-process worker (``python -m
   tpu_gnss_torch.dist.multihost --flagship``) as 2 gloo processes sharing
   the card and 1 nccl process, 4 blocks each, against the single-process
   engines: the exact searcher, the bank, and ``fold_corr_reduce`` through
   ``acquire_folded_multihost`` with the blocks across the processes and
   with the Doppler grid across them (launched in every process).  With
   two cards, the same on ``make_mesh(2, device="cuda")`` and 2 nccl
   processes; with one, a line says so.
16. The reference's slow receiver oracles on the card, at their scenes
   (2.048 Msps, 12 channels, 32 PRNs, ``fft_len`` 4096) and their own
   bars: ``process_iq`` on phase 3's baseband (tests/test_e2e.py:193),
   phase 3's capture at ``chunk_s`` 0.5 / 1 / 4 / 8 (:290), SV 3 faded
   to 0.05 from 20 s of 26 s, gated and ungated (:326), a receiver moving
   at ENU (15, 8, 0) m/s with its RMC / VTG (:360), the +60 kHz replay
   through ``rfchannel.apply_channel`` on the +-100 kHz grid (:405), a 5
   Hz/s Doppler ramp (:445), the 32 s soak with PRN 2 blocked from 8 to 14
   s (tests/test_soak.py:30; the search that re-acquires PRN 2 must
   launch ``fold_corr_reduce``), and the config matrix of
   tests/test_stream.py:1243-1290 with the acquisition engine each ran.
   Every run needs ``fold_corr_reduce`` (where the kernel engine ran),
   ``track_corr``, and ``mix_packed`` where 1-bit input crosses as
   packed words.  Its scenes build in worker processes while the card
   runs phases 1-2b, and the workers end before phase 3.
17. Boot and in-loop trace, each boot run a process of its own: (a) the
   receiver CLI on phase 3's 20 s capture with the cache root
   (``$TPU_GNSS_TORCH_CACHE_DIR``) at an empty directory A, (b)
   ``python -m tpu_gnss_torch.cli.warmup`` at the e2e geometry in an
   empty directory B, (c) (a) again in B: the wall of each from spawn to
   exit, the nvcc seconds of (a) and (b), the boot saving (a) - (c).
   (a) and (c) must hold phase 3's fix (within 60 m), (b) must launch
   ``mix_packed`` and ``fold_corr_reduce``, (c) must build nothing (B's
   listing and the library's mtime unchanged), and A and B must end
   holding one library each.  Then the first 4 s of phase 3's capture
   (phase 12's FFT-dot run) inside ``utils.metrics.device_trace``: from
   the trace JSON, each receiver kernel's device time and call count
   (graph replays included), which must equal ``kernels.LAUNCHES``,
   ``mix_packed``'s share of the loop's device time, and the card's busy
   share of the traced window.
18. The tracking bank as one device program per chunk: (a)
   ``loop_update`` against ``loop_update_plain`` on the taps of 100-step
   chains (``LOOP_SHAPES``: 12 channels at ``e_sub`` 10 at e2e and
   hackrf, at ``e_sub`` 1 and 4 at e2e, and 3, 6, 13 and 200 channels at
   ``e_sub`` 10), each step from the same state (state and outputs within
   ``LOOP_STEP_TOL`` x each field's scale, phases wrap-aware; the next
   step's parameters, with taps and with ``taps=None``; flags equal),
   then each 100-step chain end to end with ``par=None``
   (``LOOP_CHAIN_TOL``), both device times, the bound and the launch
   floor (an empty ``torch.cuda._sleep(0)`` launch timed the same way);
   (b) ``GraphedTracker`` against eager
   ``track_epochs`` over phase 3's 20 s baseband in 1 s chunks and a tail,
   with each correlator (FFT-dot and gather) and the same slot changes
   between chunks: outputs within
   ``LOOP_CHAIN_TOL``, NAV bit signs equal after lock, each replay
   counted in ``kernels.LAUNCHES``; (c) phases 3, 4, 8, 9 (int8) and 10
   run again, each wall with the receiver's stage seconds, and the CUDA
   kernels and copies per 10 ms step of the e2e receiver (at most 3.5:
   two in the step, the rest the chunk's copies and the search); (d)
   ``loop_update``'s time, launches per second of signal and bound; (e)
   the receiver's prewarm and the process's shared trackers: everything
   the port builds once per process dropped by ``tpu_gnss_torch.cache.
   clear()`` (the shared trackers, the search tables, the kernels' device
   tables and the record of the prewarms that ran, so the next receiver of
   each geometry really is the first of the process to ask), then
   phase 3's e2e 20 s 1-bit capture and
   phase 9's hackrf 4 s int8 scene through two fresh receivers each,
   recording the program's spans, each run's tracker
   counts (eager chunks, captures and replays of the loop), prewarm and
   wait seconds, wall and the device memory reserved beyond the phase's
   start (``torch.cuda.memory_reserved`` after ``empty_cache``); it fails
   if a loop ran a chunk eagerly or captured, if the first receiver's
   prewarm did not capture or the second's did, if a result (detections,
   channel histories, fixes) is not bit-identical to a receiver's on a
   private, un-prewarmed ``GraphedTracker``, or if a gate of phases 3
   and 9 misses; each run's prewarm spans (``receiver.prewarm.*``, the
   wait for them) and search spans are printed.  Phase 3 prints its cold
   start's spans too: the first receiver of the process.

Phase 2 also holds ``fold_corr_reduce`` at the e2e shape with 5 and 11 SVs
(the directed search's SV counts).  Phases 8-18 run before 6-7, inside
phase 3's temporary directory.  Every
receiver run prints its wall, realtime factor, ``receiver.transfer``
seconds and launch counts.
The last two lines are a JSON object describing the kernels and the
result line ``{"ok": true, "device": {...}}``.  In the kernels line,
``max_abs_err`` is in the kernel's own output units and ``max_rel_err``
is the error that the tolerance bounds: max |dpeak|/peak for
``fold_corr_reduce`` and ``corr_reduce``, max error / max|P| for
``track_corr``, 0 for the bit-exact ``mix_packed``, the worst error x
field scale for ``loop_update``; ``launches`` counts the run named in
``launch_run``; the times, the bound and its share are those of the e2e
shape (``loop_update``'s operations at the float32 peak, 67 TFLOP/s);
``library_ms`` is null, since no single PyTorch call computes any of the
five functions.  Exits non-zero without a card,
and where the ``tpu_gnss_torch`` package is not beside it.
"""

from __future__ import annotations

import contextlib
import json
import multiprocessing
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, wait

import numpy as np
import torch

FOLD_TOL = dict(rtol=0.03)           # peak/tot; lags must be equal
# track_corr against track_corr_plain, x max|P|: the numpy emulation of the
# kernel's TF32 arithmetic stays within a quarter of this on these inputs
# (tests/test_torch_mxu_track.py), and within the reference's own bars
# (2e-3, 4e-3 at odd n1) against the JAX kernel
TRACK_ATOL = 5e-4
# H100 SXM peaks (NVIDIA data sheet): dense TF32 tensor cores, HBM3
TF32_PEAK = 495e12
HBM_BPS = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """``(bound_ms, bound_by)``: the least time the card could take, the
    larger of ``flops`` at the TF32 peak and ``nbytes`` (each input read
    once, each output written once) at the memory rate."""
    t_ops, t_bytes = flops / TF32_PEAK, nbytes / HBM_BPS
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def timing(ms: float, plain_ms: float, flops: float, nbytes: float) -> dict:
    """The timing keys of a kernels-line entry, and its share of the
    bound."""
    b_ms, by = bound(flops, nbytes)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                share=b_ms / ms, library_ms=None)


def bound_text(t: dict) -> str:
    return (f"bound {t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}), "
            f"share {100 * t['share']:.1f}%")


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Device time of ``fn`` per call, ``reps`` calls back to back (CUDA
    events).  A sleep kernel holds the card while the host enqueues the
    calls, so the host's own time per call (tens of microseconds of Python
    and launch for one kernel) does not leak into the reading."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(3 * host_s * 2e9) + 1_000_000)  # > 3x at 2 GHz
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

ALL_PRNS = tuple(range(1, 33))


def fold_case(fs: float, rows: int, n_acc: int, dev, seed: int,
              prns=ALL_PRNS):
    """Folded blocks holding all 32 SVs' replicas at row-dependent code
    shifts plus noise, and the code planes of ``prns`` (the directed
    search's subsets): every (row, SV) cell has an unambiguous peak."""
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
    sel = reps[[p - 1 for p in prns]]
    cr, ci = mc.fold_code_planes_T(
        np.fft.fft(sel.astype(np.float64), n=nf, axis=-1), period)
    cr, ci = torch.from_numpy(cr).to(dev), torch.from_numpy(ci).to(dev)
    return (xr, xi, cr, ci), dict(period=period, nf=nf)


def four_step_cmacs(n1, n2, q_cols, u_rows=0):
    """Complex MACs of the un-padded four-step: ``(inverse per (row, SV,
    block), forward per (row, block))``."""
    return n1 * n1 * n2 + n1 * n2 * q_cols, n2 * u_rows * n1 + n2 * n1 * n1


def compare_reduce(name, label, kernel, plain, desc, cmacs, nbytes):
    """A peak/lag/total kernel against its plain version: lags equal (but
    for rare near-ties, below), peak and total within FOLD_TOL, then both
    times, the kernel's TFLOP/s (8 x ``cmacs`` complex MACs per call) and
    its bound."""
    pk, lg, tt = (a.cpu() for a in kernel())
    torch.cuda.synchronize()
    ppk, plg, ptt = (a.cpu() for a in plain())
    # peaks are |corr|^2 sums of order 1e13 here, so the absolute error
    # is large in these units; the relative error says whether parity held
    err = float((pk - ppk).abs().max())
    rel = float(((pk - ppk).abs() / ppk).max())
    # lags equal, but for near-ties: where two lags of a cell hold
    # values within TF32's ~7e-4 of each other (at 10 Msps a chip spans
    # ~10 samples, so the neighbouring lag sits only ~10% lower before the
    # other 31 SVs' cross-correlation adds in), the kernel may pick the
    # other one.  Such a cell reports the same peak value within 2e-3; a
    # wrong lag would report a lower one.  At most 1e-3 of the cells.
    diff = lg != plg
    n_diff = int(diff.sum())
    tie = (pk - ppk).abs() <= 2e-3 * ppk
    if int((diff & ~tie).sum()) or n_diff > 1e-3 * diff.numel():
        fail(f"{name} {label}: lags differ in {n_diff} of {diff.numel()} "
             f"cells, {int((diff & ~tie).sum())} of them with peaks more "
             "than 2e-3 apart")
    for c in diff.nonzero()[:5].tolist():
        c = tuple(c)
        log(f"  {name} {label} near-tie cell {c}: kernel lag {int(lg[c])} "
            f"peak {float(pk[c]):.6e}, plain lag {int(plg[c])} peak "
            f"{float(ppk[c]):.6e}")
    np.testing.assert_allclose(pk.numpy(), ppk.numpy(), **FOLD_TOL)
    np.testing.assert_allclose(tt.numpy(), ptt.numpy(), **FOLD_TOL)
    ms = time_ms(kernel)
    plain_ms = time_ms(plain)
    tflops = 8 * cmacs / (ms * 1e-3) / 1e12
    t = timing(ms, plain_ms, 8 * cmacs, nbytes)
    lags = ("lags equal" if not n_diff else
            f"lags equal but in {n_diff} near-tie cells of {diff.numel()}")
    log(f"{name} {label}: {desc} {lags}, max |dpeak| {err:.4e} of "
        f"peaks up to {float(ppk.max()):.4e}, max rel err {rel:.3e} (rtol "
        f"{FOLD_TOL['rtol']}), kernel {ms:.3f} ms ({tflops:.1f} TFLOP/s), "
        f"plain {plain_ms:.3f} ms, {bound_text(t)}")
    return dict(max_abs_err=err, max_rel_err=rel, **t)


def check_fold(fs, rows, n_acc, dev, label, prns=ALL_PRNS):
    from tpu_gnss_torch.ops import mxu_corr as mc
    args, kw = fold_case(fs, rows, n_acc, dev, seed=rows + n_acc, prns=prns)
    n_sv = len(prns)
    t = mc.four_step_np(kw["nf"], kw["period"])
    inv, fwd = four_step_cmacs(t["n1"], t["n2"], t["q_cols"], t["u_rows"])
    nbytes = (sum(a.numel() for a in args) * 4     # x and code planes
              + rows * n_sv * 12)                  # peak, lag, total
    return compare_reduce(
        "fold_corr_reduce", label,
        lambda: mc.fold_corr_reduce(*args, **kw),
        lambda: mc.fold_corr_reduce_plain(*args, **kw),
        f"rows={rows} n_sv={n_sv} nf={kw['nf']} ({t['n1']}x{t['n2']}) "
        f"u_rows={t['u_rows']} q_cols={t['q_cols']} n_acc={n_acc}",
        rows * n_acc * (fwd + n_sv * inv), nbytes)


def track_case(fs, dev, spacing=0.5):
    """``(args, kw)`` of one tracking step at rate ``fs``: 10 epochs x 12
    channels of SVs at integer-sample code shifts and random Dopplers, the
    first two at the period edges so the early/late taps (``spacing``
    chips from the prompt) wrap."""
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
    d = spacing * p / 1023.0            # early/late tap offset, samples
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
    return args, dict(period=p, nf=nf, dsamp=d)


def check_track(fs, dev, label, spacing=0.5):
    from tpu_gnss_torch.ops import mxu_track as mt
    from tpu_gnss_torch.ops.mxu_corr import four_step_np
    args, kw = track_case(fs, dev, spacing)
    e_sub, n_chan = args[2].shape[:2]
    nf = kw["nf"]
    got = mt.track_corr(*args, **kw).cpu()
    want = mt.track_corr_plain(*args, **kw).cpu()
    ref = float(torch.hypot(want[..., 0], want[..., 1]).max())
    err = float((got - want).abs().max())
    if not err <= TRACK_ATOL * ref:
        fail(f"track_corr {label}: max err {err} > "
             f"{TRACK_ATOL} x max|P| {ref}")
    ms = time_ms(lambda: mt.track_corr(*args, **kw))
    plain_ms = time_ms(lambda: mt.track_corr_plain(*args, **kw))
    f = four_step_np(nf, kw["period"])
    cmacs = e_sub * n_chan * four_step_cmacs(f["n1"], f["n2"], f["q_cols"],
                                             f["u_rows"])[1]
    nbytes = sum(a.numel() for a in args) * 4 + e_sub * n_chan * 24
    t = timing(ms, plain_ms, 8 * cmacs, nbytes)
    log(f"track_corr {label}: e_sub={e_sub} n_chan={n_chan} nf={nf} "
        f"spacing {spacing} chips "
        f"({f['n1']}x{f['n2']}, u_rows {f['u_rows']}) max err={err:.3e} "
        f"= {err / ref:.2e} x max|P|={ref:.1f} (atol {TRACK_ATOL} x max|P|), "
        f"kernel {ms * 1e3:.2f} us ({8 * cmacs / (ms * 1e-3) / 1e12:.1f} "
        f"TFLOP/s), plain {plain_ms * 1e3:.2f} us, {bound_text(t)}")
    return dict(max_abs_err=err, max_rel_err=err / ref, **t)


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
    nbytes = 8 * n_bits + 4 * -(-n_bits // 32)
    t = timing(ms, plain_ms, 0.0, nbytes)
    log(f"mix_packed {label}: {n_bits} samples ({fs / 1e6:g} Msps), "
        f"lo_rate {lo_rate:g}, phase0 {p0:.9g}: equal to the plain version, "
        f"kernel {ms * 1e3:.2f} us ({nbytes / (ms * 1e-3) / 1e12:.2f} TB/s), "
        f"plain {plain_ms * 1e3:.2f} us, {bound_text(t)}")
    return dict(max_abs_err=0.0, max_rel_err=0.0, **t)


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
        rows * 32 * n_acc * four_step_cmacs(n1, n2, q_cols)[0],
        sum(a.numel() for a in args) * 4 + rows * 32 * 12)


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


def device_busy_ms(fn, calls: int = 5):
    """Device time per call of ``fn``: the summed durations of the CUDA
    kernels and copies ``torch.profiler`` records over ``calls`` calls (a
    CUDA-event span would also count the gaps where the card waits for a
    host-bound caller).  None when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "self_device_time_total", None)
             or getattr(ev, "self_cuda_time_total", 0.0)
             for ev in prof.key_averages())
    return us / 1e3 / calls if us > 0 else None


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

def build_capture(cfg, duration, tmpdir, name, iq8=False):
    """The e2e scene recipe at ``cfg.fs`` written as a 1-bit IF capture
    and, with ``iq8``, from the same baseband as an int8 I/Q capture and
    as the complex baseband itself (``.npy``).  Returns ``(1-bit path,
    int8 path or None, .npy path or None, receiver ECEF)``."""
    from tpu_gnss_torch.signal import scene
    t0 = time.perf_counter()
    iq, _, rx = scene.build_scene(duration=duration, fs=cfg.fs)
    path = os.path.join(tmpdir, f"{name}.bin")
    scene.write_1bit_capture(iq, cfg.fc, cfg.fs, path)
    path8 = path_iq = None
    if iq8:
        path8 = os.path.join(tmpdir, f"{name}_iq8.bin")
        write_iq8(iq, path8)
        path_iq = os.path.join(tmpdir, f"{name}_iq.npy")
        np.save(path_iq, iq)
    del iq
    log(f"{name}: {duration:g} s scene at {cfg.fs / 1e6:g} Msps built in "
        f"{time.perf_counter() - t0:.1f} s")
    return path, path8, path_iq, rx


def run_receiver(cfg, path, duration, name):
    from tpu_gnss_torch.io.stream import FileSource1Bit
    from tpu_gnss_torch.receiver import Receiver
    res, wall, launches, _ = drive(name, Receiver(cfg, device="cuda"),
                                   FileSource1Bit(path, cfg), duration)
    return res, wall, launches


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
    from tpu_gnss_torch.signal import synth
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


# ---------------------------------------------------------------------------
# phase 2b: the host->device links on the card
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def counting_uploads():
    """Collect the byte count of every host->device upload the links make
    (``tpu_gnss_torch.utils.xfer._upload``) while the block runs."""
    from tpu_gnss_torch.utils import xfer
    sent, real = [], xfer._upload

    def spy(a, device):
        sent.append(np.asarray(a).nbytes)
        return real(a, device)

    xfer._upload = spy
    try:
        yield sent
    finally:
        xfer._upload = real


def _np_remove_dc(re, im, remove_dc):
    if remove_dc:
        re, im = re - re.mean(), im - im.mean()
    return (re + 1j * im).astype(np.complex64)


def link_reference(name, data, signed, remove_dc, scale=None) -> np.ndarray:
    """The numpy computation of one link's arithmetic: quantize as the host
    half does, then dequantize in float32 as the device half does."""
    from tpu_gnss_torch.utils import xfer
    f32 = np.float32
    if name == "int8":
        q = lambda a: np.clip(np.rint(a * scale), -127, 127).astype(np.int8)
        inv = f32(1.0 / scale)
        return _np_remove_dc(q(data.real).astype(f32) * inv,
                             q(data.imag).astype(f32) * inv, False)
    if name == "int4":
        q = lambda a: np.clip(np.rint(a * scale), -7, 7).astype(f32)
        inv = f32(1.0 / scale)
        return _np_remove_dc(q(data.real) * inv, q(data.imag) * inv, False)
    v = data.astype(f32) - (0.0 if signed else 128.0)
    rms = float(np.sqrt(np.mean(np.square(v[:65536]))))
    if name == "iq8":
        return _np_remove_dc(v[0::2], v[1::2], remove_dc)
    if name == "iq4":
        s4 = 7.0 / (3.0 * rms)
        q = np.clip(np.rint(v * s4), -7, 7)
        inv = f32(1.0 / s4)
        return _np_remove_dc(q[0::2].astype(f32) * inv,
                             q[1::2].astype(f32) * inv, remove_dc)
    # iq2: levels +-1, +-3 x rms / 1.887 at a one-RMS threshold
    step = f32(rms / xfer._I2_RMS_DIV)
    lvl = (np.where(np.abs(v) >= rms, f32(3), f32(1))
           * np.where(v < 0, f32(-1), f32(1))) * step
    return _np_remove_dc(lvl[0::2], lvl[1::2], remove_dc)


def check_links(dev, n: int = 1 << 20) -> None:
    """Each device dequantizer on seeded data against
    :func:`link_reference`: the int8 and int4 planes of a complex array
    equal, the capture-byte links (iq8, iq4, iq2, DC removed) within
    1e-6 x max|x|.  Then each link's upload + dequantize time for ``n``
    samples (host wall, synchronised) and its bytes per sample."""
    import functools
    from tpu_gnss_torch.utils import xfer
    rng = np.random.default_rng(21)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n) + 0.2
         ).astype(np.complex64)
    rms = float(np.sqrt(np.mean(np.abs(x[:65536]) ** 2)))
    s8, s4 = 127.0 / (6.0 * rms), 7.0 / (3.0 * rms)
    # (label, upload, numpy result, DC removed)
    cases = [("int8", lambda: xfer.to_device_complex_i8(x, s8, dev),
              link_reference("int8", x, True, False, s8), False),
             ("int4", lambda: xfer.to_device_complex_i4(x, s4, dev),
              link_reference("int4", x, True, False, s4), False)]
    for signed, raw in ((True, rng.integers(-100, 100, 2 * n).astype(np.int8)),
                        (False, rng.integers(10, 250, 2 * n).astype(np.uint8))):
        for link in ("iq8", "iq4", "iq2"):
            cases.append((
                f"{link} {raw.dtype}",
                functools.partial(getattr(xfer, f"to_device_{link}"), raw,
                                  signed=signed, remove_dc=True, device=dev),
                link_reference(link, raw, signed, True), True))
    for label, run, want, remove_dc in cases:
        got = run().cpu()
        want = torch.from_numpy(want)
        if remove_dc:
            err = float((got - want).abs().max())
            tol = 1e-6 * float(want.abs().max())
            if not err <= tol:
                fail(f"link {label}: max err {err} > {tol}")
            verdict = f"max err {err:.3e} <= 1e-6 x max|x| = {tol:.3e}"
        else:
            if not torch.equal(got, want):
                fail(f"link {label}: {int((got != want).sum())} samples "
                     "differ from the numpy dequantization")
            verdict = "equal to the numpy dequantization"
        with counting_uploads() as sent:
            run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 5 * 1e3
        log(f"link {label}: {n} samples, {verdict}, "
            f"{sum(sent) / n:g} B/sample uploaded, upload + dequantize "
            f"{ms:.3f} ms (host wall)")


# ---------------------------------------------------------------------------
# phases 8-12: the 8-bit I/Q path, the links, live mode, the gather path
# ---------------------------------------------------------------------------

def write_iq8(iq, path, signed=True, offset_hz=0.0, fs=None):
    """Interleaved 8-bit I/Q capture of ``iq`` (x100 of the larger rail's
    peak), optionally mixed by a common ``offset_hz`` first (a replay
    capture's TX/RX oscillator offset), in 4 M-sample segments."""
    seg = 1 << 22
    peak = max(float(np.abs(iq.real).max()), float(np.abs(iq.imag).max()))
    # a rotation can carry up to sqrt(2) x the larger rail's peak onto one
    # rail: keep the rotated samples inside int8 too
    scale = 100.0 / (peak * (1.0 if offset_hz == 0.0 else np.sqrt(2.0)))
    with open(path, "wb") as f:
        for s0 in range(0, len(iq), seg):
            x = iq[s0: s0 + seg]
            if offset_hz:
                n = np.arange(s0, s0 + len(x), dtype=np.float64)
                x = x * np.exp(2j * np.pi * ((offset_hz * n / fs) % 1.0))
            raw = np.empty(2 * len(x), np.int16)
            raw[0::2] = np.clip(np.rint(x.real * scale), -127, 127)
            raw[1::2] = np.clip(np.rint(x.imag * scale), -127, 127)
            (raw.astype(np.int8) if signed
             else (raw + 128).astype(np.uint8)).tofile(f)


RECEIVER_KERNELS = ("fold_corr_reduce", "track_corr", "mix_packed",
                    "loop_update")


def drive(name, recv, src, duration, **kw):
    """One main-path run: counts set to 0 just before, read just after.
    Returns ``(result, wall s, launches, receiver.transfer s)``."""
    from tpu_gnss_torch import kernels
    from tpu_gnss_torch.utils.metrics import METRICS
    xfer_before = sum(METRICS.timings.get("receiver.transfer", []))
    torch.cuda.synchronize()
    kernels.LAUNCHES.reset()
    t0 = time.perf_counter()
    res = recv.process_source(src, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: kernels.LAUNCHES.get(k) for k in RECEIVER_KERNELS}
    xfer_s = sum(METRICS.timings.get("receiver.transfer", [])) - xfer_before
    log(f"{name}: wall {wall:.3f} s for {duration:g} s of signal, realtime "
        f"factor {duration / wall:.2f}, receiver.transfer {xfer_s:.3f} s, "
        f"launches {launches}")
    return res, wall, launches, xfer_s


def need_launched(name, launches, kernels_of_path):
    for k in kernels_of_path:
        if launches[k] <= 0:
            fail(f"{name}: kernel {k} was never launched on the path")


def pos_error(sol, rx) -> float:
    return float(np.linalg.norm(np.array([sol.x, sol.y, sol.z])
                                - np.array(rx)))


def fix_error(res, rx) -> float:
    return pos_error(res.solutions[-1], rx) if res.solutions else float("nan")


def locked_prns(res, min_epochs=2000):
    from tpu_gnss_torch.track.quality import pll_lock_metric
    return sorted(r.prn for r in res.channels
                  if not r.lost and r.n_epochs >= min_epochs
                  and pll_lock_metric(r.ip_hist, r.qp_hist, 1000) > 0.45)


def iq_scene(preset, duration, offset_hz, signed, tmpdir):
    """A ``duration`` s, 6-SV scene at a capture preset's width written as
    8-bit I/Q with a common ``offset_hz``: ``(cfg, path, fmt, true sky
    Dopplers)``."""
    from tpu_gnss_torch import PRESETS
    from tpu_gnss_torch.signal import scene
    cfg = PRESETS[preset]
    t0 = time.perf_counter()
    iq, ephs, rx = scene.build_scene(duration=duration, fs=cfg.fs)
    path = os.path.join(tmpdir, f"{preset}.bin")
    write_iq8(iq, path, signed=signed, offset_hz=offset_hz, fs=cfg.fs)
    del iq
    true = scene.sky_dopplers_hz(ephs, rx)
    fmt = "int8" if signed else "uint8"
    log(f"{preset}: {duration:g} s, 6-SV {fmt} I/Q scene at "
        f"{cfg.fs / 1e6:g} Msps, {offset_hz:+g} Hz common offset, built in "
        f"{time.perf_counter() - t0:.1f} s; true sky Dopplers "
        f"{np.round(true, 1).tolist()} Hz")
    return cfg, path, fmt, true


def iq_link_run(label, cfg, path, fmt, true, offset_hz, duration, link, dev,
                mesh=None):
    """One run of an I/Q scene over one link (on ``mesh`` if given): >= 4
    detections, those channels locked, the oscillator-offset estimate
    within 250 Hz of ``offset_hz`` plus the detected SVs' true median
    Doppler."""
    from tpu_gnss_torch.io.stream import IQFileSource
    from tpu_gnss_torch.receiver import Receiver
    recv = Receiver(cfg, transfer_dtype=link, mesh=mesh, device=dev)
    with counting_uploads() as sent:
        res, wall, launches, xfer_s = drive(
            label, recv, IQFileSource(path, cfg.fs, fmt), duration)
    det = iq_gates(label, recv, res, launches, true, offset_hz,
                   f", {sum(sent) / duration / 1e6:.3f} MB uploaded per "
                   "second of signal")
    return dict(det=det, res=res, wall=wall, launches=launches,
                transfer_s=xfer_s, bytes_per_s=sum(sent) / duration)


def iq_gates(label, recv, res, launches, true, offset_hz, note=""):
    """:func:`iq_link_run`'s gates on one run; returns the detected
    PRNs."""
    det = sorted(d["prn"] for d in res.detections)
    locked = locked_prns(res)
    want_off = offset_hz + float(np.median(
        [true[p - 2] for p in det if 2 <= p < 2 + len(true)]))
    log(f"{label}: {len(det)} detections {det}, locked {locked}, if_offset "
        f"estimate {recv._if_offset:.1f} Hz (want {want_off:.1f}){note}")
    need_launched(label, launches, ("fold_corr_reduce", "track_corr",
                                    "loop_update"))
    if len(det) < 4 or not set(det) <= set(locked):
        fail(f"{label}: fewer than 4 detections, or detected channels not "
             "locked")
    if not abs(recv._if_offset - want_off) < 250.0:
        fail(f"{label}: if_offset estimate {recv._if_offset} Hz, want "
             f"{want_off} +- 250 Hz")
    return det


def iq_preset_run(preset, duration, offset_hz, signed, links, tmpdir, dev):
    """Phases 9-10: a ``duration`` s, 6-SV scene at a capture preset's
    width (all 32 PRNs, +-100 kHz), written as 8-bit I/Q with a common
    ``offset_hz``, through ``IQFileSource`` once per link
    (:func:`iq_link_run`'s gates), every link detecting the same PRNs as
    the first; int4 and int2 must meet the reference's bars against int8
    (tests/test_stream.py:494-537): the whole prompt history, no sign
    allowance, and for int2 the NAV-bit signs after the 200-epoch pull-in.
    The JAX receiver keeps one Costas phase on every link of this scene,
    as the port does (tests/test_torch_link_flip.py).  Returns the runs
    and the scene."""
    cfg, path, fmt, true = iq_scene(preset, duration, offset_hz, signed,
                                    tmpdir)
    runs = {}
    for link in links:
        runs[link] = iq_link_run(f"{preset} {link}", cfg, path, fmt, true,
                                 offset_hz, duration, link, dev)
        if runs[link]["det"] != runs[links[0]]["det"]:
            fail(f"{preset} {link}: PRNs {runs[link]['det']} differ from the "
                 "first link's")
    base = runs[links[0]]["res"]
    for link, bar in (("int4", 0.05), ("int2", 0.25)):
        if link not in runs:
            continue
        for a, b in zip(runs[link]["res"].channels, base.channels):
            if (a.prn, a.start_epoch) != (b.prn, b.start_epoch):
                fail(f"{preset} {link}: channel {a.ch} differs from int8")
            rel = float(np.linalg.norm(a.ip_hist - b.ip_hist)
                        / np.linalg.norm(b.ip_hist))
            ia, ib = a.ip_hist[200:], b.ip_hist[200:]
            sign = float(np.mean(np.sign(ia) == np.sign(ib)))
            log(f"  {link} PRN {a.prn}: prompt rel {rel:.4f} over the whole "
                f"history (bar {bar}), sign agreement after epoch 200 "
                f"{sign:.4f}"
                + (" (locked at the other Costas half-cycle)"
                   if float(np.dot(ia, ib)) < 0 else ""))
            if not rel < bar or (link == "int2" and not sign > 0.98):
                fail(f"{preset} {link} PRN {a.prn}: prompt rel {rel}, sign "
                     f"agreement {sign}")
    return runs, (cfg, path, fmt, true)


def live_run(cfg, path, rx, duration, tmpdir, dev):
    """Phase 11: a writer thread grows the 1-bit capture at 4x real time;
    ``FollowSource1Bit`` with ``on_solution``, ``max_history_s=600`` and a
    ``.done`` sidecar must deliver a fix through the callback before
    ``process_source`` returns, the last within 60 m."""
    import threading
    from tpu_gnss_torch.io.stream import FollowSource1Bit
    from tpu_gnss_torch.receiver import Receiver
    live = os.path.join(tmpdir, "live.bin")
    open(live, "wb").close()
    data = open(path, "rb").read()
    step = int(cfg.fs / 8)            # one second of signal
    stop = threading.Event()

    def writer():
        with open(live, "ab") as f:
            for i in range(0, len(data), step):
                if stop.is_set():
                    return
                f.write(data[i: i + step])
                f.flush()
                time.sleep(0.25)
        open(live + ".done", "w").close()

    fixes = []
    returned = threading.Event()

    def on_solution(sol):
        fixes.append((sol, returned.is_set()))
        log(f"  live fix at t={sol.snap_epoch / 1000:.1f} s: {sol.n_sats} "
            f"SVs, error {pos_error(sol, rx):.2f} m")

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    src = FollowSource1Bit(live, cfg, stall_timeout_s=30.0)
    try:
        res, wall, launches, _ = drive(
            "live", Receiver(cfg, max_history_s=600.0, device=dev), src,
            duration, on_solution=on_solution)
    finally:
        returned.set()
        stop.set()
        t.join()
    in_stream = [s for s, late in fixes if not late]
    err = fix_error(res, rx)
    log(f"live: {len(in_stream)} fixes through on_solution before "
        f"process_source returned, stalled={src.stalled}, final error "
        f"{err:.2f} m")
    need_launched("live", launches, RECEIVER_KERNELS)
    if src.stalled or not in_stream:
        fail("live: no fix delivered in-stream, or the follow stalled")
    if not err < 60.0:
        fail(f"live: final fix error {err} m (limit 60 m)")
    return launches


def gather_run(cfg, path, dev, duration=4.0):
    """Phase 12: the gather correlator (``fft_correlator=False``) on the
    first ``duration`` s of the e2e capture locks the channels the FFT
    path locks."""
    from tpu_gnss_torch.io.stream import FileSource1Bit
    from tpu_gnss_torch.receiver import Receiver
    out = {}
    for name, fft in (("fft", True), ("gather", False)):
        res, _, launches, _ = drive(
            f"e2e {duration:g} s {name}",
            Receiver(cfg, fft_correlator=fft, device=dev),
            FileSource1Bit(path, cfg), duration, max_duration_s=duration)
        need_launched(name, launches, ("fold_corr_reduce", "mix_packed",
                                       "loop_update")
                      + (("track_corr",) if fft else ()))
        if not fft and launches["track_corr"]:
            fail("gather: track_corr launched on the gather path")
        out[name] = locked_prns(res)
    log(f"gather: locked {out['gather']}, FFT path locked {out['fft']}")
    if len(out["fft"]) < 4 or out["gather"] != out["fft"]:
        fail("gather: locked channels differ from the FFT path's")


# ---------------------------------------------------------------------------
# phase 13: gps_test on the card
# ---------------------------------------------------------------------------

# tests/test_acquire.py:150-152: (prn, lo_shift, ca_shift) of the
# Nottingham capture's published table
NOTT_GOLDEN = ((1, 6, 1465), (21, 8, 686), (29, -9, 3868), (30, -9, 2998),
               (31, -8, 2337))
GPS_TEST_RTOL = 2e-3    # SNR, the bar of tests/test_acquire.py:47


GPS_TEST_CMP_RUNS = 2   # runs held card against CPU and printed by main
GPS_TEST_TIME_RUNS = 6  # card runs per mode: the first, then 5 timed


def golden_capture(cfg, tmpdir) -> str:
    """tests/test_acquire.py:140-168's synthetic reconstruction of the
    Nottingham capture (5 SVs at the golden Doppler bins and code phases,
    noise 1.5, seed 29), written as a 1-bit capture GPS_TEST_TIME_RUNS
    compat runs long."""
    from tpu_gnss_torch.cli.search_runner import block_stride_samples
    from tpu_gnss_torch.io import loaders
    from tpu_gnss_torch.signal import synth
    n = GPS_TEST_TIME_RUNS * len(cfg.prns) * block_stride_samples(cfg.fft_len)
    iq = synth.synth_baseband(
        [synth.SvSignal(prn=p, doppler_hz=lo * cfg.dop_bin_hz,
                        code_phase_chips=ca * 1023.0 / cfg.lags)
         for p, lo, ca in NOTT_GOLDEN], cfg.fs, n, noise_std=1.5, seed=29)
    path = os.path.join(tmpdir, "nottingham_golden.bin")
    with open(path, "wb") as f:
        f.write(loaders.pack_1bit(synth.baseband_to_1bit_if(iq, cfg.fc,
                                                              cfg.fs)))
    return path


def parse_tables(out: str) -> list:
    """Per run of a gps_test table: the satellite / lo_shift / ca_shift
    rows, the SNR row and the all-PRN SNR row."""
    lines = out.splitlines()
    runs = []
    for i, ln in enumerate(lines):
        if "satellite:" in ln:
            row = lambda k: lines[i + k].split(":", 1)[1].split()
            runs.append(dict(sv=[int(x) for x in row(0)],
                             snr=[float(x) for x in row(1)],
                             lo=[int(x) for x in row(2)],
                             ca=[int(x) for x in row(3)],
                             all_snr=[float(x) for x in lines[i + 4].split()]))
    return runs


def hit_rows(run: dict) -> tuple:
    """A run's satellite, lo_shift and ca_shift rows (its table's integer
    rows) from ``run_capture``'s detections."""
    return tuple([h[k] for h in run["hits"]]
                 for k in ("sv", "lo_shift", "ca_shift"))


def gps_test_phase(tmpdir, dev):
    """Phase 13: the port's ``run_capture`` in all three modes on the
    card (GPS_TEST_TIME_RUNS runs, launch counts and walls from that run),
    then on the CPU (GPS_TEST_CMP_RUNS runs) in the same process.  Its
    first runs agree: satellite, lo_shift and ca_shift rows equal, and
    every PRN's unrounded SNR within GPS_TEST_RTOL, FOLD_TOL for the
    folded mode, whose card run is the TF32 kernel and whose CPU run the
    FFT grid engine.  ``gps_test.main`` on the card prints those rows.
    Native run 0 gives the golden table.  Each mode's wall per run is the
    median of the runs after the first, with its spread."""
    import io
    from tpu_gnss_torch import PRESETS, kernels
    from tpu_gnss_torch.acquire.folded import FoldedSearcher
    from tpu_gnss_torch.acquire.search import _first_argmax
    from tpu_gnss_torch.cli import gps_test
    from tpu_gnss_torch.cli.search_runner import run_capture
    cfg = PRESETS["nottingham"]
    path = golden_capture(cfg, tmpdir)
    n_cmp, n_time = GPS_TEST_CMP_RUNS, GPS_TEST_TIME_RUNS

    folded = FoldedSearcher(cfg, device=dev)
    n_dop = {"compat": cfg.num_dop_bins, "native": cfg.num_dop_bins,
             "folded": len(folded.dops_hz)}
    block = {"compat": len(cfg.prns) * cfg.fft_len, "native": cfg.fft_len,
             "folded": folded.block_len}
    prns_per_sample = {"compat": 1, "native": 32, "folded": 32}
    out = {}
    for mode in ("compat", "native", "folded"):
        torch.cuda.synchronize()
        kernels.LAUNCHES.reset()
        walls, card = [], []
        t0 = time.perf_counter()
        for run in run_capture(path, cfg, mode, max_runs=n_time, device=dev):
            walls.append(time.perf_counter() - t0)
            card.append(run)
            t0 = time.perf_counter()
        torch.cuda.synchronize()
        launches = {k: kernels.LAUNCHES.get(k) for k in RECEIVER_KERNELS}
        cpu = list(run_capture(path, cfg, mode, max_runs=n_cmp,
                               device="cpu"))
        if len(card) != n_time or len(cpu) != n_cmp:
            fail(f"gps_test {mode}: {len(card)} card runs, {len(cpu)} CPU "
                 f"runs, want {n_time} and {n_cmp}")
        for r, (a, b) in enumerate(zip(card, cpu)):
            if hit_rows(a) != hit_rows(b):
                fail(f"gps_test {mode} run {r}: card rows {hit_rows(a)} "
                     f"differ from the CPU's {hit_rows(b)}")
        rtol = FOLD_TOL["rtol"] if mode == "folded" else GPS_TEST_RTOL
        a = np.stack([run["all_snr"] for run in card[:n_cmp]])
        b = np.stack([run["all_snr"] for run in cpu])
        worst = float((np.abs(a - b) / np.abs(b)).max())
        if not worst <= rtol:
            fail(f"gps_test {mode}: SNR rel diff {worst} card against CPU "
                 f"(rtol {rtol})")
        # the entry point prints the same rows
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = gps_test.main([path, "--mode", mode, "--max-runs",
                                str(n_cmp), "--device", "cuda"])
        printed = parse_tables(buf.getvalue())
        if rc or [(t["sv"], t["lo"], t["ca"]) for t in printed] != \
                [hit_rows(run) for run in card[:n_cmp]]:
            fail(f"gps_test {mode}: main on the card (exit code {rc}) "
                 f"printed {printed}, run_capture gave "
                 f"{[hit_rows(run) for run in card[:n_cmp]]}")
        timed = walls[1:]
        wall = float(np.median(timed))
        cells = block[mode] * prns_per_sample[mode] * n_dop[mode]
        rate = cells / wall / 1e6
        log(f"gps_test {mode}: {n_cmp} runs, card and CPU tables agree "
            f"(max SNR rel diff {worst:.2e}, rtol {rtol}), main prints them; "
            f"SVs {[s + 1 for s in hit_rows(card[0])[0]]}"
            f", wall per run {walls[0]:.4f} s first, median of the next "
            f"{len(timed)} {wall:.5f} s (min {min(timed):.5f}, max "
            f"{max(timed):.5f}) = {rate:.1f} Msample*PRN*bin/s; launches "
            f"{launches}")
        out[mode] = dict(launches=launches, wall_s=wall, rate=rate,
                         rows=[hit_rows(run) for run in card])
    got = {sv + 1: (lo, ca) for sv, lo, ca in zip(*out["native"]["rows"][0])}
    for prn, lo, ca in NOTT_GOLDEN:
        if prn not in got or got[prn][0] != lo or abs(got[prn][1] - ca) > 1:
            fail(f"gps_test native run 0: PRN {prn} gives {got.get(prn)}, "
                 f"golden ({lo}, {ca})")
    log("gps_test native run 0: the golden (prn, lo_shift, ca_shift) table")
    need_launched("gps_test folded", out["folded"]["launches"],
                  ("fold_corr_reduce",))
    # torch.argmax on the card: first of equal maxima (the searcher breaks
    # ties explicitly all the same)
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0], [5.0] * 4, [0.0, 7.0, 2.0, 7.0]],
                     device=dev).repeat(1000, 1)
    am, fm = x.argmax(-1), _first_argmax(x)
    log(f"torch.argmax on the card, equal maxima: first one "
        f"{bool(torch.equal(am, fm))} ({am[:3].tolist()}); explicit tie-break "
        f"{fm[:3].tolist()}")
    if fm[:3].tolist() != [1, 0, 1]:
        fail("explicit first-maximum tie-break wrong on the card")
    return out


# ---------------------------------------------------------------------------
# phase 14: warm start on the card
# ---------------------------------------------------------------------------

DIRECTED = [2, 3, 4, 5, 6]


def cli_run(argv):
    """The port's receiver CLI in-process; its stdout and launch counts
    (set to 0 just before)."""
    import io
    from tpu_gnss_torch import kernels
    from tpu_gnss_torch.cli import run_receiver as cli
    buf = io.StringIO()
    torch.cuda.synchronize()
    kernels.LAUNCHES.reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc:
        fail(f"run_receiver {argv}: exit code {rc}")
    return (buf.getvalue(), {k: kernels.LAUNCHES.get(k)
                             for k in RECEIVER_KERNELS}, wall)


def cli_fix_error(out: str, rx) -> float:
    """Error of the last fix row the CLI printed (n_sats, iters, t_bias,
    lat, lon, alt[, velocity]) against the truth; nan without a fix."""
    from tpu_gnss_torch.pvt.solve import geodetic_to_ecef
    lines = out.splitlines()
    i = next((k for k, ln in enumerate(lines) if ln.startswith("fixes (")),
             None)
    last = None
    for ln in lines[i + 1:] if i is not None else []:
        parts = ln.split(",")
        if len(parts) < 6:          # the DMS page follows the fix rows
            break
        last = parts
    if last is None:
        return float("nan")
    lla = (float(last[3]), float(last[4]), float(last[5].split()[0]))
    return float(np.linalg.norm(np.array(geodetic_to_ecef(*lla))
                                - np.array(rx)))


def first_fix_seconds(cfg, path, rx, seconds, dev, **kw):
    """The shortest capture, among ``seconds``, from which the receiver
    fixes within 150 m (batch mode decodes all of a capture before it
    solves, so a fix at an early snapshot of a long run may lean on NAV
    data from later: only a run cut at ``max_duration_s`` shows what that
    much signal gives).  ``(seconds, launches)``, or ``(None, None)``."""
    from tpu_gnss_torch.io.stream import FileSource1Bit
    from tpu_gnss_torch.receiver import Receiver
    for t in seconds:
        res, _, launches, _ = drive(
            f"first fix {t:g} s{' warm' if kw else ' cold'}",
            Receiver(cfg, device=dev), FileSource1Bit(path, cfg), t,
            max_duration_s=t, **kw)
        if res.solutions and fix_error(res, rx) < 150.0:
            return t, launches
    return None, None


def warm_start_phase(cfg, path, rx, tmpdir, dev):
    """Phase 14: the CLI writes a checkpoint from the 20 s e2e capture;
    ``--warm-start`` with ``--tow`` pinned on its first 8 s prints the
    directed-search line and fixes within 150 m (tests/test_e2e.py:260);
    ``process_source(warm_ephemerides=, search_prns=[2, 3, 4, 5, 6])`` on
    8 s keeps its detections in the subset, fixes within 150 m and
    launches every receiver kernel.  Then the seconds of signal the first
    fix needs, cold against warm (directed), and the cold search's device
    time for the directed set against all 32 PRNs."""
    from tpu_gnss_torch.acquire.folded import (FoldedSearcher,
                                               acquire_refined_mxu)
    from tpu_gnss_torch.io import loaders
    from tpu_gnss_torch.io.stream import FileSource1Bit
    from tpu_gnss_torch.receiver import Receiver
    from tpu_gnss_torch.signal.scene import T_OE
    from tpu_gnss_torch.utils.checkpoint import load_state
    import dataclasses
    ckpt = os.path.join(tmpdir, "e2e_state.npz")
    argv = [path, str(cfg.fc), str(cfg.fs), "5000", "--fft-len",
            str(cfg.fft_len), "--threshold", str(cfg.snr_threshold),
            "--device", "cuda"]
    out, launches_ck, wall = cli_run(argv + ["--checkpoint", ckpt])
    state = load_state(ckpt, device=dev)
    saved = next((ln for ln in out.splitlines()
                  if ln.startswith("state saved to")), None)
    log(f"warm start: CLI cold run with --checkpoint, wall {wall:.3f} s, "
        f"{saved!r}; ephemerides {sorted(state.get('ephemerides', {}))}, "
        f"almanac {sorted(state.get('almanac', {}))}, launches {launches_ck}")
    if saved is None or len(state.get("ephemerides", {})) < 4 \
            or "last_fix" not in state.get("meta", {}):
        fail("warm start: the checkpoint lacks ephemerides or a last fix")
    need_launched("CLI --checkpoint", launches_ck, RECEIVER_KERNELS)
    out_w, launches_cw, wall_w = cli_run(
        argv + ["--duration", "8", "--warm-start", ckpt,
                "--tow", str(T_OE + 90.0)])
    line = next((ln for ln in out_w.splitlines()
                 if ln.startswith("directed search:")), None)
    err_cli = cli_fix_error(out_w, rx)
    log(f"warm start: CLI --warm-start --tow {T_OE + 90.0:g} on 8 s, wall "
        f"{wall_w:.3f} s, {line!r}, last fix error {err_cli:.2f} m, "
        f"launches {launches_cw}")
    if line is None or not err_cli < 150.0:
        fail("warm start: no directed-search line, or no fix within 150 m "
             "in 8 s")
    need_launched("CLI --warm-start", launches_cw, RECEIVER_KERNELS)
    recv = Receiver(cfg, device=dev)
    res, wall_r, launches, _ = drive(
        "warm 8 s directed", recv, FileSource1Bit(path, cfg), 8.0,
        max_duration_s=8.0, warm_ephemerides=state["ephemerides"],
        search_prns=DIRECTED)
    det = sorted(d["prn"] for d in res.detections)
    err = fix_error(res, rx)
    log(f"warm 8 s directed: detections {det} (subset {DIRECTED}), "
        f"{len(res.solutions)} fixes, last error {err:.2f} m, directed "
        f"searcher retired {recv._searcher_directed is None}")
    if not det or not set(det) <= set(DIRECTED) or not err < 150.0 \
            or recv._searcher_directed is not None:
        fail("warm start: detections outside the directed subset, no fix "
             "within 150 m, or the directed searcher not retired")
    need_launched("warm 8 s directed", launches, RECEIVER_KERNELS)
    ttff_cold, _ = first_fix_seconds(cfg, path, rx, (12, 14, 16, 18, 20),
                                     dev)
    ttff_warm, _ = first_fix_seconds(
        cfg, path, rx, (3, 4, 5, 6, 7, 8), dev,
        warm_ephemerides=state["ephemerides"], search_prns=DIRECTED)
    if ttff_cold is None or ttff_warm is None:
        fail(f"warm start: first fix cold {ttff_cold} s, warm {ttff_warm} s")
    # the cold search (kernel grid reduce + refine, one block) on the
    # capture's head, for the directed subset and for all 32 PRNs: its
    # device time, and its wall per call with the host's launches
    searchers = {
        "directed 5": FoldedSearcher(
            dataclasses.replace(cfg, prns=tuple(DIRECTED)), device=dev),
        "all 32": FoldedSearcher(cfg, device=dev)}
    n_head = searchers["all 32"].block_len
    with open(path, "rb") as f:
        bits = loaders.unpack_1bit(f.read(-(-n_head // 8)))[:n_head]
    head = torch.from_numpy(bits).to(dev)
    times = {}
    for name, s in searchers.items():
        c = s.cfg
        cw_r, cw_i = s.mxu_code_planes()
        busy = device_busy_ms(lambda: acquire_refined_mxu(
            head, cw_r, cw_i, s.code_ffts_p, s.dops_hz, fs=c.fs,
            lo_rate=c.lo_rate, n_coherent=s.n_coherent, from_bits=True,
            period=s.period, nf=s.nf))
        s.detections_refined_fast(bits=bits)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            s.detections_refined_fast(bits=bits)
        times[name] = dict(device_ms=busy,
                           wall_ms=(time.perf_counter() - t0) * 100.0)
    fmt = lambda t: ("not measured" if t["device_ms"] is None
                     else f"{t['device_ms']:.3f} ms") + \
        f" of device time, {t['wall_ms']:.3f} ms wall"
    log(f"warm start: the first fix needs {ttff_warm:g} s of signal warm "
        f"(directed) against {ttff_cold:g} s cold; the cold search takes "
        f"{fmt(times['directed 5'])} for the 5 directed PRNs against "
        f"{fmt(times['all 32'])} for all 32")
    return dict(launches=launches, launches_cli=launches_cw,
                launches_checkpoint=launches_ck, ttff_cold=ttff_cold,
                ttff_warm=ttff_warm, search_ms=times)


# ---------------------------------------------------------------------------
# phase 15: the mesh on the card
# ---------------------------------------------------------------------------

def one_card_mesh(dev, n):
    """``n`` logical shards of one card on the "dop" axis."""
    from tpu_gnss_torch.dist.shard import Mesh
    return Mesh([dev] * n, ("dop",))


def check_refined_sharded(cfg, label, dev, meshes):
    """``acquire_refined_sharded`` on each mesh of ``meshes`` against
    ``acquire_refined_mxu`` on one 4 ms block of a 6-SV complex scene:
    the same ``[3, n_sv]`` stack.  First the per-row check: each shard's
    Doppler slice launched alone against the same rows of the full-grid
    launch, bit for bit; rows that differ are held to phase 2's near-tie
    rule, and so are SVs whose best Doppler then differs.  Then the
    device time of each search.  Returns ``{mesh label: device ms}``."""
    from tpu_gnss_torch.acquire import folded as F
    from tpu_gnss_torch.dist.shard import acquire_refined_sharded, pad_dops
    from tpu_gnss_torch.signal import synth
    s = F.FoldedSearcher(cfg, device=dev)
    iq = synth.synth_baseband(
        [synth.SvSignal(prn=p, doppler_hz=d, code_phase_chips=c, amplitude=a)
         for p, d, c, a in SEARCH_SVS], cfg.fs, s.block_len, noise_std=1.0,
        seed=15)
    x = torch.from_numpy(iq).to(dev)
    cw_r, cw_i = s.mxu_code_planes()
    kw = dict(fs=cfg.fs, lo_rate=cfg.lo_rate, n_coherent=s.n_coherent,
              period=s.period, nf=s.nf, from_bits=False)
    single = lambda: F.acquire_refined_mxu(x, cw_r, cw_i, s.code_ffts_p,
                                           s.dops_hz, **kw)
    want = single().cpu()
    grid = lambda dops: F._corr_reduce_grid_mxu(
        x[None], cw_r, cw_i, dops, fs=cfg.fs, n_coherent=s.n_coherent,
        period=s.period, nf=s.nf, accumulate=True)
    times = {"single": device_busy_ms(single)}
    for name, mesh in meshes.items():
        n = mesh.shape["dop"]
        dops = torch.from_numpy(pad_dops(s.dops_hz.cpu().numpy(), n, 1)
                                ).to(dev)
        full = [t.cpu() for t in grid(dops)]                # [sv, n_pad]
        per = dops.shape[0] // n
        same, tie = 0, 0
        for k in range(n):
            part = [t.cpu() for t in grid(dops[k * per:(k + 1) * per])]
            for r in range(per):
                c = k * per + r
                if all(torch.equal(p[:, r], f[:, c]) for p, f in
                       zip(part, full)):
                    same += 1
                    continue
                pk, fk = part[0][:, r], full[0][:, c]
                if not bool(((pk - fk).abs() <= 2e-3 * fk).all()):
                    fail(f"sharded search {label} {name}: row {c} launched "
                         "alone differs beyond the near-tie rule")
                tie += 1
        got = acquire_refined_sharded(x, cw_r, cw_i, s.code_ffts_p, dops,
                                      mesh=mesh, **kw).cpu()
        eq = torch.equal(got, want)
        if not eq:
            # an SV may settle on another bin only at a near-tie
            snr_f = (full[0] / (full[2] / s.period))[:, :len(s.dops_hz)]
            for sv in range(got.shape[1]):
                if torch.equal(got[:, sv], want[:, sv]):
                    continue
                a, b = snr_f[sv].max(), snr_f[sv].sort().values[-2]
                if not float(a - b) <= 2e-3 * float(a):
                    fail(f"sharded search {label} {name}: SV {sv} "
                         f"{got[:, sv].tolist()} against the single-device "
                         f"{want[:, sv].tolist()}, not a near-tie")
        times[name] = device_busy_ms(lambda: acquire_refined_sharded(
            x, cw_r, cw_i, s.code_ffts_p, dops, mesh=mesh, **kw))
        fmt = lambda t: "not measured" if t is None else f"{t:.3f} ms"
        log(f"sharded search {label} {name}: {len(s.dops_hz)} rows padded to "
            f"{dops.shape[0]}; rows launched alone {same} of "
            f"{dops.shape[0]} bit-identical to the full-grid launch"
            + (f", {tie} within the near-tie rule" if tie else "")
            + f"; stack {'equal to' if eq else 'near-ties apart from'} "
            f"acquire_refined_mxu's; device time {fmt(times[name])} against "
            f"{fmt(times['single'])} single")
    return times


def tracking_bank(fs, dev, eps, steps=10):
    """12 SVs of a synthesized scene at ``fs`` for ``steps`` steps of
    ``eps`` epochs, and a ChannelState seeded on them (code spectra of the
    FFT-dot correlator): ``(samples, state, code_ffts)``."""
    from tpu_gnss_torch.signal import synth
    from tpu_gnss_torch.track import channel as tc
    n_chan = 12
    rng = np.random.default_rng(int(fs) % 997)
    prns = list(range(1, n_chan + 1))
    dops = rng.uniform(-4000, 4000, n_chan)
    chips = rng.uniform(0, 1023, n_chan)
    p = round(fs * 1e-3)
    iq = synth.synth_baseband(
        [synth.SvSignal(prn=q, doppler_hz=d, code_phase_chips=c)
         for q, d, c in zip(prns, dops, chips)], fs, steps * eps * p,
        noise_std=0.5, seed=int(fs) % 991)
    state = tc.start_channels(tc.init_state(n_chan, dev), range(n_chan),
                              dops + rng.uniform(-20, 20, n_chan), chips,
                              dops)
    spec = torch.from_numpy(tc.code_spectra_np(prns, n_chan, fs)).to(dev)
    return torch.from_numpy(iq).to(dev), state, spec


def check_tracker_sharded(fs, label, dev, meshes, eps=10):
    """``make_tracker_sharded`` on each mesh against ``track_epochs``: the
    prompt, early and late outputs within TRACK_ATOL x max|P|, and the
    ``track_corr`` and ``loop_update`` launches per step (each shard's
    first chunk of a shape runs eagerly: one ``track_corr`` a step, one
    ``loop_update`` a step and one more for step 0's parameters)."""
    from tpu_gnss_torch import kernels
    from tpu_gnss_torch.dist.shard import make_tracker_sharded
    from tpu_gnss_torch.track import channel as tc
    x, state, spec = tracking_bank(fs, dev, eps)
    gains = dict(fs=fs, pll_gains=tc.second_order_gains(18.0, t_s=eps * 1e-3),
                 dll_gains=tc.second_order_gains(2.0, t_s=eps * 1e-3),
                 epochs_per_step=eps)
    _, want = tc.track_epochs(x, state, None, code_ffts=spec, **gains)
    steps = x.shape[0] // (round(fs * 1e-3) * eps)
    ref = float(torch.hypot(want.ip, want.qp).max())
    out = {}
    for name, mesh in meshes.items():
        run = make_tracker_sharded(mesh=mesh, axis="dop", **gains)
        torch.cuda.synchronize()
        kernels.LAUNCHES.reset()
        _, got = run(x, state, None, spec)
        torch.cuda.synchronize()
        n = kernels.LAUNCHES.get("track_corr")
        n_loop = kernels.LAUNCHES.get("loop_update")
        err = max(float((g - w).abs().max()) for g, w in
                  zip((got.ip, got.qp, got.e_mag, got.l_mag),
                      (want.ip, want.qp, want.e_mag, want.l_mag)))
        log(f"sharded tracker {label} {name}: {state.active.shape[0]} "
            f"channels, {steps} steps of {eps} epochs, max err {err:.3e} = "
            f"{err / ref:.2e} x max|P|={ref:.1f} (atol {TRACK_ATOL} x "
            f"max|P|), track_corr {n / steps:g} and loop_update "
            f"{n_loop / steps:g} launches per step")
        shards = mesh.shape["dop"]
        if (not err <= TRACK_ATOL * ref or n != steps * shards
                or n_loop != (steps + 1) * shards):
            fail(f"sharded tracker {label} {name}: max err {err}, "
                 f"{n} track_corr and {n_loop} loop_update launches")
        out[name] = dict(max_abs_err=err, launches_per_step=n / steps)
    return out


def profiled_kernels(fn):
    """``(fn(), {name: count})`` of the CUDA kernels and copies ``fn``
    ran, as ``torch.profiler`` records them (graph replays included)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, {ev.key: ev.count for ev in prof.key_averages()
                 if ev.device_type == torch.autograd.DeviceType.CUDA}


def profiled_launches(fn):
    """``(fn(), the CUDA kernels and copies it ran)``, counted by
    ``torch.profiler`` (None when it records no device activity)."""
    out, counts = profiled_kernels(fn)
    return out, (sum(counts.values()) or None)


def mesh_receiver_runs(cfg_e2e, path_e2e, rx, res_e2e, scene9, runs9, dev):
    """The receiver on one-card meshes at full width: phase 3's 20 s e2e
    1-bit capture on 2 shards (phase 3's fix gate and fix epochs), phase
    9's hackrf int8 scene on 4 shards (phase 9's gates and PRNs), each
    with its wall, realtime factor, launch counts and all CUDA launches
    per 10 ms step (profiled run after the timed one)."""
    from tpu_gnss_torch.io.stream import FileSource1Bit
    from tpu_gnss_torch.receiver import Receiver
    out = {}
    mesh2 = one_card_mesh(dev, 2)
    res, wall, launches, _ = drive(
        "e2e 1-bit 20 s, mesh of 2 shards",
        Receiver(cfg_e2e, mesh=mesh2, device=dev),
        FileSource1Bit(path_e2e, cfg_e2e), 20.0)
    decoded = [r for r in res.channels if r.eph.valid()]
    err = fix_error(res, rx)
    epochs = [s.snap_epoch for s in res.solutions]
    want = [s.snap_epoch for s in res_e2e.solutions]
    log(f"e2e mesh 2: {len(res.detections)} detections, {len(decoded)} "
        f"ephemerides, fixes at epochs {epochs} (phase 3: {want}), final "
        f"error {err:.2f} m")
    need_launched("e2e mesh 2", launches, RECEIVER_KERNELS)
    if len(res.detections) < 4 or len(decoded) < 4 or not err < 60.0 \
            or epochs != want:
        fail("e2e mesh 2: fewer than 4 detections or ephemerides, fix "
             "error over 60 m, or fix epochs differ from phase 3's")
    out["e2e 1-bit 20 s, mesh of 2 shards of one card"] = dict(
        wall=wall, launches=launches)
    cfg9, path9, fmt9, true9 = scene9
    r9 = iq_link_run("hackrf int8 4 s, mesh of 4 shards", cfg9, path9, fmt9,
                     true9, 25e3, 4.0, "int8", dev,
                     mesh=one_card_mesh(dev, 4))
    if r9["det"] != runs9["int8"]["det"]:
        fail(f"hackrf mesh 4: PRNs {r9['det']}, phase 9 "
             f"{runs9['int8']['det']}")
    out["hackrf int8 4 s, mesh of 4 shards of one card"] = r9
    # all CUDA launches per 10 ms step, no mesh against 1, 2 and 4 shards,
    # on the first 4 s of the e2e capture
    per_step = {}
    for n in (0, 1, 2, 4):
        recv = Receiver(cfg_e2e, mesh=one_card_mesh(dev, n) if n else None,
                        device=dev)
        _, k = profiled_launches(lambda: recv.process_source(
            FileSource1Bit(path_e2e, cfg_e2e), max_duration_s=4.0))
        per_step[n] = None if k is None else k / 400.0
    log("CUDA kernels and copies per 10 ms step, e2e 4 s (torch.profiler; "
        "acquisition included): "
        + ", ".join(f"{'no mesh' if n == 0 else f'{n} shards'} "
                    f"{'not measured' if v is None else f'{v:.1f}'}"
                    for n, v in per_step.items()))
    # each shard's GraphedTracker: track_corr and loop_update a step, its
    # chunk's copies, and the search, as phase 18 bounds the single device
    for n, v in per_step.items():
        if v is not None and not v <= 3.5 * max(n, 1):
            fail(f"mesh {n}: {v:.1f} CUDA kernels and copies per 10 ms "
                 f"step (limit {3.5 * max(n, 1)})")
    return out, per_step


def multihost_worker_runs(dev, tmpdir):
    """``python -m tpu_gnss_torch.dist.multihost --flagship --device
    cuda`` as 2 gloo processes sharing the card (2 shards each, 2 blocks
    each) and as 1 NCCL process (2 shards, 4 blocks): the backend each
    picks, and 4 blocks in all in both.  Every process writes the same
    results, equal to the single-process engines on the card: the
    exact-semantics searcher (SNR rtol 1e-5, equal bins and lags), the
    folded kernel engine ``acquire_folded_batch_mxu`` in both of the
    worker's layouts, blocks across the processes and the Doppler grid
    across them (SNR rtol 1e-4, equal bins and lags; under gloo the
    second one gathers CUDA results through the host), and the
    gather-correlator bank (prompt I rtol 1e-4 / atol 1e-2 x the period).
    Every process must launch ``fold_corr_reduce``.  With 2 cards, also 2
    NCCL processes, one per card.  Returns ``{run: summed launches}``."""
    import socket
    from tpu_gnss_torch import kernels
    from tpu_gnss_torch.acquire import folded as F
    from tpu_gnss_torch.acquire.search import Searcher
    from tpu_gnss_torch.dist import multihost as mh
    from tpu_gnss_torch.track import channel as tc
    here = os.path.dirname(os.path.abspath(__file__))
    cfg, dop_chunk, n_epochs = mh.worker_config(flagship=True)
    n_blk = 4
    runs = [(f"gloo, 2 processes x 2 shards of {dev}", 2, "gloo")]
    if dev.type == "cuda":
        runs.append((f"nccl, 1 process x 2 shards of {dev}", 1, "nccl"))
    if torch.cuda.device_count() >= 2:
        runs.append(("nccl, 2 processes on 2 cards x 2 shards", 2, "nccl"))
    searcher = Searcher(cfg, dop_chunk=dop_chunk, device=dev)
    fsr = F.FoldedSearcher(cfg, device=dev)
    fblocks = torch.from_numpy(mh.worker_folded_blocks(
        cfg, n_blk, fsr.block_len)).to(dev)
    fold_one = F.acquire_folded_batch_mxu(
        fblocks, *fsr.mxu_code_planes(), fsr.dops_hz, fs=cfg.fs,
        lo_rate=cfg.lo_rate, n_coherent=fsr.n_coherent, from_bits=True,
        period=fsr.period, nf=fsr.nf)
    fold_one = [t.cpu().numpy() for t in fold_one]
    gains = (tc.second_order_gains(18.0), tc.second_order_gains(2.0))
    p_len = round(cfg.fs * 1e-3)
    launches_by_run = {}
    for label, n_proc, backend in runs:
        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{sock.getsockname()[1]}"
        sock.close()
        outs = [os.path.join(tmpdir, f"mh_{backend}_{n_proc}_{k}.npz")
                for k in range(n_proc)]
        env = dict(os.environ, PYTHONPATH=here)
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "tpu_gnss_torch.dist.multihost",
             "--coordinator", coord, "--num-processes", str(n_proc),
             "--process-id", str(k), "--shards", "2",
             "--blocks-per-dev", str(n_blk // n_proc), "--bench-repeats",
             "3", "--flagship", "--device", dev.type, "--out", outs[k]],
            cwd=here, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for k in range(n_proc)]
        logs = []
        try:
            for q in procs:
                logs.append(q.communicate(timeout=300)[0])
        finally:
            for q in procs:
                if q.poll() is None:
                    q.kill()
                    q.wait()
        wall = time.perf_counter() - t0
        if any(q.returncode for q in procs):
            fail(f"multihost {label}: a worker failed:\n"
                 + "\n".join(x[-2000:] for x in logs))
        res = [dict(np.load(o)) for o in outs]
        picked = {str(r["backend"]) for r in res}
        if picked != {backend}:
            fail(f"multihost {label}: the workers picked {picked}")
        for k in ("snr", "lo_shift", "ca_shift", "track_ip", "fsnr", "fdop",
                  "fca", "xsnr", "xdop", "xca"):
            for r in res[1:]:
                if not np.array_equal(res[0][k], r[k]):
                    fail(f"multihost {label}: processes disagree on {k}")
        bits = mh.worker_blocks(cfg, n_blk)
        for b in range(len(bits)):
            one = searcher.acquire_bits(bits[b])
            np.testing.assert_allclose(res[0]["snr"][b], one.snr.cpu().numpy(),
                                       rtol=1e-5)
            if not (np.array_equal(res[0]["lo_shift"][b],
                                   one.lo_shift.cpu().numpy())
                    and np.array_equal(res[0]["ca_shift"][b],
                                       one.ca_shift.cpu().numpy())):
                fail(f"multihost {label}: block {b} bins or lags differ")
        exact = []
        for lay in "fx":
            got = [res[0][lay + k] for k in ("snr", "dop", "ca")]
            np.testing.assert_allclose(got[0], fold_one[0], rtol=1e-4)
            if not (np.array_equal(got[1], fold_one[1])
                    and np.array_equal(got[2], fold_one[2])):
                fail(f"multihost {label}: folded layout {lay} bins or lags "
                     "differ from acquire_folded_batch_mxu")
            exact.append(np.array_equal(got[0], fold_one[0]))
        if not (fold_one[0][:, 8] > 25).all():
            fail(f"multihost {label}: PRN 9 not found by the folded search")
        n_fold = [int(r["launches_fold_corr_reduce"]) for r in res]
        if min(n_fold) <= 0:
            fail(f"multihost {label}: fold_corr_reduce launches {n_fold}")
        launches_by_run[f"multihost {label}"] = {
            k: sum(int(r[f"launches_{k}"]) for r in res)
            for k in kernels.KERNELS}
        n_chan = mh.worker_channels(2 * n_proc, flagship=True)
        iq, state, tables = mh.worker_bank(cfg, n_chan, n_epochs)
        _, want = tc.track_epochs(
            torch.from_numpy(iq.astype(np.complex64)).to(dev),
            tc.ChannelState(*(t.to(dev) for t in state)),
            torch.from_numpy(tables).to(dev), fs=cfg.fs,
            pll_gains=gains[0], dll_gains=gains[1])
        np.testing.assert_allclose(res[0]["track_ip"], want.ip.cpu().numpy(),
                                   rtol=1e-4, atol=1e-2 * p_len)
        ms, fms = 1e3 * float(res[0]["wall"]), 1e3 * float(res[0]["fold_wall"])
        log(f"multihost {label}: {n_blk} blocks of {cfg.fft_len} samples x "
            f"32 PRNs x {cfg.num_dop_bins} bins, {n_blk} folded blocks of "
            f"{fsr.block_len} x {len(fsr.dops_hz)} rows (blocks across the "
            f"processes, and the Doppler grid across them; SNR "
            f"{'bit-identical' if all(exact) else 'within 1e-4'}) and a "
            f"{n_chan}-channel bank of {n_epochs} epochs equal to the "
            f"single-process engines; backend {backend}; sharded "
            f"acquisition {ms:.1f} ms a call ({ms / n_blk:.2f} ms a block), "
            f"sharded folded search {fms:.1f} ms a call ({fms / n_blk:.2f} "
            f"ms a block); fold_corr_reduce launches per process {n_fold}; "
            f"{wall:.1f} s for the whole run (process start included)")
    if torch.cuda.device_count() < 2:
        log(f"multihost and mesh runs on real cards need 2 cards; this "
            f"machine has {torch.cuda.device_count()}")
    return launches_by_run


def mesh_phase(cfg_e2e, path_e2e, rx, res_e2e, scene9, runs9, dev, tmpdir):
    """Phase 15: the sharded search and tracker against their
    single-device versions, the receiver on one-card meshes, the CLI with
    ``--mesh-devices 1``, and the multi-process worker."""
    from tpu_gnss_torch import PRESETS
    from tpu_gnss_torch.dist.shard import make_mesh
    meshes = {f"{n} shards": one_card_mesh(dev, n) for n in (1, 2, 4)}
    cards = torch.cuda.device_count() >= 2
    if cards:
        meshes["2 cards"] = make_mesh(2, device="cuda")
    search_ms = {"e2e": check_refined_sharded(cfg_e2e, "e2e", dev, meshes),
                 "hackrf": check_refined_sharded(PRESETS["hackrf"], "hackrf",
                                                 dev, meshes)}
    track = {lbl: check_tracker_sharded(fs, lbl, dev, {
        k: m for k, m in meshes.items() if k != "1 shards"})
        for lbl, fs in (("e2e", 2.048e6), ("hackrf", 10e6))}
    runs, per_step = mesh_receiver_runs(cfg_e2e, path_e2e, rx, res_e2e,
                                        scene9, runs9, dev)
    if cards:
        from tpu_gnss_torch.io.stream import FileSource1Bit
        from tpu_gnss_torch.receiver import Receiver
        res, _, launches, _ = drive(
            "e2e 1-bit 20 s, mesh of 2 cards",
            Receiver(cfg_e2e, mesh=meshes["2 cards"], device=dev),
            FileSource1Bit(path_e2e, cfg_e2e), 20.0)
        need_launched("e2e 2 cards", launches, RECEIVER_KERNELS)
        if not fix_error(res, rx) < 60.0:
            fail("e2e on 2 cards: no fix within 60 m")
        runs["e2e 1-bit 20 s, mesh of 2 cards"] = dict(launches=launches)
    argv = [path_e2e, str(cfg_e2e.fc), str(cfg_e2e.fs), "5000", "--fft-len",
            str(cfg_e2e.fft_len), "--threshold", str(cfg_e2e.snr_threshold),
            "--device", "cuda", "--mesh-devices", "1"]
    out, launches_cli, wall = cli_run(argv)
    err = cli_fix_error(out, rx)
    log(f"CLI --mesh-devices 1 on the e2e 20 s capture: wall {wall:.3f} s, "
        f"realtime factor {20.0 / wall:.2f}, last fix error {err:.2f} m, "
        f"launches {launches_cli}")
    need_launched("CLI --mesh-devices 1", launches_cli, RECEIVER_KERNELS)
    if not err < 60.0:
        fail(f"CLI --mesh-devices 1: fix error {err} m (limit 60 m)")
    runs["CLI --mesh-devices 1 e2e 20 s"] = dict(launches=launches_cli)
    for run, launches in multihost_worker_runs(dev, tmpdir).items():
        runs[run] = dict(launches=launches)
    return dict(runs=runs, search_ms=search_ms, track=track,
                per_step=per_step)


# ---------------------------------------------------------------------------
# phase 16: the reference's receiver scenarios on the card
# ---------------------------------------------------------------------------

# the scenes of tests/test_e2e.py:326-460 and tests/test_soak.py:30, at the
# oracles' arguments: (build_scene keywords, written as)
SCENARIO_SCENES = {
    "faded": (dict(duration=26.0, degrade=(3, 20.0, 0.05)), "iq"),
    "moving": (dict(duration=20.0, rx_vel_enu=(15.0, 8.0, 0.0)), "iq"),
    "ramp": (dict(duration=20.0, doppler_ramp_hz_s=5.0), "iq"),
    "wide": (dict(duration=20.0, noise=0.5), "replay"),
    "soak": (dict(duration=32.0, dropout=(0, 8.0, 14.0)), "1bit"),
}
WIDE_OFFSET_HZ = 60e3
# tests/test_stream.py:1244-1249: (fs, chunk_s, format, ragged tail)
CONFIG_MATRIX = ((2.046e6, 0.5, "1bit", 0), (2.046e6, 1.0, "iq8", 123),
                 (2.048e6, 2.0, "1bit", 8216), (2.048e6, 0.5, "iq8", 0))


def scenario_scene(name, tmpdir):
    """Build one scene of :data:`SCENARIO_SCENES` (in a worker process)
    and write it under ``tmpdir``: the complex baseband as ``.npy``, a
    1-bit IF capture, or the wide-offset replay (``apply_channel`` at
    +60 kHz, delay 777 samples, gain 1.3) as a 1-bit capture.  Returns
    ``(path, receiver ECEF, build seconds)``."""
    from tpu_gnss_torch.signal import rfchannel, scene
    kw, kind = SCENARIO_SCENES[name]
    t0 = time.perf_counter()
    iq, _, rx = scene.build_scene(**kw)
    fs = scene.FS
    if kind == "iq":
        path = os.path.join(tmpdir, f"{name}.npy")
        np.save(path, iq)
    else:
        if kind == "replay":
            iq = rfchannel.apply_channel(iq, fs, freq_offset_hz=WIDE_OFFSET_HZ,
                                         delay_samples=777.0, gain=1.3)
        path = os.path.join(tmpdir, f"{name}.bin")
        scene.write_1bit_capture(iq, fs / 4, fs, path)
    return path, rx, time.perf_counter() - t0


def start_scenario_scenes(pool, tmpdir) -> dict:
    """Submit every scene of phase 16 to ``pool`` (they build while the
    card runs phases 1-2b)."""
    return {name: pool.submit(scenario_scene, name, tmpdir)
            for name in SCENARIO_SCENES}


def matrix_capture(fs, fmt, tail, tmpdir):
    """tests/test_stream.py:1250-1281: PRNs 9 and 17, 3 s plus ``tail``
    samples, as a 1-bit IF or an int8 I/Q capture.  Returns ``(path,
    samples)``."""
    from tpu_gnss_torch.io import loaders
    from tpu_gnss_torch.signal import synth
    n = int(3.0 * fs) + tail
    n -= n % 8
    svs = [synth.SvSignal(prn=9, doppler_hz=500.0, code_phase_chips=300.0),
           synth.SvSignal(prn=17, doppler_hz=-1200.0, code_phase_chips=10.0)]
    iq = synth.synth_baseband(svs, fs, n, noise_std=0.4, seed=4)
    path = os.path.join(tmpdir, f"matrix_{fs:g}_{fmt}_{tail}.bin")
    if fmt == "1bit":
        with open(path, "wb") as f:
            f.write(loaders.pack_1bit(synth.baseband_to_1bit_if(iq, fs / 4,
                                                                fs)))
        return path, n
    raw = np.empty(2 * n, np.int8)
    scale = 100.0 / max(np.abs(iq.real).max(), np.abs(iq.imag).max())
    raw[0::2] = np.clip(np.rint(iq.real * scale), -127, 127)
    raw[1::2] = np.clip(np.rint(iq.imag * scale), -127, 127)
    raw.tofile(path)
    return path, n


def scenario_cfg(fs=2.048e6, **kw):
    """The oracles' receiver configuration: 12 channels, 32 PRNs,
    ``fft_len`` 4096, +-5 kHz and SNR threshold 20 unless given."""
    from tpu_gnss_torch import ReceiverConfig
    return ReceiverConfig(**dict(dict(fs=fs, fc=fs / 4, max_fo=5000.0,
                                      fft_len=4096, snr_threshold=20.0,
                                      num_chans=12), **kw))


def packed_path(cfg, chunk_s) -> bool:
    """Whether a 1-bit capture's packed words cross to the card and
    ``mix_packed`` mixes them: the receiver takes that path where a chunk
    is whole 32-bit words (receiver.process_source), else it mixes
    unpacked bits with torch ops, as the reference does."""
    return round(chunk_s * 1000) * round(cfg.fs * 1e-3) % 32 == 0


def scenario_run(label, cfg, src, duration, dev, is_1bit, runs, chunk_s,
                 **rx_kw):
    """One scenario run through :func:`drive`, its engine logged and its
    kernels required: ``fold_corr_reduce`` where the kernel engine ran,
    ``track_corr``, and ``mix_packed`` on 1-bit input where the packed
    path runs (:func:`packed_path`).  Each cold or background search's
    ``fold_corr_reduce`` launches and returned PRNs are kept in
    ``recv.searches``."""
    from tpu_gnss_torch import kernels
    from tpu_gnss_torch.receiver import Receiver
    recv = Receiver(cfg, device=dev, **rx_kw)
    engine = recv._resolve_engine(recv.searcher)
    recv.searches = []
    cold = recv._cold_detections

    def counted(*a, **kw):
        n0 = kernels.LAUNCHES.get("fold_corr_reduce")
        dets = cold(*a, **kw)
        recv.searches.append((kernels.LAUNCHES.get("fold_corr_reduce") - n0,
                              sorted(d["prn"] for d in dets)))
        return dets

    recv._cold_detections = counted
    res, wall, launches, _ = drive(label, recv, src, duration,
                                   chunk_s=chunk_s)
    packed = is_1bit and packed_path(cfg, chunk_s)
    log(f"{label}: acquisition engine {engine!r} "
        f"(receiver._resolve_engine), {len(recv.searches)} searches"
        + (f", 1-bit {'packed words' if packed else 'unpacked bits'}"
           if is_1bit else ""))
    need = (("fold_corr_reduce",) if engine == "mxu" else ()) \
        + ("track_corr", "loop_update") + (("mix_packed",) if packed
                                            else ())
    need_launched(label, launches, need)
    runs[label] = dict(wall=wall, rt=duration / wall, launches=launches,
                       engine=engine)
    return recv, res


def scenarios_phase(cfg_e2e, path_e2e, path_iq_e2e, rx_e2e, scenes, tmpdir,
                    dev) -> dict:
    """Phase 16: the port's counterpart of each slow oracle of the
    reference's receiver, on the card at the oracles' geometry (2.048
    Msps, 12 channels, 32 PRNs, ``fft_len`` 4096), each run held to its
    oracle's own bars.  Returns ``{run: {wall, rt, launches, engine}}``."""
    from tpu_gnss_torch.cli import nmea_out
    from tpu_gnss_torch.io.stream import ArraySource, FileSource1Bit, \
        IQFileSource
    from tpu_gnss_torch.signal import scene
    runs = {}
    fs = scene.FS
    built = {}
    for name, fut in scenes.items():
        path, rx, secs = fut.result()
        built[name] = (path, rx)
        log(f"scenario scene {name}: built in {secs:.1f} s in a worker "
            "process")
    iq_source = lambda path: ArraySource(np.load(path), fs)

    # complex input (tests/test_e2e.py:193): phase 3's baseband
    _, res = scenario_run("scenario complex 20 s", scenario_cfg(),
                          iq_source(path_iq_e2e), 20.0, dev, False, runs,
                          2.0)
    sol = res.solutions[-1] if res.solutions else None
    n_eph = sum(r.eph.valid() for r in res.channels)
    err = fix_error(res, rx_e2e)
    log(f"scenario complex: {len(res.detections)} detections, {n_eph} "
        f"ephemerides, {len(res.solutions)} fixes, final error {err:.2f} m, "
        + (f"lat {sol.lat_deg:.6f} lon {sol.lon_deg:.6f} speed "
           f"{sol.vel.speed_mps:.3f} m/s vu {sol.vel.vu:.3f}" if sol and
           sol.vel else "no velocity"))
    if not (len(res.detections) >= 4 and n_eph >= 4
            and len(res.solutions) >= 4 and err < 8.0 and sol.vel
            and abs(sol.lat_deg - scene.TRUTH_LLA[0]) < 0.01
            and abs(sol.lon_deg - scene.TRUTH_LLA[1]) < 0.01
            and sol.vel.speed_mps < 1.0 and abs(sol.vel.vu) < 2.0):
        fail("scenario complex: the bars of tests/test_e2e.py:193 missed")

    # chunk matrix (tests/test_e2e.py:290): phase 3's 1-bit capture
    counts = {}
    for ch_s in (0.5, 1.0, 4.0, 8.0):
        _, res = scenario_run(f"scenario chunk_s {ch_s:g} 20 s", cfg_e2e,
                              FileSource1Bit(path_e2e, cfg_e2e), 20.0, dev,
                              True, runs, ch_s)
        err = fix_error(res, rx_e2e)
        counts[ch_s] = len(res.solutions)
        log(f"scenario chunk_s {ch_s:g}: {counts[ch_s]} fixes at epochs "
            f"{[s.snap_epoch for s in res.solutions]}, final error "
            f"{err:.2f} m")
        if not err < 60.0:
            fail(f"scenario chunk_s {ch_s:g}: final error {err} m (60 m)")
    if len(set(counts.values())) != 1:
        fail(f"scenario chunk matrix: fix counts differ {counts}")

    # faded SV (tests/test_e2e.py:326)
    path, rx = built["faded"]
    iq = np.load(path)
    deg_prn = scene.eph_prn(3)
    fixes = {}
    for gate in (True, False):
        label = f"scenario faded {'gated' if gate else 'ungated'} 26 s"
        _, res = scenario_run(label, scenario_cfg(), ArraySource(iq, fs),
                              26.0, dev, False, runs, 2.0,
                              los_power_ratio=0.002, quality_gate=gate)
        sol = res.solutions[-1] if res.solutions else None
        fixes[gate] = sol
        log(f"{label}: last fix at epoch {sol.snap_epoch if sol else None}"
            f", PRNs {sorted(s['prn'] for s in sol.sats) if sol else None}"
            f", error {pos_error(sol, rx) if sol else float('nan'):.2f} m")
    del iq
    sg, su = fixes[True], fixes[False]
    if not (sg and su and sg.snap_epoch >= 24000 and su.snap_epoch >= 24000
            and deg_prn in [s["prn"] for s in su.sats]
            and deg_prn not in [s["prn"] for s in sg.sats]
            and pos_error(sg, rx) < 10.0
            and pos_error(sg, rx) <= pos_error(su, rx) + 0.5):
        fail("scenario faded: the bars of tests/test_e2e.py:326 missed")

    # moving receiver (tests/test_e2e.py:360)
    path, rx = built["moving"]
    v_enu = np.array(SCENARIO_SCENES["moving"][0]["rx_vel_enu"])
    _, res = scenario_run("scenario moving 20 s", scenario_cfg(),
                          iq_source(path), 20.0, dev, False, runs, 2.0)
    if not res.solutions or res.solutions[-1].vel is None:
        fail("scenario moving: no fix with a velocity")
    sol = res.solutions[-1]
    truth = (np.asarray(rx) + scene.enu_to_ecef_matrix(*scene.TRUTH_LLA[:2])
             @ v_enu * (sol.snap_epoch * 1e-3))
    v = sol.vel
    speed = float(np.hypot(v_enu[0], v_enu[1]))
    course = float(np.degrees(np.arctan2(v_enu[0], v_enu[1])))
    burst = nmea_out.solution_burst(sol)
    rmc = next(s for s in burst if s.startswith("$GPRMC"))
    vtg = next(s for s in burst if s.startswith("$GPVTG"))
    knots, rmc_course = (float(x) for x in rmc.split("*")[0].split(",")[7:9])
    kmh = float(vtg.split("*")[0].split(",")[7])
    err = pos_error(sol, truth)
    dcourse = lambda c: abs((c - course + 180) % 360 - 180)
    log(f"scenario moving: error {err:.2f} m against the moved truth, "
        f"velocity ENU ({v.ve:.3f}, {v.vn:.3f}, {v.vu:.3f}) m/s, speed "
        f"{v.speed_mps:.3f}, course {v.course_deg:.2f} deg; RMC {knots} kn "
        f"{rmc_course} deg, VTG {kmh} km/h")
    if not (err < 15.0 and abs(v.ve - v_enu[0]) < 0.5
            and abs(v.vn - v_enu[1]) < 0.5 and abs(v.vu - v_enu[2]) < 1.0
            and abs(v.speed_mps - speed) < 0.5 and dcourse(v.course_deg) < 3
            and abs(knots - speed * 3600.0 / 1852.0) < 1.0
            and dcourse(rmc_course) < 3.0 and abs(kmh - speed * 3.6) < 1.8):
        fail("scenario moving: the bars of tests/test_e2e.py:360 missed")

    # wide-offset replay (tests/test_e2e.py:405) on the +-100 kHz grid
    path, rx = built["wide"]
    cfg_w = scenario_cfg(max_fo=100000.0, snr_threshold=17.0)
    recv, res = scenario_run("scenario wide offset 20 s", cfg_w,
                             FileSource1Bit(path, cfg_w), 20.0, dev, True,
                             runs, 1.0)
    med = float(np.median([d["doppler_hz"] for d in res.detections])) \
        if res.detections else float("nan")
    n_eph = sum(r.eph.valid() for r in res.channels)
    err = fix_error(res, rx)
    log(f"scenario wide offset: {len(recv.searcher.dops_hz)} Doppler rows, "
        f"{len(res.detections)} detections "
        f"{sorted(d['prn'] for d in res.detections)}, median Doppler "
        f"{med:.1f} Hz, if_offset {recv._if_offset:.1f} Hz, {n_eph} "
        f"ephemerides, final error {err:.2f} m")
    if not (len(res.detections) >= 4 and abs(med - WIDE_OFFSET_HZ) < 2000.0
            and abs(recv._if_offset - WIDE_OFFSET_HZ) < 2000.0
            and n_eph >= 4 and err < 15.0):
        fail("scenario wide offset: the bars of tests/test_e2e.py:405 missed")

    # Doppler ramp (tests/test_e2e.py:445)
    path, rx = built["ramp"]
    _, res = scenario_run("scenario ramp 20 s", scenario_cfg(),
                          iq_source(path), 20.0, dev, False, runs, 2.0)
    sol = res.solutions[-1] if res.solutions else None
    err = fix_error(res, rx)
    log(f"scenario ramp 5 Hz/s: last fix at epoch "
        f"{sol.snap_epoch if sol else None}, error {err:.2f} m")
    if not (sol and sol.snap_epoch >= 16000 and err < 15.0):
        fail("scenario ramp: the bars of tests/test_e2e.py:445 missed")

    # dropout soak (tests/test_soak.py:30)
    path, rx = built["soak"]
    _, t0, t1 = SCENARIO_SCENES["soak"][0]["dropout"]
    cfg_s = scenario_cfg(snr_threshold=17.0)
    recv, res = scenario_run("scenario soak 32 s", cfg_s,
                             FileSource1Bit(path, cfg_s), 32.0, dev, True,
                             runs, 1.0)
    prn = scene.eph_prn(0)
    recs = [r for r in res.channels if r.prn == prn]
    spans = [(r.start_epoch, r.start_epoch + r.n_epochs, r.lost)
             for r in recs]
    snap_s = [s.snap_epoch * 1e-3 for s in res.solutions]
    first = snap_s[0] if snap_s else float("inf")
    missing = sorted(set(np.round([t for t in np.arange(4.0, 31.0, 4.0)
                                   if t >= first], 3))
                     - set(np.round(snap_s, 3)))
    worst = max((pos_error(s, rx) for s in res.solutions), default=np.inf)
    hist = sum(a.nbytes for r in res.channels for parts in r._chunks.values()
               for a in parts)
    # the search that returned PRN 2 after its loss, with its launches
    reacq = [n for n, prns in recv.searches[1:] if prn in prns]
    log(f"scenario soak: PRN {prn} records (start, end, lost) {spans}, "
        f"searches (fold_corr_reduce launches, PRNs) {recv.searches}, fixes "
        f"at {snap_s} s, missed slots {missing}, worst error {worst:.2f} m, "
        f"history {hist / 1e6:.2f} MB")
    if not (len(recs) >= 2 and recs[0].lost
            and t0 < spans[0][1] * 1e-3 < t1
            and recs[1].start_epoch * 1e-3 >= t1 and not recs[1].lost
            and recs[1].n_epochs >= 5000 and first <= 8.0 and not missing
            and worst < 4.0):
        fail("scenario soak: the bars of tests/test_soak.py:30 missed")
    if not (reacq and reacq[0] > 0):
        fail("scenario soak: no fold_corr_reduce launch in the search that "
             f"re-acquired PRN {prn} at {recs[1].start_epoch * 1e-3} s")
    log(f"scenario soak: the re-acquisition search launched "
        f"fold_corr_reduce {reacq[0]} times; PRN {prn} tracked again from "
        f"{recs[1].start_epoch * 1e-3:.1f} s of signal")
    if hist >= 64 * sum(r.n_epochs for r in res.channels) + 1e6:
        fail(f"scenario soak: history {hist} bytes is not O(epochs)")

    # config matrix (tests/test_stream.py:1243-1290)
    for fs_m, ch_s, fmt, tail in CONFIG_MATRIX:
        path, n = matrix_capture(fs_m, fmt, tail, tmpdir)
        cfg_m = scenario_cfg(fs=fs_m, snr_threshold=17.0)
        link = "int2" if ch_s == 0.5 else "int8"
        label = (f"scenario matrix {fs_m / 1e6:g} Msps {fmt} chunk_s "
                 f"{ch_s:g} tail {tail}" + (f" {link}" if fmt == "iq8"
                                            else ""))
        src = (FileSource1Bit(path, cfg_m) if fmt == "1bit" else
               IQFileSource(path, fs_m, remove_dc=False))
        rx_kw = {} if fmt == "1bit" else dict(transfer_dtype=link)
        _, res = scenario_run(label, cfg_m, src, n / fs_m, dev,
                              fmt == "1bit", runs, ch_s, **rx_kw)
        p = round(fs_m * 1e-3)
        det = sorted(d["prn"] for d in res.detections)
        held = {r.prn: float(np.abs(np.asarray(r.ip_hist[-100:])).mean()
                             / p) for r in res.channels}
        eps = sorted({r.n_epochs for r in res.channels})
        log(f"{label}: detections {det}, last-100 mean |IP| / P by PRN "
            f"{ {k: round(v, 3) for k, v in held.items()} }, epochs {eps} "
            f"(bounds {(n // p // 10) * 10 - 10}..{n // p})")
        if not ({9, 17} <= set(det) and held.get(9, 0) > 0.2
                and held.get(17, 0) > 0.2
                and all((n // p // 10) * 10 - 10 <= e <= n // p
                        for e in eps)):
            fail(f"{label}: the bars of tests/test_stream.py:1243 missed")
    return runs


# ---------------------------------------------------------------------------
# phase 17: boot and in-loop trace
# ---------------------------------------------------------------------------

# the CUDA kernels each receiver kernel's wrapper launches, once each a
# call, by the names the profiler gives them
TRACE_NAMES = {"fold_corr_reduce": ("fcr_forward", "fcr_reduce"),
               "track_corr": ("track_corr_kernel",),
               "mix_packed": ("mix_packed_kernel",),
               "loop_update": ("loop_update_kernel",)}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def boot_run(label, module_argv, cache):
    """``python -m <module_argv>`` in a process of its own whose cache
    root is ``cache``: ``(stdout, wall s from spawn to exit, nvcc s or
    None)``; the nvcc seconds are those the build reports, on stderr, or
    the warmup's report line."""
    from tpu_gnss_torch import kernels
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    env[kernels.CACHE_ENV] = cache
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", *module_argv], cwd=here,
                       env=env, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    if r.returncode:
        fail(f"boot {label}: exit code {r.returncode}:\n{r.stdout[-2000:]}"
             f"\n{r.stderr[-3000:]}")
    m = re.search(r"\(nvcc ([0-9.]+) s\)", r.stderr + r.stdout)
    return r.stdout, wall, (float(m.group(1)) if m else None)


def cache_listing(cache):
    """The cache root's entries and the library's mtime (ns)."""
    names = sorted(os.listdir(cache))
    libs = [n for n in names if n.startswith("libtpu_gnss_torch_")]
    return names, (os.stat(os.path.join(cache, libs[0])).st_mtime_ns
                   if len(libs) == 1 else None)


def boot_phase(cfg, path, rx, tmpdir):
    """Phase 17a-c: the receiver CLI on the 20 s e2e capture in an empty
    cache root A (cold: builds once), ``cli.warmup`` at the e2e geometry
    in an empty root B, and the receiver CLI again in B (warm: builds
    nothing).  Each run's wall from spawn to exit, the nvcc seconds, and
    the boot saving cold - warm."""
    from tpu_gnss_torch import kernels
    lib_name = kernels.library_path().name
    geo = [str(cfg.fc), str(cfg.fs), "5000", "--fft-len", str(cfg.fft_len),
           "--threshold", str(cfg.snr_threshold), "--channels",
           str(cfg.num_chans), "--device", "cuda"]
    rx_argv = ["tpu_gnss_torch.cli.run_receiver", path] + geo
    root_a = os.path.join(tmpdir, "cache_a")
    root_b = os.path.join(tmpdir, "cache_b")
    os.mkdir(root_a)
    os.mkdir(root_b)
    out_a, wall_a, nvcc_a = boot_run("cold", rx_argv, root_a)
    out_b, wall_b, nvcc_b = boot_run(
        "warmup", ["tpu_gnss_torch.cli.warmup"] + geo
        + ["--format", "1bit", "--chunk-s", "1"], root_b)
    report = next((ln for ln in out_b.splitlines()
                   if ln.startswith("warmup: ")), "")
    log(f"boot (b) warmup: {report!r}")
    warm_launches = {k: int(v) for k, v in re.findall(r"(\w+)=(\d+)",
                                                      report)}
    listing_b = cache_listing(root_b)
    out_c, wall_c, nvcc_c = boot_run("warm", rx_argv, root_b)
    err_a, err_c = cli_fix_error(out_a, rx), cli_fix_error(out_c, rx)
    log(f"boot (a) cold, empty cache root: wall {wall_a:.3f} s (spawn to "
        f"exit), nvcc {nvcc_a} s, last fix error {err_a:.2f} m")
    log(f"boot (b) warmup, empty cache root: wall {wall_b:.3f} s, nvcc "
        f"{nvcc_b} s, launches {warm_launches}")
    log(f"boot (c) warm, after the warmup: wall {wall_c:.3f} s, nvcc "
        f"{nvcc_c} s, last fix error {err_c:.2f} m")
    log(f"boot saving (a) - (c): {wall_a - wall_c:.3f} s")
    if not (err_a < 60.0 and err_c < 60.0):
        fail("boot: the cold or the warm session has no fix within 60 m")
    if not (warm_launches.get("mix_packed", 0) > 0
            and warm_launches.get("fold_corr_reduce", 0) > 0):
        fail("boot: the warmup did not launch mix_packed and "
             "fold_corr_reduce")
    if nvcc_a is None or nvcc_b is None:
        fail("boot: the cold session or the warmup reported no build")
    if nvcc_c is not None or cache_listing(root_b) != listing_b:
        fail("boot: the warm session rebuilt the library")
    for root in (root_a, root_b):
        if os.listdir(root) != [lib_name]:
            fail(f"boot: {root} holds {os.listdir(root)}, not one library "
                 f"{lib_name}")


def busy_union_us(spans) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s0, e0 in sorted(spans):
        if cur_e is None or s0 > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def loop_trace(cfg, path, dev, tmpdir, duration=4.0):
    """Phase 17d: the first ``duration`` s of the e2e capture (phase 12's
    FFT-dot run) inside ``utils.metrics.device_trace``; from the trace
    JSON, each receiver kernel's device time and call count (equal to
    ``kernels.LAUNCHES``), ``mix_packed``'s share of the loop's device
    time, and the card's busy share of the traced window."""
    import glob
    from tpu_gnss_torch import kernels
    from tpu_gnss_torch.io.stream import FileSource1Bit
    from tpu_gnss_torch.receiver import Receiver
    from tpu_gnss_torch.utils.metrics import device_trace
    logdir = os.path.join(tmpdir, "trace")
    recv = Receiver(cfg, device=dev)
    torch.cuda.synchronize()
    kernels.LAUNCHES.reset()
    t0 = time.perf_counter()
    with device_trace(logdir):
        recv.process_source(FileSource1Bit(path, cfg),
                            max_duration_s=duration)
        wall = time.perf_counter() - t0
    export = time.perf_counter() - t0 - wall
    launches = {k: kernels.LAUNCHES.get(k) for k in RECEIVER_KERNELS}
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    if len(files) != 1:
        fail(f"trace: {len(files)} trace files under {logdir}")
    with open(files[0]) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if str(e.get("cat", "")).lower()
              in DEVICE_CATS]
    if not device:
        fail("trace: no device activity in the trace")
    t_dev = sum(e["dur"] for e in device)
    window = wall * 1e6          # the traced block, on the host's clock
    busy = busy_union_us([(e["ts"], e["ts"] + e["dur"]) for e in device])
    kernel_us = {}
    for k, names in TRACE_NAMES.items():
        counts = [sum(n in e.get("name", "") for e in device) for n in names]
        us = kernel_us[k] = sum(e["dur"] for e in device
                                if any(n in e.get("name", "") for n in names))
        log(f"trace: {k} ({'+'.join(names)}): {counts} calls, device "
            f"{us / 1e3:.3f} ms in all, {us / max(counts[0], 1):.2f} us a "
            f"call; kernels.LAUNCHES {launches[k]}")
        if launches[k] <= 0 or any(c != launches[k] for c in counts):
            fail(f"trace: {k} calls {counts} differ from kernels.LAUNCHES "
                 f"{launches[k]}")
    share = kernel_us["mix_packed"] / t_dev
    log(f"trace: e2e {duration:g} s FFT-dot run, wall {wall:.3f} s under "
        f"the profiler (then {export:.3f} s to stop it and write "
        f"{os.path.getsize(files[0]) / 1e6:.1f} MB of trace), "
        f"{len(device)} device events, device time "
        f"{t_dev / 1e3:.3f} ms; mix_packed {100 * share:.2f}% of the "
        f"loop's device time; card busy {100 * busy / window:.2f}% of the "
        f"traced block's wall (under the profiler)")


# ---------------------------------------------------------------------------
# phase 18: the tracking bank as one device program per chunk
# ---------------------------------------------------------------------------

# loop_update against loop_update_plain, x each field's scale (max(1,
# max|plain value|); for the carrier phase, the cycles the step advanced,
# whose float32 ulp the phase carries): one step from the same state
# differs by a few ulps (atan, summation order); after a 100-step chain on
# the same taps the ulps of the accumulators (pll_acc, the phases) add up
LOOP_STEP_TOL = 1e-5
LOOP_CHAIN_TOL = 1e-4
# the fields and EpochOut planes that wrap, and their periods
STATE_WRAP = {"carrier_phase": 1.0, "code_phase": 1023.0}
OUT_WRAP = {"code_phase": 1023.0}
# H100 SXM float32 peak outside the tensor cores (NVIDIA data sheet)
FP32_PEAK = 67e12


def loop_bound_text(t: dict) -> str:
    return (f"bound {t['bound_ms'] * 1e6:.2f} ns ({t['bound_by']}), share "
            f"{100 * t['share']:.3f}%")


def loop_case(fs, dev, steps=100, eps=10):
    """A ``steps``-step eager chain of the FFT-dot tracker over
    ``tracking_bank``'s 12 SVs at ``fs``: the packed state before each
    step and that step's taps as ``loop_update`` takes them
    (``(ip, qp, |e|, 0, |l|, 0)``: hypot(|e|, 0) is |e| exactly), and the
    loop options."""
    from tpu_gnss_torch.track import channel as tc
    x, state, spec = tracking_bank(fs, dev, eps, steps=steps)
    gains = dict(fs=fs, pll_gains=tc.second_order_gains(18.0, t_s=eps * 1e-3),
                 dll_gains=tc.second_order_gains(2.0, t_s=eps * 1e-3),
                 epochs_per_step=eps)
    step_len = round(fs * 1e-3) * eps
    states, taps = [], []
    for s in range(steps):
        states.append(tc.pack_state(state))
        state, out = tc.track_epochs(x[s * step_len:(s + 1) * step_len],
                                     state, None, code_ffts=spec, **gains)
        z = torch.zeros_like(out.ip)
        taps.append(torch.stack([out.ip, out.qp, out.e_mag, z, out.l_mag, z],
                                dim=-1).contiguous())
    return states, taps, tc.loop_opts(**gains)


def field_err(got, want, names, wrap, scale_of):
    """Worst ``|got - want| / scale`` over the rows of ``[k, ...]``
    tensors named ``names`` (wrap-aware where ``wrap`` names a period),
    the row it is in, and the largest ``|got - want|`` unscaled."""
    worst, where, top = 0.0, None, 0.0
    for name, g, w in zip(names, got, want):
        d = (g.double() - w.double()).abs()
        if name in wrap:
            d = torch.minimum(d, wrap[name] - d)
        top = max(top, float(d.max()))
        e = float(d.max()) / scale_of(name, w)
        if e > worst:
            worst, where = e, name
    return worst, where, top


def compare_loop(got, want, outs_g, outs_w, opts, tol, label):
    """State and output planes of ``loop_update`` against the plain
    version within ``tol`` x scale; returns the worst scaled error and
    the largest absolute one."""
    from tpu_gnss_torch.track import channel as tc
    cycles = float(want[6].abs().max()) * opts.period * opts.e_sub / opts.fs

    def scale(name, w):
        if name == "carrier_phase":
            return max(1.0, cycles)
        return max(1.0, float(w.abs().max()))

    e_st, f_st, a_st = field_err(got, want, tc.ChannelState._fields,
                                 STATE_WRAP, scale)
    e_out, f_out, a_out = field_err(outs_g, outs_w, tc.EpochOut._fields,
                                    OUT_WRAP, scale)
    if not (e_st <= tol and e_out <= tol):
        fail(f"loop_update {label}: state {f_st} {e_st:.3e}, outputs "
             f"{f_out} {e_out:.3e} x scale (limit {tol})")
    return max(e_st, e_out), max(a_st, a_out)


def compare_params(got, want, opts, label):
    """The next step's ``track_corr`` parameters: phase0 (wrap-aware mod
    1, x the cycles a step advances), delta (x max|delta|) and the prompt
    lag (wrap-aware mod P, x P) within ``LOOP_STEP_TOL``, flags equal."""
    if not torch.equal(got[..., 3:], want[..., 3:]):
        fail(f"loop_update {label}: wrap flags differ")
    d = (got[..., :3].double() - want[..., :3].double()).abs()
    d[..., 0] = torch.minimum(d[..., 0], 1.0 - d[..., 0])
    d[..., 2] = torch.minimum(d[..., 2], opts.period - d[..., 2])
    delta = float(want[..., 1].abs().max())
    scale = (max(1.0, delta * opts.period * opts.e_sub), max(delta, 1e-30),
             float(opts.period))
    errs = [float(d[..., i].max()) / scale[i] for i in range(3)]
    if not max(errs) <= LOOP_STEP_TOL:
        fail(f"loop_update {label}: params phase0 / delta / lag differ by "
             f"{errs} x scale (limit {LOOP_STEP_TOL})")


def widen_case(states, taps, n_chan, seed=5):
    """``loop_case``'s states and taps on ``n_chan`` channels: channel k
    takes channel k % 12's (the first 12 as they are, so fewer channels
    are a slice); from channel 12 on, each channel's prompt (and stored
    previous prompt) turned by a seeded angle, every tap scaled by a
    seeded gain, its carrier and code phases shifted by seeded offsets,
    and every 7th channel inactive."""
    dev = taps[0].device
    rng = np.random.default_rng(seed)
    k = torch.arange(n_chan, device=dev)
    idx, extra = k % 12, k >= 12
    draw = lambda lo, hi: torch.from_numpy(rng.uniform(
        lo, hi, n_chan).astype(np.float32)).to(dev) * extra
    theta, gain = draw(-np.pi, np.pi), 1.0 + draw(-0.3, 0.3)
    dphase, dcode = draw(0.0, 1.0), draw(0.0, 1023.0)
    cos, sin = torch.cos(theta), torch.sin(theta)

    def turn(i, q):
        return (i * cos - q * sin) * gain, (i * sin + q * cos) * gain

    out_taps = []
    for t in taps:
        t = t[:, idx].clone()
        t[..., 0], t[..., 1] = turn(t[..., 0], t[..., 1])
        t[..., 2:] *= gain[None, :, None]
        out_taps.append(t.contiguous())
    out_states = []
    for st in states:
        st = st[:, idx].clone()
        st[1] = (st[1] + dphase) % 1.0
        st[3] = (st[3] + dcode) % 1023.0
        st[9], st[10] = turn(st[9], st[10])
        st[0] = torch.where(extra & (k % 7 == 0), 0.0, st[0])
        out_states.append(st.contiguous())
    return out_states, out_taps


# phase 18a's loop_update shapes: (label, sample rate, channels, epochs
# per step): the main path's 12 x 10 at e2e and hackrf, then e_sub 1 and
# 4 (the reference's own tests run 4), the mesh's shards of 3 and 6
# channels, 13 channels (no multiple of 32) and 200 (several blocks)
LOOP_SHAPES = (("e2e", 2.048e6, 12, 10), ("hackrf", 10e6, 12, 10),
               ("e2e e_sub 1", 2.048e6, 12, 1),
               ("e2e e_sub 4", 2.048e6, 12, 4),
               ("e2e 3 ch", 2.048e6, 3, 10), ("e2e 6 ch", 2.048e6, 6, 10),
               ("e2e 13 ch", 2.048e6, 13, 10),
               ("e2e 200 ch", 2.048e6, 200, 10))


def check_loop_update(fs, dev, label, n_chan, eps, floor_ms):
    """Phase 18a: ``loop_update`` against ``loop_update_plain`` on the card
    at ``n_chan`` channels, ``eps`` epochs a step, on the taps of a
    100-step chain (``loop_case``; ``widen_case`` for other channel
    counts): each step from the same state (the new state, the step's
    output rows and the next step's ``track_corr`` parameters, flags
    equal), the parameters alone (``taps=None``, step 0 of a chunk), then
    the whole chain fed through each without parameters (``par=None``, as
    the gather correlator calls it); the kernel's time against the plain
    version's, the bound and ``floor_ms``, an empty launch's time."""
    from tpu_gnss_torch.track import channel as tc
    states, taps, opts = loop_case(fs, dev, eps=eps)
    if n_chan != 12:
        states, taps = widen_case(states, taps, n_chan)
    steps = len(taps)
    aid = tc.aid_tensor(0.0, dev)
    new_par = lambda: torch.empty(eps, n_chan, 5, device=dev)
    step_err = step_abs = 0.0
    for s in range(steps):
        runs = []
        for fn in (tc.loop_update, tc.loop_update_plain):
            st = states[s].clone()
            par = new_par()
            outs = torch.empty(7, eps, n_chan, device=dev)
            fn(taps[s], st, aid, par, outs, 0, opts)
            prep = new_par()
            fn(None, states[s].clone(), aid, prep, None, 0, opts)
            runs.append((st, par, outs, prep))
        (sk, pk, ok, qk), (sp, pp, op, qp) = runs
        e, a = compare_loop(sk, sp, ok, op, opts, LOOP_STEP_TOL,
                            f"{label} step {s}")
        step_err, step_abs = max(step_err, e), max(step_abs, a)
        compare_params(pk, pp, opts, f"{label} step {s}")
        compare_params(qk, qp, opts, f"{label} step {s} taps=None")
    chain = []
    for fn in (tc.loop_update, tc.loop_update_plain):
        st = states[0].clone()
        outs = torch.empty(7, steps * eps, n_chan, device=dev)
        for s in range(steps):
            fn(taps[s], st, aid, None, outs, s, opts)
        chain.append((st, outs))
    chain_err, chain_abs = compare_loop(chain[0][0], chain[1][0],
                                        chain[0][1], chain[1][1], opts,
                                        LOOP_CHAIN_TOL, f"{label} chain")
    # timed on a state of its own that the calls advance step by step
    st = states[0].clone()
    par = new_par()
    outs = torch.empty(7, eps, n_chan, device=dev)
    call = lambda fn: fn(taps[0], st, aid, par, outs, 0, opts)
    ms = time_ms(lambda: call(tc.loop_update))
    plain_ms = time_ms(lambda: call(tc.loop_update_plain))
    # each input read once (taps, state, aid), each output written once
    # (state, the next step's params, the step's output rows); per channel
    # and epoch ~100 float32 operations (2 hypot, 2 atan, 2 divisions,
    # the sums and the params), ~60 more per channel
    nbytes = 4 * (taps[0].numel() + 2 * st.numel() + 1 + par.numel()
                  + outs.numel())
    flops = n_chan * (100 * eps + 60)
    b_ms = max(flops / FP32_PEAK, nbytes / HBM_BPS) * 1e3
    t = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
             bound_by="bytes" if nbytes / HBM_BPS >= flops / FP32_PEAK
             else "operations", share=b_ms / ms, library_ms=None,
             floor_ms=floor_ms)
    geo = tc.loop_geometry(n_chan, eps)
    log(f"loop_update {label}: e_sub={eps} n_chan={n_chan} ({geo[1]} "
        f"block(s) of {geo[0]} channels, {geo[2]} threads, {geo[3]} B "
        f"shared), {steps} steps one at a time with and without taps: "
        f"worst {step_err:.3e} x scale (limit {LOOP_STEP_TOL}; largest "
        f"absolute {step_abs:.3e}); the {steps}-step chain without "
        f"params: worst {chain_err:.3e} x scale (limit {LOOP_CHAIN_TOL}; "
        f"largest absolute {chain_abs:.3e}); kernel {ms * 1e3:.2f} us, "
        f"plain {plain_ms * 1e3:.2f} us, {loop_bound_text(t)}, launch "
        f"floor {floor_ms * 1e3:.2f} us")
    return dict(max_abs_err=step_abs, max_rel_err=step_err,
                chain_err=chain_err, **t)


def nav_bit_signs(ip, chans, first_epoch):
    """Signs of the 20 ms prompt sums of channels ``chans`` from
    ``first_epoch`` on."""
    n = (ip.shape[0] - first_epoch) // 20
    bits = ip[first_epoch:first_epoch + 20 * n].reshape(n, 20, -1).sum(1)
    return torch.sign(bits[:, chans])


def graphed_vs_eager(cfg, path_iq, res_e2e, dev, gather=False):
    """Phase 18b: ``GraphedTracker`` and eager ``track_epochs`` over the
    same 1 s chunks of phase 3's 20 s baseband (19 chunks and a 0.75 s
    tail), with the FFT-dot correlator or with ``gather``, seeded from
    phase 3's detections, with the same slot changes
    between chunks (the first 4 detections at the start, the rest at 5 s,
    one channel stopped at 10 s and re-seeded on its PRN at 12 s, an
    oscillator offset set at 8 s): outputs within ``LOOP_CHAIN_TOL`` x
    scale, NAV bit signs equal after lock, and each replay counted in
    ``kernels.LAUNCHES``; each run's wall."""
    from tpu_gnss_torch import kernels
    from tpu_gnss_torch.constants import CHIP_RATE_HZ
    from tpu_gnss_torch.track import channel as tc
    from tpu_gnss_torch.track.graph import GraphedTracker
    eps, n_chan = 10, 12
    gains = dict(fs=cfg.fs,
                 pll_gains=tc.second_order_gains(18.0, t_s=eps * 1e-3),
                 dll_gains=tc.second_order_gains(2.0, t_s=eps * 1e-3),
                 epochs_per_step=eps)
    x = torch.from_numpy(np.load(path_iq).astype(np.complex64)).to(dev)
    dets = sorted(res_e2e.detections, key=lambda d: -d["snr"])
    seed = lambda d: (d["doppler_hz"],
                      (d["ca_shift"] * CHIP_RATE_HZ / cfg.fs) % 1023.0,
                      d["doppler_hz"])
    p = round(cfg.fs * 1e-3)
    bounds = [(k * 1000 * p, (k + 1) * 1000 * p) for k in range(19)]
    bounds.append((19000 * p, 19750 * p))
    codes = {}

    def run(track):
        state, prns, aid, outs = tc.init_state(n_chan, dev), [1] * n_chan, \
            0.0, []
        for k, (a, b) in enumerate(bounds):
            starts = (list(enumerate(dets[:4])) if k == 0 else
                      list(enumerate(dets[4:], 4)) if k == 5 else
                      [(0, dets[0])] if k == 12 else [])
            for ch, d in starts:
                dop, cp, cd = seed(d)
                # the code phase crept on since the search at epoch 0
                rate = CHIP_RATE_HZ * (1.0 + cd / 1575.42e6)
                cp = (cp + rate * (a / cfg.fs)) % 1023.0
                state = tc.start_channels(state, [ch], [dop], [cp], [cd])
                prns[ch] = d["prn"]
            if k == 10:
                state = tc.stop_channel(state, 0)
            if k == 8:
                aid = 37.0
            key = tuple(prns)
            if key not in codes:
                codes[key] = torch.from_numpy(
                    tc.channel_code_tables(prns, n_chan) if gather
                    else tc.code_spectra_np(prns, n_chan, cfg.fs)).to(dev)
            code = (codes[key], None) if gather else (None, codes[key])
            state, out = track(x[a:b], state, *code, aid)
            outs.append(out)
        torch.cuda.synchronize()
        return state, tc.EpochOut(*(torch.cat(f) for f in zip(*outs)))

    eager = lambda seg, st, tables, ffts, aid: tc.track_epochs(
        seg, st, tables, code_ffts=ffts, aid_offset_hz=aid, **gains)
    tracker = GraphedTracker(**gains, device=dev)
    times, results, launches = {}, {}, {}
    for name, fn in (("eager", eager), ("graphed", tracker)):
        torch.cuda.synchronize()
        kernels.LAUNCHES.reset()
        t0 = time.perf_counter()
        results[name] = run(fn)
        times[name] = time.perf_counter() - t0
        launches[name] = {k: kernels.LAUNCHES.get(k)
                          for k in ("track_corr", "loop_update")}
    # warm: the graphs exist, every chunk of the 1 s shape replays
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(tracker)
    times["graphed, warm"] = time.perf_counter() - t0
    (st_e, out_e), (st_g, out_g) = results["eager"], results["graphed"]
    opts = tc.loop_opts(**gains)
    name = "gather" if gather else "FFT-dot"
    err, _ = compare_loop(tc.pack_state(st_g), tc.pack_state(st_e),
                          torch.stack(list(out_g)), torch.stack(list(out_e)),
                          opts, LOOP_CHAIN_TOL, f"graphed vs eager {name}")
    exact = all(torch.equal(a, b) for a, b in zip(out_g, out_e))
    # channels 1-5 tracked from 5 s at the latest, locked 2 s later
    chans = list(range(1, min(len(dets), n_chan)))
    bits_e, bits_g = (nav_bit_signs(o.ip, chans, 7000)
                      for o in (out_e, out_g))
    flips = int((bits_e != bits_g).sum())
    steps = sum((b - a) // (p * eps) for a, b in bounds)
    want = (dict(track_corr=0, loop_update=steps) if gather else
            dict(track_corr=steps, loop_update=steps + len(bounds)))
    log(f"graphed vs eager {name} tracker, e2e 20 s in 1 s chunks and a "
        f"0.75 s "
        f"tail ({steps} steps, {len(dets)} SVs, slot changes at 5, 8, 10 "
        f"and 12 s): outputs {'bit-identical' if exact else 'differ'}, "
        f"worst {err:.3e} x scale (limit {LOOP_CHAIN_TOL}); NAV bit signs "
        f"of channels {chans} after 7 s: {flips} of {bits_e.numel()} "
        f"differ; launches eager "
        f"{launches['eager']}, graphed {launches['graphed']} (want "
        f"{want}); wall eager {times['eager']:.3f} s, graphed (first use: "
        f"eager chunk, capture) {times['graphed']:.3f} s, graphed warm "
        f"{times['graphed, warm']:.3f} s")
    if flips or launches["eager"] != want or launches["graphed"] != want:
        fail(f"graphed vs eager {name}: NAV bit signs or launch counts "
             "differ")
    return dict(exact=exact, err=err, times=times)


def retime_runs(cfg, path_e2e, path_e2e8, cfg_n, path_n, scene9, scene10,
                dev):
    """Phase 18c: phases 3, 4, 8, 9 (int8) and 10's receiver runs again,
    each in a process that has run it once, its wall beside the
    receiver's stage seconds; then the CUDA kernels and copies per 10 ms
    step of the e2e 4 s receiver, by name."""
    from tpu_gnss_torch.io.stream import FileSource1Bit, IQFileSource
    from tpu_gnss_torch.receiver import Receiver
    from tpu_gnss_torch.utils.metrics import METRICS
    iq = lambda scene: (lambda: IQFileSource(scene[1], scene[0].fs,
                                             scene[2]))
    runs = (("e2e 1-bit 20 s", cfg, lambda: FileSource1Bit(path_e2e, cfg),
             20.0),
            ("nottingham 1-bit 4 s", cfg_n,
             lambda: FileSource1Bit(path_n, cfg_n), 4.0),
            ("e2e int8 I/Q 20 s", cfg,
             lambda: IQFileSource(path_e2e8, cfg.fs, "int8"), 20.0),
            ("hackrf int8 4 s", scene9[0], iq(scene9), 4.0),
            ("rtlsdr int8 4 s", scene10[0], iq(scene10), 4.0))
    out = {}
    for name, c, src, duration in runs:
        before = {k: sum(v) for k, v in METRICS.timings.items()}
        res, wall, launches, _ = drive(f"re-timed {name}",
                                       Receiver(c, device=dev), src(),
                                       duration)
        stages = {k: sum(v) - before.get(k, 0.0)
                  for k, v in METRICS.timings.items()
                  if k.startswith("receiver.")}
        log(f"re-timed {name}: stages " + ", ".join(
            f"{k.split('.')[1]} {v:.3f}" for k, v in sorted(
                stages.items(), key=lambda kv: -kv[1])) + " s")
        need_launched(f"re-timed {name}", launches,
                      ("fold_corr_reduce", "track_corr", "loop_update"))
        out[name] = dict(wall=wall, rt=duration / wall, stages=stages,
                         launches=launches)
    recv = Receiver(cfg, device=dev)
    recv.process_source(FileSource1Bit(path_e2e, cfg), max_duration_s=4.0)
    _, counts = profiled_kernels(lambda: recv.process_source(
        FileSource1Bit(path_e2e, cfg), max_duration_s=4.0))
    total = sum(counts.values())
    top = sorted(counts.items(), key=lambda kv: -kv[1])[:8]
    log(f"CUDA kernels and copies per 10 ms step, e2e 4 s receiver (second "
        f"run of a receiver, torch.profiler, acquisition included): "
        f"{total / 400.0:.2f} ({total} in 400 steps); most launched: "
        + "; ".join(f"{k[:60]} {v}" for k, v in top))
    return out, total / 400.0


def same_result(a, b) -> bool:
    """Two receiver results bit for bit: detections, each channel's
    record and histories, and the fixes."""
    if a.detections != b.detections or len(a.channels) != len(b.channels):
        return False
    for x, y in zip(a.channels, b.channels):
        if ((x.ch, x.prn, x.start_epoch, x.n_epochs, x.lost)
                != (y.ch, y.prn, y.start_epoch, y.n_epochs, y.lost)):
            return False
        if not all(np.array_equal(x.hist(k), y.hist(k))
                   for k in ("ip", "qp", "cf", "caf", "chips")):
            return False
    fix = lambda res: [(s.snap_epoch, s.x, s.y, s.z, s.t_rx)
                       for s in res.solutions]
    return fix(a) == fix(b)


COLD_SPANS = ("receiver.init", "receiver.prewarm.acq",
              "receiver.prewarm.seeder", "receiver.prewarm.track",
              "receiver.prewarm_wait", "acquire.search", "acquire.seed")


def log_cold_spans(name, spans) -> None:
    """One line: the seconds of each of ``COLD_SPANS`` among ``spans``
    (the program's records of one run), summed with their count."""
    parts = []
    for k in COLD_SPANS:
        got = [s.end - s.start for s in spans if s.name == k]
        if got:
            parts.append(f"{k} {sum(got):.4f} s" + (f" x{len(got)}"
                                                    if len(got) > 1 else ""))
    log(f"{name}: cold-start spans: " + (", ".join(parts) or "none"))


def prewarm_phase(cfg, path_e2e, rx, scene9, runs9, dev):
    """Phase 18e: the receiver's prewarm and the process's shared
    trackers (module docstring), from :func:`tpu_gnss_torch.cache.clear`:
    the kernels' device tables are dropped too, so the phase's first
    receiver really is the process's first.  Returns, per geometry, the two
    receivers' tracker counts, prewarm and wait seconds, walls and the
    device memory held, and the private tracker's run."""
    from tpu_gnss_torch import cache
    from tpu_gnss_torch.io.stream import FileSource1Bit, IQFileSource
    from tpu_gnss_torch.receiver import Receiver
    from tpu_gnss_torch.track import graph
    from tpu_gnss_torch.utils.metrics import METRICS
    cfg9, path9, fmt9, true9 = scene9

    def gates_e2e(label, recv, res, launches):
        decoded = [r for r in res.channels if r.eph.valid()]
        err = fix_error(res, rx)
        log(f"{label}: {len(res.detections)} detections, {len(decoded)} "
            f"ephemerides, {len(res.solutions)} fixes, final error "
            f"{err:.2f} m")
        need_launched(label, launches, RECEIVER_KERNELS)
        if len(res.detections) < 4 or len(decoded) < 4 or not err < 60.0:
            fail(f"{label}: fewer than 4 detections or ephemerides, or "
                 f"final fix error {err} m (limit 60 m)")

    def gates_hackrf(label, recv, res, launches):
        det = iq_gates(label, recv, res, launches, true9, 25e3)
        if det != runs9["int8"]["det"]:
            fail(f"{label}: PRNs {det}, phase 9 {runs9['int8']['det']}")

    cases = (("e2e 1-bit 20 s", cfg, lambda: FileSource1Bit(path_e2e, cfg),
              20.0, gates_e2e),
             ("hackrf int8 4 s", cfg9,
              lambda: IQFileSource(path9, cfg9.fs, fmt9), 4.0, gates_hackrf))
    # the earlier phases' shared trackers (with their graphs), search
    # tables, kernels' device tables and the prewarms' record go: the next
    # receiver of each geometry is the first of the process to ask
    cache.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved(dev)
    out = {}
    with METRICS.recording():
        for label, c, src, duration, gates in cases:
            runs, results = [], []
            for i in (1, 2):
                recv = Receiver(c, device=dev)
                before = recv._tracker.counts()
                name = f"prewarm {label}, receiver {i}"
                METRICS.drain()
                res, wall, launches, _ = drive(name, recv, src(), duration)
                log_cold_spans(name, METRICS.drain()[0])
                after = recv._tracker.counts()
                loop = {k: after[k] - before[k] for k in after}
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                held = (torch.cuda.memory_reserved(dev) - reserved0) / 1e6
                st = dict(recv.prewarm_stats)
                log(f"{name}: loop eager chunks {loop['eager']}, captures "
                    f"{loop['captures']}, replays {loop['replays']}; "
                    f"prewarms: search {st['acq_prewarm_s']:.4f} s "
                    f"(searched {st['acq_searched']}), seeder "
                    f"{st['seeder_prewarm_s']:.4f} s (ran "
                    f"{st['seeder_ran']}), tracker "
                    f"{st['track_prewarm_s']:.4f} s (captured "
                    f"{st['track_captured']}), the loop's wait "
                    f"{st['track_wait_s']:.4f} s; wall {wall:.4f} s; device "
                    f"memory reserved beyond the phase's start {held:.1f} "
                    "MB")
                gates(name, recv, res, launches)
                if loop["eager"] or loop["captures"]:
                    fail(f"{name}: the loop ran {loop['eager']} chunks "
                         f"eagerly and captured {loop['captures']}")
                if st["track_captured"] != (i == 1):
                    fail(f"{name}: the tracker prewarm captured "
                         f"{st['track_captured']} (want {i == 1})")
                runs.append(dict(loop=loop, stats=st, wall=wall,
                                 held_mb=held))
                results.append(res)
            ref = Receiver(c, device=dev)
            ref._tracker = graph.GraphedTracker(
                fs=c.fs, pll_gains=ref.pll_gains, dll_gains=ref.dll_gains,
                epochs_per_step=ref.epochs_per_step,
                agc_thresholds=ref.agc_thresholds, device=dev)
            ref._prewarm_track = lambda *args: None
            res_ref, wall_ref, _, _ = drive(
                f"prewarm {label}, private un-prewarmed tracker", ref, src(),
                duration)
            counts_ref = ref._tracker.counts()
            same = [same_result(r, res_ref) for r in results]
            log(f"prewarm {label}: private tracker eager chunks "
                f"{counts_ref['eager']}, captures {counts_ref['captures']}, "
                f"replays {counts_ref['replays']}, wall {wall_ref:.4f} s; "
                f"receivers 1 and 2 bit-identical to it: {same}")
            if not all(same):
                fail(f"prewarm {label}: a shared-tracker run differs from "
                     "the private tracker's")
            out[label] = dict(runs=runs, private=dict(counts=counts_ref,
                                                      wall=wall_ref))
    return out


def main() -> int:
    with contextlib.ExitStack() as stack:
        return run_phases(stack)


def run_phases(stack: contextlib.ExitStack) -> int:
    """Every phase; ``stack`` stops phase 16's scene workers and removes
    their folder on any exit."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpu_gnss_torch import PRESETS, ReceiverConfig, kernels
    from tpu_gnss_torch.acquire.folded import FoldedSearcher

    # phase 16's scenes build in worker processes while the card runs
    # phases 1-2b
    scene_dir = stack.enter_context(tempfile.TemporaryDirectory())
    pool = ProcessPoolExecutor(
        max_workers=min(len(SCENARIO_SCENES), max(1, os.cpu_count() - 2)),
        mp_context=multiprocessing.get_context("spawn"))
    stack.callback(pool.shutdown, cancel_futures=True)
    scenes = start_scenario_scenes(pool, scene_dir)

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
    rows = {k: len(FoldedSearcher(PRESETS[k], device=dev).dops_hz)
            for k in ("live", "hackrf", "rtlsdr")}
    shapes = {k: {} for k in ("fold_corr_reduce", "corr_reduce",
                              "track_corr", "mix_packed", "loop_update")}
    fold_e2e = shapes["fold_corr_reduce"]["e2e"] = check_fold(
        2.048e6, 41, 1, dev, "e2e")
    # the directed cold search's SV counts (phase 14 runs the first)
    for prns in (tuple(DIRECTED), tuple(range(1, 12))):
        shapes["fold_corr_reduce"][f"e2e {len(prns)} SVs"] = check_fold(
            2.048e6, 41, 1, dev, f"e2e-{len(prns)}sv", prns=prns)
    check_fold(2.048e6, 41, 8, dev, "e2e-weak")
    check_fold(5.456e6, 73, 1, dev, "nottingham")
    check_fold(PRESETS["synthetic"].fs, 49, 1, dev, "synthetic")
    check_fold(live.fs, rows["live"], 1, dev, "live")
    for k in ("hackrf", "rtlsdr"):
        shapes["fold_corr_reduce"][k] = check_fold(PRESETS[k].fs, rows[k], 1,
                                                   dev, k)
    # phase 16's wide-offset replay: the e2e rate on the +-100 kHz grid
    shapes["fold_corr_reduce"]["e2e-wide"] = check_fold(
        2.048e6, 801, 1, dev, "e2e-wide")
    profile_fold_split(dev)
    cr_e2e = shapes["corr_reduce"]["e2e"] = check_corr_reduce(
        2.048e6, 41, 1, dev, "e2e")
    check_corr_reduce(2.048e6, 41, 8, dev, "e2e-weak")
    check_corr_reduce(5.456e6, 73, 1, dev, "nottingham")
    check_corr_reduce(PRESETS["synthetic"].fs, 49, 1, dev, "synthetic")
    check_corr_reduce(live.fs, rows["live"], 1, dev, "live")
    check_corr_reduce(12.5e6, 41, 1, dev, "odd-n1")
    for k in ("hackrf", "rtlsdr"):
        shapes["corr_reduce"][k] = check_corr_reduce(PRESETS[k].fs, rows[k],
                                                     1, dev, k)
    cr_launches = drive_corr_reduce(dev)
    track_e2e = shapes["track_corr"]["e2e"] = check_track(2.048e6, dev, "e2e")
    check_track(5.456e6, dev, "nottingham")
    check_track(12.5e6, dev, "odd-n1")
    for k in ("hackrf", "rtlsdr"):
        shapes["track_corr"][k] = check_track(PRESETS[k].fs, dev, k)
    shapes["track_corr"]["e2e-spacing-0.25"] = check_track(
        2.048e6, dev, "e2e-spacing-0.25", spacing=0.25)
    mix_e2e = shapes["mix_packed"]["e2e"] = check_mix(
        2.048e6, 1.0, 2_048_000, 0, dev, "e2e")
    check_mix(5.456e6, 3.0, 5_456_000, 0, dev, "nottingham")
    check_mix(live.fs, live.lo_rate, 10_000_000 - 7, 1_000_000_007, dev,
              "live")
    # --- phase 2b: the links on the card ---------------------------------
    check_links(dev)
    # the scene workers end before the timed receiver runs begin: phases
    # 3-15 run on a host with no other work, as in earlier slices
    t0 = time.perf_counter()
    wait(list(scenes.values()))
    pool.shutdown()
    log(f"phase 16 scenes built; {time.perf_counter() - t0:.1f} s waited "
        "for them after phase 2b")

    by_run = {}
    with tempfile.TemporaryDirectory() as tmp:
        # --- phase 3: main path, e2e geometry ----------------------------
        fs = 2.048e6
        cfg = ReceiverConfig(fs=fs, fc=fs / 4, max_fo=5000.0, fft_len=4096,
                             snr_threshold=17.0, num_chans=12)
        path_e2e, path_e2e8, path_e2e_iq, rx = build_capture(
            cfg, 20.0, tmp, "e2e", iq8=True)
        # the process's first receiver prints its cold start's spans
        from tpu_gnss_torch.utils.metrics import METRICS
        with METRICS.recording():
            res, wall, launches = run_receiver(cfg, path_e2e, 20.0, "e2e")
        log_cold_spans("e2e", METRICS.drain()[0])
        decoded = [r for r in res.channels if r.eph.valid()]
        err = fix_error(res, rx)
        log(f"e2e: {len(res.detections)} detections "
            f"{sorted(d['prn'] for d in res.detections)}, "
            f"{len(decoded)} ephemerides, {len(res.solutions)} fixes, "
            f"final error {err:.2f} m")
        if len(res.detections) < 4 or len(decoded) < 4:
            fail("e2e: fewer than 4 detections or ephemerides")
        if not err < 60.0:
            fail(f"e2e: final fix error {err} m (limit 60 m)")
        by_run["e2e 1-bit 20 s"] = launches
        # --- phase 4: main path, nottingham geometry ---------------------
        cfg_n = ReceiverConfig(fs=5.456e6, fc=4.092e6, max_fo=5000.0,
                               num_chans=12)
        path_n, _, _, _ = build_capture(cfg_n, 4.0, tmp, "nottingham")
        res_n, wall_n, launches_n = run_receiver(cfg_n, path_n, 4.0,
                                                 "nottingham")
        locked = locked_prns(res_n)
        det_n = sorted(d["prn"] for d in res_n.detections)
        log(f"nottingham: {len(det_n)} detections {det_n}, locked {locked}")
        if len(det_n) < 4 or not set(det_n) <= set(locked):
            fail("nottingham: fewer than 4 detections, or detected "
                 "channels not locked")
        by_run["nottingham 1-bit 4 s"] = launches_n
        # --- phase 5: launch counters -----------------------------------
        for run, counts in (("e2e", launches), ("nottingham", launches_n)):
            need_launched(run, counts, RECEIVER_KERNELS)
        log("launch counters: every receiver kernel launched in both "
            "1-bit main-path runs")

        # --- phase 8: the e2e scene as an 8-bit I/Q capture --------------
        from tpu_gnss_torch.io.stream import IQFileSource
        from tpu_gnss_torch.receiver import Receiver
        res8, wall8, launches8, xfer8 = drive(
            "e2e iq8", Receiver(cfg, device=dev),
            IQFileSource(path_e2e8, fs, "int8"), 20.0)
        decoded8 = [r for r in res8.channels if r.eph.valid()]
        err8 = fix_error(res8, rx)
        log(f"e2e iq8: {len(res8.detections)} detections "
            f"{sorted(d['prn'] for d in res8.detections)}, "
            f"{len(decoded8)} ephemerides, {len(res8.solutions)} fixes, "
            f"final error {err8:.2f} m (int8 link: the capture's own bytes)")
        need_launched("e2e iq8", launches8, ("fold_corr_reduce",
                                             "track_corr", "loop_update"))
        if len(res8.detections) < 4 or len(decoded8) < 4 or not err8 < 60.0:
            fail(f"e2e iq8: fewer than 4 detections or ephemerides, or "
                 f"final fix error {err8} m (limit 60 m)")
        by_run["e2e int8 I/Q 20 s"] = launches8

        # --- phase 9: full width at the hackrf preset, every link --------
        runs9, scene9 = iq_preset_run("hackrf", 4.0, 25e3, True,
                                      ("int8", "int4", "int2", "float32"),
                                      tmp, dev)
        for link, r in runs9.items():
            by_run[f"hackrf {link} 4 s"] = r["launches"]
        # --- phase 10: the rtlsdr preset, uint8 through the int8 link ----
        runs10, scene10 = iq_preset_run("rtlsdr", 4.0, -18e3, False,
                                        ("int8",), tmp, dev)
        by_run["rtlsdr int8 4 s"] = runs10["int8"]["launches"]
        # --- phase 11: live mode ----------------------------------------
        by_run["live 1-bit follow 20 s"] = live_run(cfg, path_e2e, rx, 20.0,
                                                    tmp, dev)
        # --- phase 12: the gather correlator -----------------------------
        gather_run(cfg, path_e2e, dev)
        # --- phase 14: warm start ----------------------------------------
        warm = warm_start_phase(cfg, path_e2e, rx, tmp, dev)
        by_run["CLI --checkpoint e2e 20 s"] = warm["launches_checkpoint"]
        by_run["CLI --warm-start --tow e2e 8 s"] = warm["launches_cli"]
        by_run["warm directed 5 PRNs e2e 8 s"] = warm["launches"]
        # --- phase 15: the mesh on the card --------------------------------
        mesh = mesh_phase(cfg, path_e2e, rx, res, scene9, runs9, dev, tmp)
        for run, r in mesh["runs"].items():
            by_run[run] = r["launches"]
        # --- phase 13: gps_test on the card -------------------------------
        gps = gps_test_phase(tmp, dev)
        for mode, r in gps.items():
            by_run[f"gps_test {mode} nottingham {GPS_TEST_TIME_RUNS} runs"] = \
                r["launches"]
        # --- phase 16: the reference's receiver scenarios ----------------
        t16 = time.perf_counter()
        scen = scenarios_phase(cfg, path_e2e, path_e2e_iq, rx, scenes, tmp,
                               dev)
        for run, r in scen.items():
            by_run[run] = r["launches"]
        log(f"phase 16: {len(scen)} scenario runs in "
            f"{time.perf_counter() - t16:.1f} s, "
            f"{sum(r['wall'] for r in scen.values()):.1f} s of it in "
            "process_source")
        # --- phase 17: boot and in-loop trace -----------------------------
        t17 = time.perf_counter()
        boot_phase(cfg, path_e2e, rx, tmp)
        loop_trace(cfg, path_e2e, dev, tmp)
        log(f"phase 17: {time.perf_counter() - t17:.1f} s on {smi}")
        # --- phase 18: the tracking bank as one program per chunk ---------
        t18 = time.perf_counter()
        floor_ms = time_ms(lambda: torch.cuda._sleep(0))
        for name, fs_, n_chan, eps in LOOP_SHAPES:
            shapes["loop_update"][name] = check_loop_update(
                fs_, dev, name, n_chan, eps, floor_ms)
        loop_e2e = shapes["loop_update"]["e2e"]
        for gather in (False, True):
            graphed_vs_eager(cfg, path_e2e_iq, res, dev, gather=gather)
        _, per_step = retime_runs(cfg, path_e2e, path_e2e8, cfg_n, path_n,
                                  scene9, scene10, dev)
        if not per_step <= 3.5:
            fail(f"e2e receiver: {per_step:.2f} CUDA kernels and copies per "
                 "10 ms step (limit 3.5: 2 in the step, the rest the "
                 "chunk's copies and the search)")
        n_loop = launches["loop_update"]
        log(f"loop_update: {n_loop} launches in phase 3's e2e 20 s run, "
            f"{n_loop / 20.0:.1f} per second of signal; kernel "
            f"{loop_e2e['ms'] * 1e3:.2f} us, plain "
            f"{loop_e2e['plain_ms'] * 1e3:.2f} us, "
            f"{loop_bound_text(loop_e2e)}, launch floor "
            f"{floor_ms * 1e3:.2f} us")
        prewarm_phase(cfg, path_e2e, rx, scene9, runs9, dev)
        log(f"phase 18: {time.perf_counter() - t18:.1f} s on {smi}")

    # --- phase 6: the folded search API at the nottingham geometry ------
    folded_search(cfg_n, dev)
    # --- phase 7: the batched capture scan --------------------------------
    scan = batched_scan(PRESETS["synthetic"], dev)
    log(f"batched scan rate: {scan['rate']:.1f} Msample*PRN*bin/s "
        f"({scan['ms']:.1f} ms for 64 blocks) on {smi}")

    e2e_run = "e2e receiver run (phase 3)"
    entry = lambda name: dict(
        launches_by_run={run: c[name] for run, c in by_run.items()},
        shapes=shapes[name])
    kern = [
        dict(name="fold_corr_reduce", route="cuda",
             source="tpu_gnss_torch/csrc/fold_corr_reduce.cu",
             replaces="tpu_gnss/ops/mxu_corr.py:377",
             launches=launches["fold_corr_reduce"], launch_run=e2e_run,
             **fold_e2e, **entry("fold_corr_reduce")),
        dict(name="track_corr", route="cuda",
             source="tpu_gnss_torch/csrc/track_corr.cu",
             replaces="tpu_gnss/ops/mxu_track.py:376",
             launches=launches["track_corr"], launch_run=e2e_run,
             **track_e2e, **entry("track_corr")),
        dict(name="mix_packed", route="cuda",
             source="tpu_gnss_torch/csrc/mix_packed.cu",
             replaces="tpu_gnss/ops/onebit.py:175",
             launches=launches["mix_packed"], launch_run=e2e_run,
             **mix_e2e, **entry("mix_packed")),
        dict(name="corr_reduce", route="cuda",
             source="tpu_gnss_torch/csrc/corr_reduce.cu",
             replaces="tpu_gnss/ops/mxu_corr.py:430",
             launches=cr_launches,
             launch_run="op call at the e2e shape (no caller in either "
                        "package)", **cr_e2e, shapes=shapes["corr_reduce"]),
        dict(name="loop_update", route="cuda",
             source="tpu_gnss_torch/csrc/loop_update.cu",
             replaces="tpu_gnss/track/channel.py:323 (the lax.scan body at "
                      ":543; no Pallas kernel)",
             launches=n_loop, launch_run=e2e_run, **loop_e2e,
             **entry("loop_update")),
    ]
    log(smi)                  # as nvidia-smi gives it
    print(json.dumps({"kernels": kern}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
