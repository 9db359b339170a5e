"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero and
prints no result line):

1. Card and software: ``nvidia-smi`` name and power limit, torch and
   CUDA versions, and the seconds the kernel build took.
2. Each CUDA kernel against its plain PyTorch version on the card, at
   the main path's shapes, then the median time of both (CUDA events).
3. The main path at the e2e geometry: a 20 s, 6-SV, 2.048 Msps 1-bit
   capture through ``Receiver(device="cuda").process_source``; it must
   give >=4 detections, >=4 ephemerides and a fix within 60 m.
4. The main path at the ``nottingham`` geometry (4 s at 5.456 Msps,
   NF 16384): >=4 detections and those channels locked.
5. Launch counters: every kernel launched in both main-path runs.

The last two lines are a JSON object describing the kernels and the
result line ``{"ok": true, "device": {...}}``.  In the kernels line,
``max_abs_err`` is in the kernel's own output units and ``max_rel_err``
is the error that the tolerance bounds: max |dpeak|/peak for
``fold_corr_reduce``, max error / max|P| for ``track_corr``.  Exits non-zero without
a card, and where the ``tpu_gnss_torch`` package is not beside it.
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


def check_fold(fs, rows, n_acc, dev, label):
    from tpu_gnss_torch.ops import mxu_corr as mc
    args, kw = fold_case(fs, rows, n_acc, dev, seed=rows + n_acc)
    pk, lg, tt = (a.cpu() for a in mc.fold_corr_reduce(*args, **kw))
    torch.cuda.synchronize()
    ppk, plg, ptt = (a.cpu() for a in mc.fold_corr_reduce_plain(*args, **kw))
    # peaks are |corr|^2 sums of order 1e13 here, so the absolute error
    # is large in these units; the relative error says whether parity held
    err = float((pk - ppk).abs().max())
    rel = float(((pk - ppk).abs() / ppk).max())
    if not torch.equal(lg, plg):
        fail(f"fold_corr_reduce {label}: lags differ in "
             f"{int((lg != plg).sum())} cells")
    np.testing.assert_allclose(pk.numpy(), ppk.numpy(), **FOLD_TOL)
    np.testing.assert_allclose(tt.numpy(), ptt.numpy(), **FOLD_TOL)
    ms = time_ms(lambda: mc.fold_corr_reduce(*args, **kw))
    plain_ms = time_ms(lambda: mc.fold_corr_reduce_plain(*args, **kw))
    log(f"fold_corr_reduce {label}: rows={rows} n_sv=32 nf={kw['nf']} "
        f"n_acc={n_acc} lags equal, max |dpeak| {err:.4e} of peaks up to "
        f"{float(ppk.max()):.4e}, max rel err {rel:.3e} (rtol "
        f"{FOLD_TOL['rtol']}), kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return dict(max_abs_err=err, max_rel_err=rel, ms=ms, plain_ms=plain_ms)


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
                for k in ("fold_corr_reduce", "track_corr")}
    log(f"{name}: wall {wall:.3f} s for {duration:g} s of signal, "
        f"realtime factor {duration / wall:.2f}, launches {launches}")
    return res, rx, wall, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpu_gnss_torch import ReceiverConfig, kernels
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
    fold_e2e = check_fold(2.048e6, 41, 1, dev, "e2e")
    check_fold(2.048e6, 41, 8, dev, "e2e-weak")
    check_fold(5.456e6, 73, 1, dev, "nottingham")
    track_e2e = check_track(2.048e6, dev, "e2e")
    check_track(5.456e6, dev, "nottingham")
    check_track(12.5e6, dev, "odd-n1")

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
    log("launch counters: every kernel launched in both main-path runs")

    kern = [
        dict(name="fold_corr_reduce", route="cuda",
             source="tpu_gnss_torch/csrc/fold_corr_reduce.cu",
             replaces="tpu_gnss/ops/mxu_corr.py:377",
             launches=launches["fold_corr_reduce"], **fold_e2e),
        dict(name="track_corr", route="cuda",
             source="tpu_gnss_torch/csrc/track_corr.cu",
             replaces="tpu_gnss/ops/mxu_track.py:376",
             launches=launches["track_corr"], **track_e2e),
    ]
    log(smi)                  # as nvidia-smi gives it
    print(json.dumps({"kernels": kern}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
