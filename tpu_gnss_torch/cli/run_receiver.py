"""Full-receiver CLI on the port: a capture (or a live stream) in, fixes out.

    python -m tpu_gnss_torch.cli.run_receiver <file|rtltcp://host:port>
        [fc fs max_fo] [--preset NAME] [--format 1bit|iq8|iqu8]
        [--link int8|int4|int2|float32] [--duration S] [--threshold T]
        [--channels N] [--fft-len N] [--follow] [--stall-timeout S]
        [--max-lag S] [--max-history S] [--if-offset HZ|auto]
        [--nmea-out FILE] [--iq-log FILE.npz] [--checkpoint FILE.npz]
        [--warm-start FILE.npz] [--no-directed] [--tow SEC]
        [--rtl-freq HZ] [--rtl-gain DB] [--rtl-ppm PPM]
        [--mesh-devices N] [--device cuda|cuda:1|cpu]

The counterpart of ``python -m tpu_gnss.cli.run_receiver``
(tpu_gnss/cli/run_receiver.py); it prints the same report.
``--mesh-devices N`` runs the receiver on a mesh of N devices of the
``--device`` type (N CPU entries, or cards 0..N-1).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..config import PRESETS, ReceiverConfig
from ..io.stream import (FileSource1Bit, FollowIQSource, FollowSource1Bit,
                         IQFileSource, RtlTcpSource)
from ..nav.almanac import visible_prns
from ..receiver import TRANSFER_DTYPES, Receiver
from ..utils import metrics
from ..utils.checkpoint import load_state, save_state
from ..utils.metrics import METRICS
from . import nmea_out


def _rtltcp_source(args):
    """``rtltcp://host:port`` -> a connected :class:`RtlTcpSource`, or an
    error message (tpu_gnss/cli/run_receiver.py:135-167)."""
    from urllib.parse import urlsplit
    u = urlsplit(args.filename)       # handles IPv6 [::1]:port too
    try:
        port = u.port                 # raises on a non-numeric port
    except ValueError:
        port = None
    if port is None:
        return None, (f"{args.filename}: rtltcp URL needs host:port "
                      "(e.g. rtltcp://127.0.0.1:1234)")
    if args.max_lag is not None:
        print("warning: --max-lag has no effect on rtltcp:// sources (TCP "
              "backpressure is the flow control)", file=sys.stderr)
    try:
        src = RtlTcpSource(u.hostname or "127.0.0.1", port, args.fs,
                           freq_hz=args.rtl_freq, gain_db=args.rtl_gain,
                           ppm=args.rtl_ppm,
                           stall_timeout_s=args.stall_timeout)
    except (OSError, ValueError) as e:
        return None, f"rtl_tcp connect failed: {e}"
    print(f"rtl_tcp: connected to {u.netloc} (tuner type {src.tuner_type}, "
          f"{src.tuner_gain_count} gain steps), fs={args.fs:g}, "
          f"freq={args.rtl_freq:g}")
    return src, None


def _warm_start(args, cfg):
    """``(warm ephemerides, directed PRNs or None)`` from the
    ``--warm-start`` checkpoint, with the almanac visibility prediction at
    the checkpoint's fix TOW aged by wall time, or at ``--tow``
    (tpu_gnss/cli/run_receiver.py:183-228)."""
    # the ephemerides and almanac are host data: channel state, if the file
    # holds any, stays on the CPU
    state = load_state(args.warm_start, device="cpu")
    warm = state.get("ephemerides")
    print(f"warm start: ephemerides for PRNs {sorted(warm or {})}")
    # almanac-directed cold search: a stored almanac plus the last fix
    # predicts which PRNs are above the horizon now, so the sweep covers
    # the visible subset instead of all 32 (with in-receiver fallback to
    # the full sweep if it under-delivers)
    alms = state.get("almanac")
    last = (state.get("meta") or {}).get("last_fix")
    if args.no_directed or not alms or not last:
        return warm, None
    # the stored TOW is the previous session's time: predict at the
    # checkpoint time + elapsed wall clock.  Checkpoints without a wall
    # timestamp cannot be aged; prediction then runs at the stored TOW
    tow = float(last["tow"])
    wall = last.get("wall")
    if args.tow is not None:
        tow = float(args.tow)
    elif wall is not None:
        age = max(0.0, time.time() - float(wall))
        tow = (tow + age) % 604800.0
        if age > 60.0:
            print(f"warm start: advancing visibility time by "
                  f"{age/60.0:.1f} min since checkpoint")
    pred = visible_prns(alms, last["ecef"], tow, mask_deg=5.0,
                        margin_s=1800.0)
    # only a non-empty proper subset directs the sweep (process_source
    # discards anything else): say which it is
    if pred and set(pred) < set(cfg.prns):
        print(f"directed search: almanac predicts PRNs {pred} "
              f"visible ({len(alms)} almanac entries)")
        return warm, pred
    why = ("no PRNs predicted visible (stale fix/time?)"
           if not pred else "all PRNs predicted visible")
    print(f"almanac present but {why}; running the full "
          f"{len(cfg.prns)}-PRN sweep")
    return warm, None


def _report(args, result, recv, cfg) -> None:
    """The end-of-run report of tpu_gnss/cli/run_receiver.py:275-349:
    detections, channel bars, fixes with the DMS and GPS day-time pages,
    the I/Q constellation, NMEA and checkpoint lines."""
    print(f"\nacquired {len(result.detections)} SVs:")
    for d in result.detections:
        print(f"  PRN {d['prn']:2d}  snr {d['snr']:7.1f}  "
              f"dopp {d['doppler_hz']:+8.1f} Hz  ca {d['ca_shift']:7.1f}")

    live = [r for r in result.channels if not r.lost]
    if live:
        prns = [r.prn for r in live]
        pows = [float(np.mean(np.square(np.asarray(r.ip_hist[-50:]))))
                if len(r.ip_hist) else 0.0 for r in live]
        stat = []
        for r in live:
            base = ("eph" if r.eph.valid() else
                    (f"sf{len(r.subframes)}" if r.subframes else "track"))
            if r.cn0_dbhz and r.cn0_dbhz == r.cn0_dbhz:
                base += f" {r.cn0_dbhz:.0f}dBHz"
            stat.append(base)
        print("\n" + metrics.channel_bars(prns, pows, statuses=stat))

    if result.solutions:
        print("\nfixes (n_sats, iters, t_bias, lat, lon, alt):")
        for s in result.solutions:
            print("  " + metrics.solution_line(s))
        # the reference LCD's DMS + day/time pages (c/user.cpp:160-201)
        last = result.solutions[-1]
        print("  " + metrics.latlon_dms(last.lat_deg, last.lon_deg))
        week = next((r.eph.week for r in result.channels
                     if r.eph.valid()), None)
        if week is not None:
            print("  " + metrics.gps_day_time(int(week), last.t_rx))
    else:
        print("\nno position fix (need >=4 decoded ephemerides; capture "
              "must span >=3 subframes / ~18 s of NAV data)")

    if args.iq_log:
        tracked = [r for r in result.channels if len(r.ip_hist)]
        if tracked:
            metrics.save_iq_log(args.iq_log, tracked)
            best = max(tracked, key=lambda r: float(
                np.mean(np.square(np.asarray(r.ip_hist[-200:])))))
            # skip the pull-in transient when there is history beyond it
            skip = 200 if len(best.ip_hist) > 400 else 0
            print(f"\nIQ log ({len(tracked)} channels) -> {args.iq_log}; "
                  f"PRN {best.prn} prompt constellation:")
            print(metrics.iq_scatter_ascii(best.ip_hist[skip:],
                                           best.qp_hist[skip:]))

    if args.nmea_out:
        week = next((int(r.eph.week) for r in result.channels
                     if r.eph.valid()), None)
        n = nmea_out.write_track(args.nmea_out, result.solutions, week=week)
        print(f"\n{n} NMEA sentences -> {args.nmea_out}")

    if args.checkpoint:
        meta = dict(fs=cfg.fs, fc=cfg.fc, file=args.filename)
        if result.solutions:
            s = result.solutions[-1]
            # the wall timestamp lets the next session age the TOW before
            # predicting visibility
            meta["last_fix"] = dict(ecef=[s.x, s.y, s.z], tow=float(s.t_rx),
                                    wall=time.time())
        save_state(args.checkpoint,
                   ephemerides={r.prn: r.eph for r in result.channels
                                if r.eph.valid()},
                   detections=result.detections, almanac=recv.almanac,
                   meta=meta)
        print(f"\nstate saved to {args.checkpoint}"
              + (f" ({len(recv.almanac)} almanac entries)"
                 if recv.almanac else ""))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="gps_receiver_torch",
        description="GPS receiver on PyTorch/CUDA over a capture file or a "
                    "live stream")
    p.add_argument("filename",
                   help="capture file, or rtltcp://host:port for live SDR "
                        "ingest from an rtl_tcp server")
    p.add_argument("fc", type=float, nargs="?", default=4.092e6)
    p.add_argument("fs", type=float, nargs="?", default=5.456e6)
    p.add_argument("max_fo", type=float, nargs="?", default=5000.0)
    p.add_argument("--preset", default=None, choices=sorted(PRESETS),
                   help="named capture preset for fc/fs/max_fo "
                        "(overrides the positional values)")
    p.add_argument("--format", choices=["1bit", "iq8", "iqu8"],
                   default="1bit",
                   help="capture format: bit-packed 1-bit IF, interleaved "
                        "int8 I/Q (HackRF) or uint8 I/Q (rtl-sdr)")
    p.add_argument("--link", choices=list(TRANSFER_DTYPES), default="int8",
                   help="host->device link of 8-bit I/Q captures: int8 = "
                        "the capture's own bytes, int4 = packed nibbles, "
                        "int2 = 2-bit sign/magnitude codes.  1-bit "
                        "captures always cross as packed words")
    p.add_argument("--duration", type=float, default=None,
                   help="seconds of capture to process")
    p.add_argument("--threshold", type=float, default=25.0)
    p.add_argument("--channels", type=int, default=12)
    p.add_argument("--fft-len", type=int, default=40000,
                   help="acquisition window length in samples")
    p.add_argument("--follow", action="store_true",
                   help="live mode: tail the capture while it grows, "
                        "printing fixes in-stream; ends on a <file>.done "
                        "sidecar or --stall-timeout of no growth")
    p.add_argument("--stall-timeout", type=float, default=5.0,
                   help="--follow / rtltcp: seconds without data before "
                        "the stream is declared stalled")
    p.add_argument("--max-lag", type=float, default=None, metavar="SEC",
                   help="--follow: skip ahead when the reader falls more "
                        "than SEC behind the writer")
    p.add_argument("--max-history", type=float, default=None, metavar="SEC",
                   help="bound per-channel history to SEC seconds (600 "
                        "under --follow, unbounded otherwise)")
    p.add_argument("--if-offset", default="auto", metavar="HZ|auto",
                   help="TX/RX oscillator offset of a replay capture (Hz); "
                        "'auto' estimates it from the cold-start Doppler "
                        "median when that exceeds 10 kHz, 0 disables")
    p.add_argument("--nmea-out", default=None, metavar="FILE.nmea",
                   help="write fixes as NMEA GGA/GSA/GSV/RMC/VTG/GST")
    p.add_argument("--iq-log", default=None, metavar="FILE.npz",
                   help="dump per-channel prompt I/Q and code-rate "
                        "histories and print a constellation scatter of "
                        "the strongest channel")
    p.add_argument("--checkpoint", default=None, metavar="FILE.npz",
                   help="write receiver state (npz) here at the end")
    p.add_argument("--warm-start", default=None, metavar="FILE.npz",
                   help="load ephemerides from a previous checkpoint; a "
                        "fix then needs one subframe (~7 s) instead of "
                        "three (~20 s).  With a stored almanac and last "
                        "fix, the cold search is also directed to the "
                        "predicted-visible PRNs")
    p.add_argument("--no-directed", action="store_true",
                   help="disable the almanac-directed search even when "
                        "the warm-start checkpoint could support it")
    p.add_argument("--tow", type=float, default=None, metavar="SEC",
                   help="override the GPS time of week of the almanac "
                        "visibility prediction (default: the checkpoint's "
                        "fix TOW advanced by elapsed wall time)")
    p.add_argument("--rtl-freq", type=float, default=1575.42e6,
                   metavar="HZ", help="rtl_tcp tuner center frequency")
    p.add_argument("--rtl-gain", type=float, default=None, metavar="DB",
                   help="rtl_tcp manual tuner gain in dB (default: AGC)")
    p.add_argument("--rtl-ppm", type=int, default=0,
                   help="rtl_tcp frequency correction, ppm")
    p.add_argument("--mesh-devices", type=int, default=None, metavar="N",
                   help="distributed mode: run acquisition Doppler-sharded "
                        "and the tracking bank channel-sharded over N "
                        "devices of the --device type (N must divide the "
                        "channel count)")
    p.add_argument("--device", default="cuda",
                   help="torch device for the device stages (default "
                        "cuda; there is no silent CPU fallback)")
    args = p.parse_args(argv)
    is_net = args.filename.startswith("rtltcp://")
    if not is_net and not args.follow and not os.path.exists(args.filename):
        # --follow waits for the writer to create the file instead
        print(f"error: capture file not found: {args.filename}",
              file=sys.stderr)
        return 2
    if args.preset:
        base = PRESETS[args.preset]
        args.fc, args.fs, args.max_fo = base.fc, base.fs, base.max_fo
    cfg = ReceiverConfig(fs=args.fs, fc=args.fc, max_fo=args.max_fo,
                         fft_len=args.fft_len, snr_threshold=args.threshold,
                         num_chans=args.channels)
    iq_dtype = "int8" if args.format == "iq8" else "uint8"
    if is_net:
        src, err = _rtltcp_source(args)
        if src is None:
            print(f"error: {err}", file=sys.stderr)
            return 2
        args.follow = True     # in-stream solving and live fix printing
    elif args.follow:
        src = (FollowSource1Bit(args.filename, cfg,
                                stall_timeout_s=args.stall_timeout,
                                max_lag_s=args.max_lag)
               if args.format == "1bit" else
               FollowIQSource(args.filename, args.fs, dtype=iq_dtype,
                              stall_timeout_s=args.stall_timeout,
                              max_lag_s=args.max_lag))
    elif args.format == "1bit":
        src = FileSource1Bit(args.filename, cfg)
    else:
        src = IQFileSource(args.filename, args.fs, dtype=iq_dtype)

    warm, search_prns = (_warm_start(args, cfg) if args.warm_start
                         else (None, None))
    max_hist = args.max_history
    if max_hist is None and args.follow:
        max_hist = 600.0        # a live receiver must not grow unboundedly
    if_off = (args.if_offset if args.if_offset == "auto"
              else float(args.if_offset))
    mesh = None
    if args.mesh_devices:
        from ..dist.shard import make_mesh
        mesh = make_mesh(args.mesh_devices, axes=("dop",),
                         device=torch.device(args.device).type)
    recv = Receiver(cfg, max_history_s=max_hist, mesh=mesh,
                    if_offset_hz=if_off, transfer_dtype=args.link,
                    device=args.device)
    on_sol = live_nmea = None
    if args.follow:
        live_nmea = open(args.nmea_out, "w") if args.nmea_out else None

        def on_sol(s):
            print(f"[fix t={s.snap_epoch / 1000:7.1f}s] "
                  + metrics.solution_line(s), flush=True)
            if live_nmea is not None:
                # each burst as the fix lands; the end-of-run write_track
                # below rewrites the file complete
                for ln in nmea_out.solution_burst(s, week=None):
                    live_nmea.write(ln + "\r\n")
                live_nmea.flush()
    try:
        with METRICS.stage("receiver.total"):
            result = recv.process_source(src, max_duration_s=args.duration,
                                         warm_ephemerides=warm,
                                         search_prns=search_prns,
                                         on_solution=on_sol)
    finally:
        if live_nmea is not None:
            live_nmea.close()
    if args.follow:
        err = getattr(src, "error", None)
        why = ("stalled (no growth)" if getattr(src, "stalled", False)
               else f"connection error ({err})" if err
               else "end of stream")
        skipped = getattr(getattr(src, "reader", None), "skipped_bytes", 0)
        print(f"\nfollow ended: {why}; worst lag "
              f"{getattr(src, 'max_lag_s', 0.0):.2f}s"
              + (f", skipped {skipped} bytes" if skipped else ""))

    _report(args, result, recv, cfg)
    print("\n" + METRICS.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
