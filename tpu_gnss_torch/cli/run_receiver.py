"""Full-receiver CLI on the port: a 1-bit capture file in, fixes out.

    python -m tpu_gnss_torch.cli.run_receiver <file> [fc fs max_fo]
        [--preset NAME] [--duration S] [--threshold T] [--channels N]
        [--fft-len N] [--device cuda|cuda:1|cpu]

The counterpart of ``python -m tpu_gnss.cli.run_receiver`` for bit-packed
1-bit IF captures; the other formats, links, live and warm-start options
are not ported yet.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..config import PRESETS, ReceiverConfig
from ..io.stream import FileSource1Bit
from ..receiver import Receiver
from ..track.quality import pll_lock_metric
from ..utils.metrics import METRICS


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="gps_receiver_torch",
        description="GPS receiver on PyTorch/CUDA over a 1-bit capture")
    p.add_argument("filename", help="bit-packed 1-bit IF capture file")
    p.add_argument("fc", type=float, nargs="?", default=4.092e6)
    p.add_argument("fs", type=float, nargs="?", default=5.456e6)
    p.add_argument("max_fo", type=float, nargs="?", default=5000.0)
    p.add_argument("--preset", default=None, choices=sorted(PRESETS),
                   help="named capture preset for fc/fs/max_fo "
                        "(overrides the positional values)")
    p.add_argument("--duration", type=float, default=None,
                   help="seconds of capture to process")
    p.add_argument("--threshold", type=float, default=25.0)
    p.add_argument("--channels", type=int, default=12)
    p.add_argument("--fft-len", type=int, default=40000,
                   help="acquisition window length in samples")
    p.add_argument("--device", default="cuda",
                   help="torch device for the device stages (default "
                        "cuda; there is no silent CPU fallback)")
    args = p.parse_args(argv)
    if not os.path.exists(args.filename):
        print(f"error: capture file not found: {args.filename}",
              file=sys.stderr)
        return 2
    if args.preset:
        base = PRESETS[args.preset]
        args.fc, args.fs, args.max_fo = base.fc, base.fs, base.max_fo
    cfg = ReceiverConfig(fs=args.fs, fc=args.fc, max_fo=args.max_fo,
                         fft_len=args.fft_len, snr_threshold=args.threshold,
                         num_chans=args.channels)
    recv = Receiver(cfg, device=args.device)
    with METRICS.stage("receiver.total"):
        result = recv.process_source(FileSource1Bit(args.filename, cfg),
                                     max_duration_s=args.duration)

    print(f"acquired {len(result.detections)} SVs:")
    for d in result.detections:
        print(f"  PRN {d['prn']:2d}  snr {d['snr']:7.1f}  "
              f"dopp {d['doppler_hz']:+8.1f} Hz  ca {d['ca_shift']:7.1f}")
    print("\nchannels:")
    for r in result.channels:
        lock = (pll_lock_metric(r.ip_hist, r.qp_hist, window=1000)
                if r.n_epochs else 0.0)
        rssi = (float(np.sqrt(np.mean(np.square(r.ip_hist[-50:]))))
                if r.n_epochs else 0.0)
        state = ("lost" if r.lost else "eph" if r.eph.valid()
                 else f"sf{len(r.subframes)}" if r.subframes else "track")
        print(f"  ch {r.ch:2d} PRN {r.prn:2d}  rssi {rssi:8.0f}  "
              f"lock {lock:+.2f}  [{state}]")
    if result.solutions:
        print("\nfixes (n_sats, t_rx, lat, lon, alt):")
        for s in result.solutions:
            print(f"  {s.n_sats} {s.t_rx:12.3f} {s.lat_deg:10.5f} "
                  f"{s.lon_deg:10.5f} {s.alt_m:8.2f}")
    else:
        print("\nno position fix (need >=4 decoded ephemerides; capture "
              "must span >=3 subframes / ~18 s of NAV data)")
    print("\n" + METRICS.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
