# Copied from tpu_gnss/cli/convert.py:1-90 (the whole module).
"""Capture-format conversion CLI.

One tool covering the reference's MATLAB conversion scripts
(reference: gps_bin1bit_log2bin.m, proc_rtl_bin_for_gps.m,
proc_hackrf_bin_for_gps.m, gps_wav_log2bin.m and the
conv_1bit_bin_to_hackrf_bin binary): every converter streams
file-to-file (native C++ where a toolchain exists) so arbitrarily long
captures convert in bounded memory.

    python -m tpu_gnss_torch.cli.convert 1bit-to-iq8 in.bin out.bin --fs 5.456e6
    python -m tpu_gnss_torch.cli.convert rtlsdr-to-1bit in.bin out.bin \\
        --fc 0.62e6 --fs 2.8e6
    python -m tpu_gnss_torch.cli.convert hackrf-to-1bit in.bin out.bin
    python -m tpu_gnss_torch.cli.convert wav-to-1bit in.wav out.bin
"""

from __future__ import annotations

import argparse
import os
import sys

from ..io import loaders


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpu_gnss_torch.cli.convert", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    c1 = sub.add_parser("1bit-to-iq8",
                        help="1-bit IF capture -> int8 I/Q for playback "
                             "(gps_bin1bit_log2bin.m)")
    c1.add_argument("in_file")
    c1.add_argument("out_file")
    c1.add_argument("--fs", type=float, default=5.456e6)
    c1.add_argument("--gain", type=int, default=100)

    c2 = sub.add_parser("rtlsdr-to-1bit",
                        help="rtl-sdr uint8 I/Q -> 1-bit IF "
                             "(proc_rtl_bin_for_gps.m)")
    c2.add_argument("in_file")
    c2.add_argument("out_file")
    c2.add_argument("--fc", type=float, default=0.62e6)
    c2.add_argument("--fs", type=float, default=2.8e6)
    c2.add_argument("--no-mix", action="store_true",
                    help="tuned-offset branch: take the real rail "
                         "directly (1574.8 MHz captures)")

    c3 = sub.add_parser("hackrf-to-1bit",
                        help="HackRF int8 I/Q -> 1-bit IF "
                             "(proc_hackrf_bin_for_gps.m)")
    c3.add_argument("in_file")
    c3.add_argument("out_file")
    c3.add_argument("--fc", type=float, default=2.6e6)
    c3.add_argument("--fs", type=float, default=10e6)

    c4 = sub.add_parser("wav-to-1bit",
                        help="HDSDR stereo WAV -> 1-bit IF "
                             "(gps_wav_log2bin.m); prints the wav rate")
    c4.add_argument("in_file")
    c4.add_argument("out_file")

    args = p.parse_args(argv)
    if not os.path.exists(args.in_file):
        print(f"error: capture file not found: {args.in_file}",
              file=sys.stderr)
        return 2

    if args.cmd == "1bit-to-iq8":
        loaders.convert_1bit_to_iq8(args.in_file, args.out_file,
                                    fs=args.fs, gain=args.gain)
    elif args.cmd == "rtlsdr-to-1bit":
        loaders.convert_rtlsdr_to_1bit(args.in_file, args.out_file,
                                       fc=args.fc, fs=args.fs,
                                       mix=not args.no_mix)
    elif args.cmd == "hackrf-to-1bit":
        loaders.convert_hackrf_to_1bit(args.in_file, args.out_file,
                                       fc=args.fc, fs=args.fs)
    elif args.cmd == "wav-to-1bit":
        fs = loaders.convert_wav_to_1bit(args.in_file, args.out_file)
        print(f"wav rate: {fs:g} Hz")
    size = os.path.getsize(args.out_file)
    print(f"wrote {args.out_file} ({size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
