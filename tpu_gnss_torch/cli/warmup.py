"""Boot warmup: build the kernel library before a session's first chunk.

The counterpart of ``python -m tpu_gnss.cli.warmup``
(tpu_gnss/cli/warmup.py).  The reference ships a pre-built FPGA
bitstream that every field boot just loads (reference:
c/main.cpp:14-38); here the pre-built artifact is the CUDA kernel
library.  On the card this CLI builds it into the cache root (``nvcc``,
one process per source) and then runs the streaming pipeline once over
seed-0 noise at the session's geometry, the reference's own recipe, so
the cold search, its weak-signal escalation and the chosen format's
upload path all launch once.  A later session in the same cache root
(``$TPU_GNSS_TORCH_CACHE_DIR``, or ``build/tpu_gnss_torch/`` beside the
package) loads the library instead of compiling it in the middle of its
first chunk.

Usage::

    python -m tpu_gnss_torch.cli.warmup --preset nottingham
    python -m tpu_gnss_torch.cli.warmup 4.092e6 5.456e6 5000 \\
        --channels 12 --chunk-s 4 --format 1bit --cache-dir /var/cache/gnss

Run it once per (code version, cache root); it is idempotent, and
cheap when the library is already there.  On the CPU it runs the pass,
builds nothing, and says so.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

from .. import kernels
from ..config import PRESETS, ReceiverConfig
from ..device import resolve_device
from ..io import loaders
from ..io.stream import FileSource1Bit, IQFileSource
from ..receiver import Receiver

RECEIVER_KERNELS = ("fold_corr_reduce", "track_corr", "mix_packed",
                    "loop_update")


def write_noise(path: str, fmt: str, n: int, cfg: ReceiverConfig):
    """``n`` samples of seed-0 noise written as a ``fmt`` capture
    (tpu_gnss/cli/warmup.py:85-101); the source that replays it."""
    rng = np.random.default_rng(0)
    if fmt == "1bit":
        bits = rng.integers(0, 2, n, dtype=np.uint8)
        with open(path, "wb") as f:
            f.write(loaders.pack_1bit(bits))
        return FileSource1Bit(path, cfg)
    dtype = "int8" if fmt == "iq8" else "uint8"
    raw = rng.integers(0, 256, 2 * n).astype(np.uint8)
    if dtype == "int8":
        raw = raw.view(np.int8)
    raw.tofile(path)
    return IQFileSource(path, cfg.fs, dtype=dtype)


def noise_pass(cfg: ReceiverConfig, fmt: str, chunk_s: float, device):
    """The receiver once over two chunks of noise (tpu_gnss/cli/
    warmup.py:79-101): the cold search finds nothing and escalates, a
    tracking chunk is dispatched and drained, and the format's upload
    path runs.  Returns the receiver's result."""
    chunk_s = max(chunk_s, 1.0)
    n = int(2 * chunk_s * cfg.fs)
    with tempfile.TemporaryDirectory(prefix="tpu_gnss_torch_warm_") as td:
        src = write_noise(os.path.join(td, "noise.bin"), fmt, n, cfg)
        return Receiver(cfg, device=device).process_source(src,
                                                           chunk_s=chunk_s)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="warmup",
        description="build the CUDA kernel library and run the receiver "
                    "once over noise at a capture geometry")
    p.add_argument("fc", type=float, nargs="?", default=4.092e6)
    p.add_argument("fs", type=float, nargs="?", default=5.456e6)
    p.add_argument("max_fo", type=float, nargs="?", default=5000.0)
    p.add_argument("--preset", default=None, choices=sorted(PRESETS))
    p.add_argument("--format", choices=["1bit", "iq8", "iqu8"],
                   default="1bit")
    p.add_argument("--channels", type=int, default=12)
    p.add_argument("--chunk-s", type=float, default=4.0)
    p.add_argument("--fft-len", type=int, default=40000)
    p.add_argument("--threshold", type=float, default=25.0)
    p.add_argument("--cache-dir", default=None,
                   help=f"the kernel library's cache root (default: "
                        f"${kernels.CACHE_ENV} or build/tpu_gnss_torch/)")
    p.add_argument("--device", default="cuda",
                   help="torch device for the device stages (default "
                        "cuda; there is no silent CPU fallback)")
    args = p.parse_args(argv)

    if args.cache_dir:
        os.environ[kernels.CACHE_ENV] = args.cache_dir
    if args.preset:
        base = PRESETS[args.preset]
        args.fc, args.fs, args.max_fo = base.fc, base.fs, base.max_fo
    cfg = ReceiverConfig(fs=args.fs, fc=args.fc, max_fo=args.max_fo,
                         fft_len=args.fft_len,
                         snr_threshold=args.threshold,
                         num_chans=args.channels)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        kernels.lib()           # a failed build or load raises here
        path = kernels.library_path()
        nvcc = ("cached" if kernels.BUILD_SECONDS is None
                else f"nvcc {kernels.BUILD_SECONDS:.2f} s")
        library = f"kernel library {path.name} in {path.parent} ({nvcc})"
    else:
        library = ("no kernel library built: the CPU runs the kernels' "
                   "plain versions")

    kernels.LAUNCHES.reset()
    t0 = time.perf_counter()
    noise_pass(cfg, args.format, args.chunk_s, dev)
    t_run = time.perf_counter() - t0
    launches = " ".join(f"{k}={kernels.LAUNCHES.get(k)}"
                        for k in RECEIVER_KERNELS)
    print(f"warmup: pipeline pass {t_run:.1f}s on {dev}; {library}; "
          f"launches {launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
