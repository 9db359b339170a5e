"""Stage timers for the port's receiver.

Copied from tpu_gnss/utils/metrics.py (``Metrics`` / ``METRICS``, and
``solution_line`` and ``save_iq_log`` from lines 110-120 and 200-222);
that package's ``__init__`` imports jax.  Stage times are host wall clock:
a stage that enqueues device work without waiting measures the enqueue.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Optional

import numpy as np


class Metrics:
    """Process-wide stage timing + counter registry (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.timings = defaultdict(list)   # stage -> [seconds]
        self.counters = defaultdict(float)  # name -> value

    @contextlib.contextmanager
    def stage(self, name: str, samples: Optional[int] = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.timings[name].append(dt)
                if samples is not None:
                    self.counters[f"{name}.samples"] += samples

    def report(self) -> str:
        lines = []
        with self._lock:
            for name in sorted(self.timings):
                ts = self.timings[name]
                lines.append(f"{name:24s} n={len(ts):4d} "
                             f"total={sum(ts):8.3f}s "
                             f"mean={np.mean(ts) * 1e3:8.2f}ms")
            for name, v in sorted(self.counters.items()):
                lines.append(f"{name:24s} = {v:g}")
        return "\n".join(lines)


METRICS = Metrics()


def solution_line(sol) -> str:
    """One-line fix report (the reference's printf row,
    c/solve.cpp:309-315), plus speed/course when a Doppler velocity
    solution is attached (the VTG quantities; beyond the reference)."""
    line = (f"{sol.n_sats},{sol.iterations:3d},{sol.t_bias:10.6f},"
            f"{sol.lat_deg:10.5f},{sol.lon_deg:10.5f},{sol.alt_m:8.2f}")
    vel = getattr(sol, "vel", None)
    if vel is not None:
        line += (f"  {vel.speed_mps * 3.6:6.2f} km/h"
                 f" @{vel.course_deg:5.1f}T {vel.vu:+5.2f} m/s up")
    return line


def save_iq_log(path: str, channels) -> None:
    """Dump per-channel prompt I/Q + code-rate histories to an ``.npz``.

    ``channels``: iterable of objects with prn / ip_hist / qp_hist /
    code_freq_hist (tpu_gnss_torch.receiver.ChannelRecord).  Epoch-rate
    I/Q is exactly what the reference's FPGA exposes for offline
    scatter/RSSI analysis; this is the capture side of that workflow.
    """
    arrs = {}
    for r in channels:
        tag = f"prn{int(r.prn):02d}"
        # a lost-and-reacquired PRN yields several records: suffix the
        # later segments instead of silently overwriting the first
        seg = 1
        while f"{tag}_ip" in arrs:
            seg += 1
            tag = f"prn{int(r.prn):02d}_seg{seg}"
        arrs[f"{tag}_ip"] = np.asarray(r.ip_hist, dtype=np.float32)
        arrs[f"{tag}_qp"] = np.asarray(r.qp_hist, dtype=np.float32)
        arrs[f"{tag}_code_freq"] = np.asarray(r.code_freq_hist,
                                              dtype=np.float32)
    np.savez_compressed(path, **arrs)
