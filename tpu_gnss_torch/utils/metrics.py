"""Stage timers and the receiver's text dashboard.

Copied from tpu_gnss/utils/metrics.py:21-64 (``Metrics`` / ``METRICS``,
with a lock added: the port's prefetch, fetch and re-acquisition threads
feed it) and 91-222 (``channel_bars``, ``solution_line``, ``latlon_dms``,
``gps_day_time``, ``iq_scatter_ascii``, ``save_iq_log``); that package's
``__init__`` imports jax.  ``device_trace`` ports :67-84 from
``jax.profiler`` onto ``torch.profiler``.  Stage times are host wall
clock: a stage that enqueues device work without waiting measures the
enqueue.
"""

from __future__ import annotations

import contextlib
import glob
import os
import sys
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

    def add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] += value

    def throughput(self, name: str) -> Optional[float]:
        """Samples/s for a stage fed with ``samples=``."""
        total_t = sum(self.timings.get(name, []))
        total_s = self.counters.get(f"{name}.samples", 0.0)
        return (total_s / total_t) if total_t > 0 else None

    def report(self) -> str:
        lines = []
        with self._lock:
            for name in sorted(self.timings):
                ts = self.timings[name]
                line = (f"{name:24s} n={len(ts):4d} total={sum(ts):8.3f}s "
                        f"mean={np.mean(ts)*1e3:8.2f}ms")
                tp = self.throughput(name)
                if tp:
                    line += f"  {tp/1e6:9.2f} Msamp/s"
                lines.append(line)
            for name, v in sorted(self.counters.items()):
                if not name.endswith(".samples"):
                    lines.append(f"{name:24s} = {v:g}")
        return "\n".join(lines)


METRICS = Metrics()

# device_trace's warm-up launches and pause between starting the
# profiler and the block
TRACE_WARMUP_LAUNCHES = 64
TRACE_SETTLE_S = 0.1


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a ``torch.profiler`` trace around a block: host activity,
    plus the card's kernels and copies when CUDA is available, written
    as a TensorBoard trace (``<logdir>/*.pt.trace.json``).

    As the reference's (tpu_gnss/utils/metrics.py:67-84), the block
    always runs and a profiler that cannot start or stop does not raise;
    unlike it, one line on stderr says when no trace was written.  With
    CUDA, the trace also holds :data:`TRACE_WARMUP_LAUNCHES` tiny kernels
    launched before the block.
    """
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    pattern = os.path.join(logdir, "*.pt.trace.json")
    before = set(glob.glob(pattern))
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    prof, why = None, "no new *.pt.trace.json"
    try:
        prof = profile(activities=activities,
                       on_trace_ready=tensorboard_trace_handler(logdir))
        prof.start()
    except Exception as e:      # the block runs whatever the profiler does
        prof, why = None, f"the profiler did not start: {e!r}"
    if prof is not None and cuda:
        # the first kernel records after the profiler starts can be lost
        # (seen on an H100 with torch 2.11: up to a run's first five
        # launches missing from its trace, with or without a pause after
        # the start); warm-up launches take that loss before the block
        warm = torch.zeros(1, device="cuda")
        for _ in range(TRACE_WARMUP_LAUNCHES):
            warm.add_(1.0)
        torch.cuda.synchronize()
        time.sleep(TRACE_SETTLE_S)
    try:
        yield
    finally:
        if prof is not None:
            try:
                if cuda:
                    torch.cuda.synchronize()
                prof.stop()
            except Exception as e:
                why = f"the profiler did not stop: {e!r}"
        if not set(glob.glob(pattern)) - before:
            print(f"device_trace: no trace written to {logdir} ({why})",
                  file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# Channel dashboard (LCD bar-graph analog, reference: c/user.cpp:117-201)
# ---------------------------------------------------------------------------

def channel_bars(prns, powers, width: int = 40,
                 lo_freqs=None, statuses=None) -> str:
    """Render per-channel signal-strength bars as terminal text."""
    powers = np.asarray(powers, np.float64)
    rssi = np.sqrt(np.maximum(powers, 0.0))
    top = rssi.max() if rssi.size and rssi.max() > 0 else 1.0
    lines = []
    for i, prn in enumerate(prns):
        n = int(round(width * rssi[i] / top))
        bar = "#" * n + "." * (width - n)
        line = f"PRN {prn:2d} |{bar}| rssi {rssi[i]:8.0f}"
        if lo_freqs is not None:
            line += f"  dopp {lo_freqs[i]:+7.1f} Hz"
        if statuses is not None:
            line += f"  [{statuses[i]}]"
        lines.append(line)
    return "\n".join(lines)


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


def latlon_dms(lat_deg: float, lon_deg: float) -> str:
    """Degrees/minutes/seconds position page (reference LCD page 3,
    c/user.cpp:160-176)."""
    def dms(v, pos, neg):
        h = pos if v >= 0 else neg
        # split from rounded centi-arcseconds so display never shows 60.00"
        cs = round(abs(v) * 360000.0)
        d, cs = divmod(cs, 360000)
        m, cs = divmod(cs, 6000)
        return f"{d}°{m:02d}'{cs / 100.0:05.2f}\"{h}"
    return f"{dms(lat_deg, 'N', 'S')} {dms(lon_deg, 'E', 'W')}"


def gps_day_time(week: int, tow_s: float) -> str:
    """GPS day-of-week + UTC-style time page (reference LCD page 4,
    c/user.cpp:178-201).

    ``tow_s`` is the time of week in seconds; leap seconds are not
    applied (the reference displays GPS time as well).
    """
    days = ("Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
            "Friday", "Saturday")
    # split from rounded milliseconds so display never shows :60.000
    ms = round(float(tow_s) * 1000.0) % (7 * 86400 * 1000)
    day, ms = divmod(ms, 86400 * 1000)
    h, ms = divmod(ms, 3600 * 1000)
    m, ms = divmod(ms, 60 * 1000)
    return (f"week {week} {days[day]} {h:02d}:{m:02d}:"
            f"{ms / 1000.0:06.3f} GPS")


def iq_scatter_ascii(ip, qp, size: int = 21, half_width: float = 0.0) -> str:
    """ASCII I/Q constellation scatter of prompt correlator outputs.

    The software analog of the reference FPGA's "RSSI and IQ logging
    (e.g. for scatter plots)" affordance: a locked Costas loop shows two
    tight clusters on the I axis (the NAV bit constellation); a circle
    means carrier phase is not locked.

    Args:
      ip/qp: per-epoch prompt I and Q arrays.
      size: square grid size in characters (odd keeps axes centered).
      half_width: plot half-range; 0 -> auto (1.2x the 95th percentile).
    """
    ip = np.asarray(ip, dtype=np.float64)
    qp = np.asarray(qp, dtype=np.float64)
    if ip.size == 0:
        return "(no I/Q history)"
    if half_width <= 0:
        mag = np.abs(np.concatenate([ip, qp]))
        half_width = 1.2 * (np.percentile(mag, 95) or 1.0)
    grid = np.zeros((size, size), dtype=np.int64)
    col = np.clip(((ip / half_width) + 1.0) * 0.5 * (size - 1), 0,
                  size - 1).astype(int)
    row = np.clip(((-qp / half_width) + 1.0) * 0.5 * (size - 1), 0,
                  size - 1).astype(int)
    np.add.at(grid, (row, col), 1)
    shades = " .:+*#@"
    top = grid.max() or 1
    lines = []
    mid = size // 2
    for r in range(size):
        chars = []
        for c in range(size):
            n = grid[r, c]
            if n == 0:
                chars.append("|" if c == mid else
                             ("-" if r == mid else " "))
            else:
                chars.append(shades[min(len(shades) - 1,
                                        1 + int(n / top * (len(shades) - 2)))])
        lines.append("".join(chars))
    return "\n".join(lines)


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
