"""Stage timers and spans, and the receiver's text dashboard.

Copied from tpu_gnss/utils/metrics.py:21-64 (``Metrics`` / ``METRICS``,
with a lock added: the port's prefetch, fetch and re-acquisition threads
feed it) and 91-222 (``channel_bars``, ``solution_line``, ``latlon_dms``,
``gps_day_time``, ``iq_scatter_ascii``, ``save_iq_log``); that package's
``__init__`` imports jax.  ``device_trace`` ports :67-84 from
``jax.profiler`` onto ``torch.profiler``.  Stage times are host wall
clock: a stage that enqueues device work without waiting measures the
enqueue.

Beyond the reference, a stage is a span.  While recording is on (inside
:meth:`Metrics.recording`, or while a ``torch.profiler`` runs) each stage
also keeps a :class:`Span` (its start and end, thread, parent and capture)
and each :meth:`Metrics.add` a :class:`Count`, in a bounded buffer; and
while a profiler runs, each stage is a ``record_function`` of its name,
so it lands in the profiler's trace beside the kernels, on its clock.
Every name the port opens or counts is in :data:`SPANS` or
:data:`COUNTERS`.
"""

from __future__ import annotations

import contextlib
import glob
import itertools
import os
import sys
import threading
import time
from collections import defaultdict
from typing import NamedTuple, Optional

import numpy as np

#: every span the port opens, with what it covers.  "The loop" is the
#: caller's thread in ``Receiver.process_source``; the pump, fetch,
#: prewarm and re-acquisition threads carry its capture.
SPANS = (
    ("receiver.capture", "root: one process_source call (a capture)"),
    ("receiver.init", "Receiver.__init__: the searcher and shared tracker"),
    ("receiver.total", "cli.run_receiver: its process_source call"),
    ("receiver.read", "the loop waiting for the pump's next chunk"),
    ("receiver.transfer", "pump: a chunk's upload and device conversion "
     "enqueued"),
    ("receiver.acquire", "a cold or re-acquisition search and its seeding"),
    ("receiver.track", "the tracker's call on a chunk, outputs packed"),
    ("receiver.fetch", "the loop waiting for a chunk's outputs"),
    ("receiver.drain", "a chunk's outputs into the records, the watchdog"),
    ("receiver.nav", "NAV decoding"),
    ("receiver.solve", "PVT solves"),
    ("receiver.copy", "fetch thread: a chunk's outputs copied to the host"),
    ("receiver.prewarm.acq", "the loop: the cold search's prewarm"),
    ("receiver.prewarm.seeder", "prewarm thread: the channel seeder's"),
    ("receiver.prewarm.track", "prewarm thread: the tracker's full-chunk "
     "graph"),
    ("receiver.prewarm_wait", "the loop waiting for the prewarm thread"),
    ("receiver.reacq_wait", "the loop waiting for a re-acquisition search "
     "at the chunk boundary after its launch"),
    ("receiver.close", "the pump stopped, the fetch pool shut down, the "
     "prewarm thread joined"),
    ("io.read", "pump: one step of the source's reader (the file read)"),
    ("track.tables", "the code spectra or tables built and uploaded for a "
     "new slot map"),
    ("acquire.head", "a search head unpacked or converted on the host"),
    ("acquire.search", "one search run: upload, kernels, refinement, the "
     "host fetch and thresholds"),
    ("acquire.fetch", "the search's [3, n_sv] result copied to the host"),
    ("acquire.seed", "channels seeded from detections"),
)
#: every counter the port adds to while recording, with what it counts
COUNTERS = (
    ("acquire.searches", "search runs: cold, weak escalation, directed "
     "fallback, re-acquisition (not the prewarm's)"),
    ("track.graph_misses", "tracker chunks run eagerly or captured, and "
     "prewarm captures"),
    ("acquire.table_builds", "the search's replica spectra or kernel code "
     "planes built for a new key (the prewarm's too)"),
    ("checkpoint.member_reads", "npz members a checkpoint load read, each "
     "once, added once per load"),
)
#: records kept while recording; more are counted in ``Metrics.dropped``
SPAN_BUFFER = 1 << 16


class Span(NamedTuple):
    """One stage call while recording: ``perf_counter`` seconds, the
    thread's native id, and the ids of the span and of its parent (the
    innermost span open on the thread, or the one that started the
    thread's work; None for a root) and the capture (None outside one)."""
    name: str
    start: float
    end: float
    thread: int
    id: int
    parent: Optional[int]
    capture: Optional[int]


class Count(NamedTuple):
    """One :meth:`Metrics.add` while recording, in the span it ran in."""
    name: str
    value: float
    thread: int
    parent: Optional[int]
    capture: Optional[int]


def _profiler():
    """``torch.autograd.profiler`` while a ``torch.profiler`` runs (its
    flag reads True on every thread), else None."""
    mod = sys.modules.get("torch.autograd.profiler")
    return mod if getattr(mod, "_is_profiler_enabled", False) else None


class Metrics:
    """Process-wide stage timing, spans and counter registry
    (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.timings = defaultdict(list)   # stage -> [seconds]
        self.counters = defaultdict(float)  # name -> value
        self._recording = 0                 # open recording() blocks
        self._records: list = []            # Span and Count, in order
        self.dropped = 0                    # records past SPAN_BUFFER
        self._ids = itertools.count(1)
        self._captures = itertools.count(1)
        self._local = threading.local()     # .top: (span id, capture)

    @contextlib.contextmanager
    def recording(self):
        """Keep spans and counts for the block (they stay in the buffer
        until :meth:`drain`)."""
        with self._lock:
            self._recording += 1
        try:
            yield
        finally:
            with self._lock:
                self._recording -= 1

    def _keep(self, rec) -> None:
        # under self._lock
        if len(self._records) < SPAN_BUFFER:
            self._records.append(rec)
        else:
            self.dropped += 1

    def handoff(self) -> tuple:
        """The calling thread's innermost open span and capture, for work
        it starts on another thread (:meth:`adopted`)."""
        return getattr(self._local, "top", (None, None))

    @contextlib.contextmanager
    def adopted(self, handoff: tuple):
        """Open this thread's spans under ``handoff``'s span and
        capture."""
        prev = self.handoff()
        self._local.top = handoff
        try:
            yield
        finally:
            self._local.top = prev

    @contextlib.contextmanager
    def stage(self, name: str, root: bool = False):
        """Time the block into ``timings[name]``; while recording, keep it
        as a span (``root``: a new capture's root span)."""
        prof = _profiler()
        span = None                         # (id, parent, capture)
        if self._recording or prof:
            prev = self.handoff()
            span = ((next(self._ids), None, next(self._captures)) if root
                    else (next(self._ids), *prev))
            self._local.top = (span[0], span[2])
        mark = prof.record_function(name) if prof else None
        if mark is not None:
            mark.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if mark is not None:
                mark.__exit__(None, None, None)
            if span is not None:
                self._local.top = prev
            with self._lock:
                self.timings[name].append(t1 - t0)
                if span is not None:
                    self._keep(Span(name, t0, t1, threading.get_native_id(),
                                    *span))

    def add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] += value
            if self._recording or _profiler():
                parent, capture = self.handoff()
                self._keep(Count(name, value, threading.get_native_id(),
                                 parent, capture))

    def spans(self) -> list:
        """The :class:`Span` records kept, oldest first."""
        with self._lock:
            return [r for r in self._records if isinstance(r, Span)]

    def counts(self) -> list:
        """The :class:`Count` records kept, oldest first."""
        with self._lock:
            return [r for r in self._records if isinstance(r, Count)]

    def drain(self) -> tuple[list, list, int]:
        """``(spans, counts, dropped)`` kept so far; empties the buffer."""
        with self._lock:
            recs, dropped = self._records, self.dropped
            self._records, self.dropped = [], 0
        return ([r for r in recs if isinstance(r, Span)],
                [r for r in recs if isinstance(r, Count)], dropped)

    def report(self) -> str:
        lines = []
        with self._lock:
            for name in sorted(self.timings):
                ts = self.timings[name]
                lines.append(f"{name:24s} n={len(ts):4d} "
                             f"total={sum(ts):8.3f}s "
                             f"mean={np.mean(ts)*1e3:8.2f}ms")
            for name, v in sorted(self.counters.items()):
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
