"""Stage timers for the port's receiver.

Copied from tpu_gnss/utils/metrics.py (``Metrics`` / ``METRICS``); that
package's ``__init__`` imports jax.  Stage times are host wall clock: a
stage that enqueues device work without waiting measures the enqueue.
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
