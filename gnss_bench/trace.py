"""The benchmark's own profiler wrapper and trace arithmetic.

A block of whole captures runs under ``torch.profiler`` (CPU and CUDA
activities); its Chrome trace is read back and reduced to what the
per-layer metrics and the ``breakdown`` need: the device's busy time as
the union of kernel, copy and set intervals inside the traced block,
the device time and launch count of each kernel name, and the idle gaps
labelled by the innermost host operation that was running at their
middle, on the caller's thread where it ran one.  While a block is
traced, the program's calls into each layer run inside spans of the
benchmark's own (:func:`spans`), which label the gaps by layer.
"""

from __future__ import annotations

import contextlib
import functools
import heapq
import json
import os
import sys
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
BLOCK = "gnss_bench.traced"
SPAN = "gnss_bench."
NAME_CHARS = 120


def merged(spans) -> list:
    """The union of ``(start, end)`` intervals as disjoint intervals."""
    out = []
    for s0, e0 in sorted(spans):
        if out and s0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e0)
        else:
            out.append([s0, e0])
    return out


@contextlib.contextmanager
def profiled(trace_path: str, all_threads: bool = False):
    """Run the block under ``torch.profiler`` and write its Chrome trace
    to ``trace_path``; the block itself is marked ``BLOCK``.
    ``all_threads``: record the host events of every thread, not only
    the caller's, for a block whose captures run on threads of their
    own."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    kw = {}
    if all_threads:
        from torch.profiler import _ExperimentalConfig
        kw["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
    with profile(activities=acts, **kw) as prof:
        with record_function(BLOCK):
            yield
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(trace_path)


@contextlib.contextmanager
def spans(targets):
    """Wrap each ``(owner, attribute, layer)`` of ``targets`` in a
    ``record_function`` span named ``gnss_bench.<layer>`` for the block,
    so that the idle gaps can be told by layer; restored after."""
    from torch.profiler import record_function
    saved = []

    def wrap(fn, name):
        @functools.wraps(fn)
        def inner(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return inner
    try:
        for owner, attr, layer in targets:
            fn = getattr(owner, attr)
            saved.append((owner, attr, owner.__dict__[attr]))
            setattr(owner, attr, wrap(fn, SPAN + layer))
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


def short(name: str) -> str:
    """A kernel or op name without its trailing argument list, at most
    ``NAME_CHARS`` characters."""
    if name.endswith(")") and "::" in name:
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i else name
                break
    return name.rstrip()[:NAME_CHARS]


class Open:
    """The events of ``evs`` open at a time that only moves forward:
    :meth:`at` gives those with ``ts <= t < ts + dur``, in their order in
    ``evs``, at the cost of the events that opened or closed since."""

    def __init__(self, evs: list):
        self.todo = sorted(((float(e["ts"]), i, e)
                            for i, e in enumerate(evs)), reverse=True)
        self.open = []              # heap of (end, index, event)

    def at(self, t: float) -> list:
        while self.todo and self.todo[-1][0] <= t:
            s0, i, e = self.todo.pop()
            heapq.heappush(self.open, (s0 + float(e["dur"]), i, e))
        while self.open and self.open[0][0] <= t:
            heapq.heappop(self.open)
        return [e for _, _, e in sorted(self.open, key=lambda x: x[1])]


def gap_label(inner: list) -> str:
    """What the host was doing at a gap's middle, from the host events
    open then (``inner``): the innermost benchmark span and the innermost
    other operation."""
    spans = [e for e in inner if e["name"].startswith(SPAN)]
    ops = [e for e in inner if not e["name"].startswith(SPAN)]
    pick = lambda evs: short(min(evs, key=lambda e: float(e["dur"]))["name"])
    parts = [pick(x) for x in (spans, ops) if x]
    return " > ".join(parts) if parts else "host, no traced op"


def summarize(events: list, top: int = 10) -> dict:
    """Reduce Chrome trace events to the block's numbers.

    Returns ``window_s`` (the block's host wall), ``busy_s`` (the union
    of device intervals inside it), ``kernels`` ({name: [calls, device
    s]}), ``device_ops`` (the ``top`` names by device seconds) and
    ``idle_gaps`` (the ``top`` host labels by idle seconds)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    block = [e for e in xs if e.get("name") == BLOCK]
    if not block:
        raise ValueError("the traced block is not in the trace")
    b0 = float(block[0]["ts"])
    b1 = b0 + float(block[0]["dur"])
    dev = [e for e in xs if str(e.get("cat", "")).lower() in DEVICE_CATS
           and b0 <= float(e["ts"]) < b1]
    spans = [(float(e["ts"]), min(float(e["ts"]) + float(e["dur"]), b1))
             for e in dev]
    kernels: dict = {}
    for e in dev:
        k = kernels.setdefault(e["name"], [0, 0.0])
        k[0] += 1
        k[1] += float(e["dur"]) * 1e-6
    # the caller's thread first: what the host that waits was doing
    host = [e for e in xs if str(e.get("cat", "")).lower() in HOST_CATS
            and e.get("name") != BLOCK]
    main = [e for e in host if e.get("tid") == block[0].get("tid")]
    gaps: dict = {}
    edge = b0
    on_main, on_host = Open(main), Open(host)
    for s0, e0 in merged(spans) + [[b1, b1]]:
        if s0 > edge:
            mid = 0.5 * (edge + s0)
            # on the caller's thread where it ran any, else on any thread
            label = gap_label(on_main.at(mid) or on_host.at(mid))
            gaps[label] = gaps.get(label, 0.0) + (s0 - edge) * 1e-6
        edge = max(edge, e0)
    rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return dict(
        window_s=(b1 - b0) * 1e-6,
        busy_s=sum(e0 - s0 for s0, e0 in merged(spans)) * 1e-6,
        kernels=kernels,
        device_ops=[[short(n), v[1]] for n, v in sorted(
            kernels.items(), key=lambda kv: -kv[1][1])[:top]],
        idle_gaps=[[short(n), v] for n, v in rank(gaps)])


def read(trace_path: str) -> dict:
    """:func:`summarize` of a Chrome trace file, which is then removed;
    its seconds on stderr."""
    t0 = time.perf_counter()
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(trace_path)
    out = summarize(events)
    print(f"gnss_bench: trace read {time.perf_counter() - t0:.2f} s",
          file=sys.stderr)
    return out


def kernel_stats(summary: dict, names) -> tuple[int, float]:
    """``(calls of the first name, device s of all)`` of the kernels
    whose names contain one of ``names``."""
    calls, secs = 0, 0.0
    for kname, (n, s) in summary["kernels"].items():
        hit = [nm for nm in names if nm in kname]
        if hit:
            secs += s
            if hit[0] == names[0]:
                calls += n
    return calls, secs
