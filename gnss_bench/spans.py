"""The program's own spans and counters, reduced for the per-layer metrics.

While a ``torch.profiler`` runs, the program
(``tpu_gnss_torch.utils.metrics.METRICS``) keeps a record of each of its
spans (name, start, end, thread, parent span, capture) and of each count
it adds, and opens each span as a ``record_function`` on the profiler's
clock.  The traced block of ``run.py`` is the only profiled part of a
run, so what the program kept is the traced captures'.  A program that
keeps no records, or one that dropped some, gives no number.

Self time: a span's duration less its children's on the same thread
(a child on another thread runs beside its parent, not inside it).
"""

from __future__ import annotations

ROOT = "receiver.capture"


def records():
    """``(spans, counts)`` the program kept, or None where it keeps none
    or dropped some."""
    from tpu_gnss_torch.utils.metrics import METRICS
    if not hasattr(METRICS, "spans") or METRICS.dropped:
        return None
    return METRICS.spans(), METRICS.counts()


def captures(spans) -> set:
    """The capture ids of the root spans."""
    return {s.capture for s in spans if s.name == ROOT and s.parent is None}


def self_times(spans) -> dict:
    """``{span id: self seconds}``."""
    own = {s.id: s.end - s.start for s in spans}
    thread = {s.id: s.thread for s in spans}
    for s in spans:
        if s.parent in own and thread[s.parent] == s.thread:
            own[s.parent] -= s.end - s.start
    return own


def self_s(spans, names, caps, under=None) -> float:
    """Self seconds of the spans named in ``names`` in captures ``caps``;
    with ``under``, only those that are or descend from a span of that
    name."""
    by_id = {s.id: s for s in spans}

    def inside(s):
        while s is not None:
            if s.name == under:
                return True
            s = by_id.get(s.parent)
        return False
    own = self_times(spans)
    return sum(own[s.id] for s in spans
               if s.name in names and s.capture in caps
               and (under is None or inside(s)))


def per_capture(reduce):
    """A reader: ``reduce(spans, counts, caps)`` over the number of
    traced captures, or None without records or captures."""
    def read(ctx):
        got = records()
        if got is None:
            return None
        spans, counts = got
        caps = captures(spans)
        return reduce(spans, counts, caps) / len(caps) if caps else None
    return read


def counted(counts, name, caps) -> float:
    """The sum of the counts of ``name`` in captures ``caps``."""
    return sum(c.value for c in counts if c.name == name
               and c.capture in caps)


def innermost(spans) -> list:
    """Nested ``(start, end, name)`` intervals of one thread as disjoint
    ``[start, end, name]`` pieces, each named by the innermost interval
    open there; time outside every interval has no piece."""
    pieces, stack = [], []          # stack: [end, name] of open intervals
    edge = None

    def close_until(t):
        nonlocal edge
        while stack and stack[-1][0] <= t:
            end, name = stack.pop()
            if end > edge:
                pieces.append([edge, end, name])
                edge = end
    for s0, e0, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        close_until(s0)
        if stack:
            e0 = min(e0, stack[-1][0])      # clock rounding
            if s0 > edge:
                pieces.append([edge, s0, stack[-1][1]])
        edge = s0
        stack.append([e0, name])
    close_until(float("inf"))
    return pieces


def idle_by_span(events, names, block: str, device_cats) -> dict:
    """``{span name: device idle seconds}`` of a Chrome trace: the time
    inside the ``block`` event that no device interval (``device_cats``)
    covers and the block's thread is inside a span of ``names``, by the
    innermost such span open there."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    b = next(e for e in xs if e.get("name") == block)
    b0, b1 = float(b["ts"]), float(b["ts"]) + float(b["dur"])
    busy = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in xs if str(e.get("cat", "")).lower() in device_cats
                  and b0 <= float(e["ts"]) < b1)
    idle, edge = [], b0
    for s0, e0 in busy + [(b1, b1)]:
        if s0 > edge:
            idle.append((edge, min(s0, b1)))
        edge = max(edge, e0)
    pieces = innermost([(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                         e["name"]) for e in xs
                        if e.get("tid") == b.get("tid")
                        and e.get("name") in names])
    out: dict = {}
    i = 0
    for p0, p1, name in pieces:
        while i < len(idle) and idle[i][1] <= p0:
            i += 1
        j = i
        while j < len(idle) and idle[j][0] < p1:
            cut = min(p1, idle[j][1]) - max(p0, idle[j][0])
            if cut > 0:
                out[name] = out.get(name, 0.0) + cut * 1e-6
            j += 1
    return out
