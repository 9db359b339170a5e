"""The readers of the program's spans and counters (``spans.py`` and the
five ``program_span`` / ``program_counter`` metrics that use it), on
synthetic records, on a program without records, on a profiled receiver
run, and the idle time by program span on a fake trace."""

from __future__ import annotations

import types

import pytest

from gnss_bench import run, spans, trace
from tpu_gnss_torch.utils import metrics
from tpu_gnss_torch.utils.metrics import Count, Span

NEW = ("link.read_ms_per_s", "acquire.host_ms_per_capture",
       "acquire.searches_per_capture", "track.tables_ms_per_capture",
       "track.graph_misses_per_capture")
CALLER, PUMP, SEARCH = 11, 12, 13


def two_captures():
    """Two captures of 1 s each on the caller's thread, with the pump's
    reads, a search on the caller's thread and one on a search thread,
    and a receiver built outside both.  Times in seconds."""
    sp, cn = [Span("receiver.init", 0.0, 0.5, CALLER, 1, None, None)], []
    for k, t in ((1, 1.0), (2, 3.0)):
        b = 100 * k
        sp += [
            Span("receiver.capture", t, t + 1.0, CALLER, b, None, k),
            Span("io.read", t, t + 0.004, PUMP, b + 1, b, k),
            Span("io.read", t + 0.5, t + 0.502, PUMP, b + 2, b, k),
            # cold search: 30 ms, of which head 2, search 20 (fetch 5
            # inside), seed 3
            Span("receiver.acquire", t + 0.01, t + 0.04, CALLER, b + 3, b,
                 k),
            Span("acquire.head", t + 0.01, t + 0.012, CALLER, b + 4, b + 3,
                 k),
            Span("acquire.search", t + 0.012, t + 0.032, CALLER, b + 5,
                 b + 3, k),
            Span("acquire.fetch", t + 0.025, t + 0.030, CALLER, b + 6,
                 b + 5, k),
            Span("acquire.seed", t + 0.032, t + 0.035, CALLER, b + 7, b + 3,
                 k),
            Span("track.tables", t + 0.05, t + 0.062, CALLER, b + 8, b, k),
            # the re-acquisition: 10 ms on its own thread, its fetch 4
            Span("receiver.acquire", t + 0.6, t + 0.61, SEARCH, b + 9, b,
                 k),
            Span("acquire.search", t + 0.6, t + 0.609, SEARCH, b + 10,
                 b + 9, k),
            Span("acquire.fetch", t + 0.603, t + 0.607, SEARCH, b + 11,
                 b + 10, k),
            # the prewarm's search fetch is not acquisition's
            Span("receiver.prewarm.acq", t + 0.001, t + 0.009, CALLER,
                 b + 12, b, k),
            Span("acquire.fetch", t + 0.002, t + 0.008, CALLER, b + 13,
                 b + 12, k),
        ]
        cn += [Count("acquire.searches", 1.0, CALLER, b + 5, k),
               Count("acquire.searches", 1.0, SEARCH, b + 10, k),
               Count("track.graph_misses", 1.0, CALLER, b, k)]
    # a count outside the captures is not theirs
    cn.append(Count("track.graph_misses", 1.0, CALLER, None, None))
    return sp, cn


def read(name, ctx):
    return run.reader(name)(ctx)


CTX = dict(stages={}, signal_s=40.0, n_captures=40, trace=None, cfg={},
           loop={}, kind="")


def test_readers_on_synthetic_records(monkeypatch):
    sp, cn = two_captures()
    monkeypatch.setattr(spans, "records", lambda: (sp, cn))
    assert spans.captures(sp) == {1, 2}
    # 6 ms of reads a capture of 1 s
    assert read("link.read_ms_per_s", CTX) == pytest.approx(6.0)
    # caller: acquire 30 - 2 - 20 - 3 = 5, head 2, search 20 - 5 = 15,
    # seed 3; search thread: acquire 10 - 9 = 1, search 9 - 4 = 5
    assert read("acquire.host_ms_per_capture", CTX) == pytest.approx(31.0)
    assert read("acquire.searches_per_capture", CTX) == 2.0
    assert read("track.tables_ms_per_capture", CTX) == pytest.approx(12.0)
    assert read("track.graph_misses_per_capture", CTX) == 1.0
    own = spans.self_times(sp)
    assert min(own.values()) >= 0.0
    assert own[100] == pytest.approx(1.0 - 0.03 - 0.012 - 0.008)


def test_readers_give_nothing_without_records(monkeypatch):
    # the parent program: METRICS keeps durations only
    monkeypatch.setattr(metrics, "METRICS", types.SimpleNamespace(
        timings={}, counters={}))
    assert spans.records() is None
    for name in NEW:
        assert read(name, CTX) is None, name
    # records, but some dropped
    m = metrics.Metrics()
    m.dropped = 1
    monkeypatch.setattr(metrics, "METRICS", m)
    assert spans.records() is None
    # records, but no capture in them
    monkeypatch.setattr(spans, "records", lambda: (
        [Span("receiver.init", 0.0, 1.0, 1, 1, None, None)], []))
    for name in NEW:
        assert read(name, CTX) is None, name
    monkeypatch.setattr(spans, "records", lambda: two_captures())
    assert read("link.read_ms_per_s", dict(CTX, n_captures=0)) is None


def test_records_are_kept_while_a_profiler_runs(monkeypatch):
    """Without a recording block, the program keeps its spans and counts
    exactly while ``torch.profiler`` runs."""
    from torch.profiler import ProfilerActivity, profile
    m = metrics.Metrics()
    monkeypatch.setattr(metrics, "METRICS", m)
    with m.stage("receiver.capture", root=True):
        m.add("acquire.searches")
    with profile(activities=[ProfilerActivity.CPU]):
        with m.stage("receiver.capture", root=True):
            with m.stage("io.read"):
                m.add("acquire.searches")
    with m.stage("io.read"):
        pass
    sp, cn = spans.records()
    assert [s.name for s in sp] == ["io.read", "receiver.capture"]
    assert sp[0].parent == sp[1].id and sp[0].capture == sp[1].capture
    assert [(c.name, c.parent) for c in cn] == [("acquire.searches",
                                                 sp[0].id)]
    assert len(m.timings["io.read"]) == 2


def test_readers_on_a_profiled_receiver_run(tmp_path):
    """A receiver run over a test-size 1-bit capture under
    ``torch.profiler`` on the CPU: one cold search and no re-acquisition
    in 4 s, no graph on the CPU, reads, search host time and one table
    build."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from conftest import tiny_cell
    from tpu_gnss_torch.receiver import Receiver
    torch.set_num_threads(2)
    seconds = 4.0
    cell, cfg, traffic = tiny_cell("1bit", capture_s=seconds)
    caps = run.Captures(cfg, traffic, 20251018, "cpu", str(tmp_path))
    try:
        metrics.METRICS.drain()
        with profile(activities=[ProfilerActivity.CPU]):
            recv = Receiver(run.receiver_config(cfg), device="cpu")
            recv.process_source(caps.source(0))
    finally:
        caps.close()
    ctx = dict(CTX, signal_s=seconds, n_captures=1)
    got = {n: read(n, ctx) for n in NEW}
    metrics.METRICS.drain()
    assert got["acquire.searches_per_capture"] == 1.0
    assert got["track.graph_misses_per_capture"] == 0.0
    for name in ("link.read_ms_per_s", "acquire.host_ms_per_capture",
                 "track.tables_ms_per_capture"):
        assert got[name] > 0.0, (name, got)


def ev(name, ts, dur, cat, tid=1):
    return dict(ph="X", name=name, ts=ts, dur=dur, cat=cat, tid=tid)


def test_idle_by_program_span_on_a_fake_trace():
    """Idle device time inside the block, by the innermost program span
    open on the block's thread."""
    names = {n for n, _ in metrics.SPANS}
    events = [
        ev(trace.BLOCK, 1000.0, 1000.0, "user_annotation"),
        ev("receiver.init", 1000.0, 50.0, "user_annotation"),
        ev("receiver.capture", 1050.0, 900.0, "user_annotation"),
        ev("receiver.fetch", 1200.0, 300.0, "user_annotation"),
        ev("aten::item", 1250.0, 100.0, "cpu_op"),
        ev("io.read", 1000.0, 900.0, "user_annotation", tid=2),
        ev("fcr_forward_kernel", 1100.0, 50.0, "kernel"),
        ev("track_corr_kernel", 1600.0, 100.0, "kernel"),
        ev("track_corr_kernel", 2100.0, 100.0, "kernel"),   # after
    ]
    got = spans.idle_by_span(events, names, trace.BLOCK, trace.DEVICE_CATS)
    # init 1000-1050; capture 1050-1100, 1150-1200, 1500-1600, 1700-1950;
    # fetch 1200-1500; 1950-2000 is outside every program span
    assert got == pytest.approx({"receiver.init": 50e-6,
                                 "receiver.capture": 450e-6,
                                 "receiver.fetch": 300e-6})
    assert spans.innermost([(0, 10, "a"), (2, 4, "b"), (4, 6, "c"),
                            (8, 12, "d")]) == [
        [0, 2, "a"], [2, 4, "b"], [4, 6, "c"], [6, 8, "a"], [8, 10, "d"]]
