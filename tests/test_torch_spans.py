"""The port's program spans and counters (``tpu_gnss_torch.utils.metrics``).

One receiver run over a 3 s capture of the e2e scene recipe, with a
re-acquisition at 1 s, so that the caller's, pump, fetch, prewarm and
re-acquisition threads all open spans: with recording off, with it on,
and under ``torch.profiler``.
"""

import json
import re
import threading
from pathlib import Path

import pytest
import torch

from tpu_gnss.config import ReceiverConfig
from tpu_gnss_torch.io.stream import FileSource1Bit
from tpu_gnss_torch.receiver import Receiver
from tpu_gnss_torch.signal import scene
from tpu_gnss_torch.utils import metrics
from tpu_gnss_torch.utils.metrics import METRICS
from tests.torch_threads import one_torch_thread  # noqa: F401

FS = scene.FS
CFG = ReceiverConfig(fs=FS, fc=FS / 4, max_fo=5000.0, fft_len=4096,
                     snr_threshold=17.0)
NAMES = {name for name, _ in metrics.SPANS}
#: the stages the benchmark reads (gnss_bench/run.py STAGES)
STAGES = ("receiver.read", "receiver.transfer", "receiver.acquire",
          "receiver.track", "receiver.fetch", "receiver.drain",
          "receiver.nav", "receiver.solve")
PREWARM = ("receiver.prewarm.acq", "receiver.prewarm.seeder",
           "receiver.prewarm.track", "receiver.prewarm_wait")
PACKAGE = Path(__file__).resolve().parents[1] / "tpu_gnss_torch"


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """3 s of the e2e scene recipe (6 SVs at 2.048 Msps) as 1-bit IF."""
    iq, _, _ = scene.build_scene(duration=3.0)
    path = tmp_path_factory.mktemp("torch_spans") / "cap_1bit.bin"
    scene.write_1bit_capture(iq, CFG.fc, FS, path)
    return str(path)


def _run(capture):
    """A receiver built and run over the capture, re-acquiring from 1 s
    (6 SVs leave 6 of the 12 channels free)."""
    recv = Receiver(CFG, reacq_interval_s=1.0, device="cpu")
    return recv, recv.process_source(FileSource1Bit(capture, CFG))


@pytest.fixture(scope="module")
def recorded(capture):
    """``(receiver, spans, counts, dropped, caller's thread)`` of a run
    with recording on."""
    METRICS.drain()
    with METRICS.recording():
        recv, _ = _run(capture)
    spans, counts, dropped = METRICS.drain()
    return recv, spans, counts, dropped, threading.get_native_id()


def test_recording_off_keeps_no_span(capture, monkeypatch):
    """Off (no recording, no profiler), a run keeps no record and enters
    no ``record_function``, and the eight stages the benchmark reads are
    timed as before."""
    entered = []

    class Mark:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Mark)
    monkeypatch.setattr(torch.profiler, "record_function", Mark)
    METRICS.drain()
    before = {k: len(v) for k, v in METRICS.timings.items()}
    _run(capture)
    assert METRICS.drain() == ([], [], 0)
    assert entered == []
    grown = {k for k, v in METRICS.timings.items()
             if len(v) > before.get(k, 0)}
    assert set(STAGES) <= grown and grown <= NAMES


def test_spans_of_a_capture_share_its_id(recorded):
    """On: every name is registered; the caller's, pump, fetch, prewarm
    and re-acquisition threads' spans share the capture's id; each
    non-root span's parent is a span of the same capture, enclosing it
    where both ran on one thread; self times are >= 0."""
    recv, spans, counts, dropped, main = recorded
    assert dropped == 0 and {s.name for s in spans} <= NAMES
    roots = [s for s in spans if s.parent is None and s.capture is not None]
    assert [s.name for s in roots] == ["receiver.capture"]
    root = roots[0]
    assert root.thread == main
    inside = [s for s in spans if s.capture == root.capture]
    # the receiver was built before the capture began
    assert [s.name for s in spans if s not in inside] == ["receiver.init"]
    by_id = {s.id: s for s in spans}
    threads = {s.thread for s in inside}
    assert len(threads) >= 5, threads     # caller, pump, fetch, prewarm,
    # re-acquisition (the fetch pool and the pump are one thread each)
    thread_of = lambda name: {s.thread for s in inside if s.name == name}
    assert thread_of("io.read") == thread_of("receiver.transfer")
    for name in ("io.read", "receiver.copy", "receiver.prewarm.track"):
        assert thread_of(name) and main not in thread_of(name), name
    assert len(thread_of("receiver.acquire")) == 2   # cold, re-acquisition
    kids = {}
    for s in inside:
        if s is root:
            continue
        p = by_id[s.parent]
        assert p.capture == root.capture, s
        if p.thread == s.thread:
            assert p.start <= s.start and s.end <= p.end, (p, s)
            kids.setdefault(p.id, []).append(s)
        else:     # started the thread's work
            assert p.start <= s.start, (p, s)
    for s in inside:
        own = (s.end - s.start) - sum(k.end - k.start
                                      for k in kids.get(s.id, []))
        assert own >= 0.0, s
    assert sum(c.value for c in counts if c.name == "acquire.searches"
               and c.capture == root.capture) >= 2
    assert {c.name for c in counts} <= {n for n, _ in metrics.COUNTERS}


def test_profiler_trace_holds_the_callers_spans(capture, tmp_path):
    """Under ``torch.profiler``, each span the caller's thread recorded is
    in the exported Chrome trace, on that thread, with the same name and
    the same parent."""
    from torch.profiler import ProfilerActivity, profile
    METRICS.drain()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(capture)
    spans, _, _ = METRICS.drain()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("name") in NAMES]
    tid = next(e["tid"] for e in events if e["name"] == "receiver.capture")
    events = sorted((e for e in events if e["tid"] == tid),
                    key=lambda e: (float(e["ts"]), -float(e["dur"])))

    def parent(e):
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        out = [o for o in events if o is not e and float(o["ts"]) <= t0
               and float(o["ts"]) + float(o["dur"]) >= t1]
        return max(out, key=lambda o: (float(o["ts"]), -float(o["dur"])),
                   default={"name": None})["name"]

    main = next(s.thread for s in spans if s.name == "receiver.capture")
    mine = sorted((s for s in spans if s.thread == main),
                  key=lambda s: (s.start, -s.end))
    by_id = {s.id: s for s in spans}
    want = [(s.name, by_id[s.parent].name if s.parent in by_id
             and by_id[s.parent].thread == main else None) for s in mine]
    assert len(want) > 20
    assert [(e["name"], parent(e)) for e in events] == want


def test_the_cold_starts_prewarm_spans_appear_once(recorded):
    """The search prewarm and the wait on the caller's thread, the seeder
    and tracker prewarms on the prewarm thread, once each in the capture,
    all under its root."""
    recv, spans, _, _, main = recorded
    by_id = {s.id: s for s in spans}
    for name in PREWARM:
        got = [s for s in spans if s.name == name]
        assert len(got) == 1, (name, got)
        assert by_id[got[0].parent].name == "receiver.capture", name
    warm = {s.name: s.thread for s in spans if s.name in PREWARM}
    assert warm["receiver.prewarm.acq"] == warm["receiver.prewarm_wait"] \
        == main
    assert warm["receiver.prewarm.seeder"] == \
        warm["receiver.prewarm.track"] != main
    assert recv.prewarm_stats["track_captured"] is False   # the CPU


def test_every_name_the_port_opens_is_registered():
    """Each ``METRICS.stage``/``METRICS.add`` literal in the package (and
    each ``counter=`` literal, which ``cache.once`` adds to) is in
    ``SPANS``/``COUNTERS``, and each registered name is opened or added
    somewhere, once in the registry."""
    text = "\n".join(p.read_text() for p in PACKAGE.rglob("*.py"))
    opened = set(re.findall(r'METRICS\.stage\(\s*"([^"]+)"', text))
    added = set(re.findall(r'(?:METRICS\.add\(\s*|counter=)"([^"]+)"',
                           text))
    counters = [n for n, _ in metrics.COUNTERS]
    assert len(NAMES) == len(metrics.SPANS)
    assert len(set(counters)) == len(counters)
    assert opened == NAMES
    assert added == set(counters)
    assert all(meaning and "\n" not in meaning
               for _, meaning in metrics.SPANS + metrics.COUNTERS)
