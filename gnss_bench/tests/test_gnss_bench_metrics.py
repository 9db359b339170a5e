"""The trace arithmetic and the per-layer readers on a recorded fake
trace."""

from __future__ import annotations

import json

import pytest

from gnss_bench import run, trace

H100 = "NVIDIA H100 80GB HBM3"


def ev(name, ts, dur, cat, tid=1):
    return dict(ph="X", name=name, ts=ts, dur=dur, cat=cat, tid=tid)


EVENTS = [
    ev(trace.BLOCK, 1000.0, 1000.0, "user_annotation"),
    ev("aten::copy_", 1000.0, 100.0, "cpu_op"),
    ev("cudaGraphLaunch", 1150.0, 10.0, "cuda_runtime"),
    ev("fcr_forward_kernel", 1100.0, 50.0, "kernel"),
    ev("fcr_reduce_kernel", 1140.0, 30.0, "kernel"),       # overlaps
    ev("track_corr_kernel<2>", 1300.0, 60.0, "kernel"),
    ev("loop_update_kernel", 1360.0, 4.0, "kernel"),
    ev("track_corr_kernel<2>", 1400.0, 60.0, "kernel"),
    ev("loop_update_kernel", 1460.0, 4.0, "kernel"),
    ev("Memcpy DtoH", 1900.0, 20.0, "gpu_memcpy"),
    ev("aten::item", 1500.0, 350.0, "cpu_op"),
    ev("gnss_bench.nav", 1480.0, 400.0, "user_annotation"),
    ev("fcr_forward_kernel", 2500.0, 50.0, "kernel"),     # after the block
]


def test_summary_of_a_fake_trace(tmp_path):
    s = trace.summarize(EVENTS)
    assert s["window_s"] == pytest.approx(1e-3)
    # union: 1100-1170, 1300-1364, 1400-1464, 1900-1920
    assert s["busy_s"] == pytest.approx((70 + 64 + 64 + 20) * 1e-6)
    assert s["kernels"]["fcr_forward_kernel"] == [1, pytest.approx(50e-6)]
    assert s["device_ops"][0][0] == "track_corr_kernel<2>"
    gaps = dict(s["idle_gaps"])
    # 1000-1100 under aten::copy_, 1464-1900 under aten::item inside the
    # benchmark's nav span at its middle, the others under no op
    assert gaps["aten::copy_"] == pytest.approx(100e-6)
    assert gaps["gnss_bench.nav > aten::item"] == pytest.approx(436e-6)
    assert sum(gaps.values()) == pytest.approx(1e-3 - s["busy_s"])
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": EVENTS}))
    assert trace.read(str(p))["busy_s"] == s["busy_s"]
    assert not p.exists()


def _scanned_labels(events):
    """The idle gaps' labels as a scan of every host event at each gap's
    middle finds them: the plain version of ``summarize``'s sweep."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    block = next(e for e in xs if e["name"] == trace.BLOCK)
    b0, b1 = block["ts"], block["ts"] + block["dur"]
    dev = trace.merged([(e["ts"], min(e["ts"] + e["dur"], b1)) for e in xs
                        if e["cat"] in trace.DEVICE_CATS
                        and b0 <= e["ts"] < b1])
    host = [e for e in xs if e["cat"] in trace.HOST_CATS
            and e["name"] != trace.BLOCK]
    main = [e for e in host if e["tid"] == block["tid"]]
    at = lambda evs, t: [e for e in evs if e["ts"] <= t < e["ts"] + e["dur"]]
    out, edge = {}, b0
    for s0, e0 in dev + [[b1, b1]]:
        if s0 > edge:
            mid = 0.5 * (edge + s0)
            label = trace.gap_label(at(main, mid) or at(host, mid))
            out[label] = out.get(label, 0.0) + (s0 - edge) * 1e-6
        edge = max(edge, e0)
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_gap_sweep_labels_as_a_scan_does(seed):
    # nested host events on three threads, spans among them, and device
    # intervals with gaps between: the sweep and the scan agree gap by gap
    import random
    rng = random.Random(seed)
    events = [ev(trace.BLOCK, 0.0, 10000.0, "user_annotation", tid=1)]

    def nest(t0, t1, tid, depth):
        t = t0
        while depth < 4 and t < t1:
            a = t + rng.uniform(0, 200)
            b = min(t1, a + rng.uniform(1, 1500))
            if a >= b:
                break
            name = (trace.SPAN + f"l{depth}" if rng.random() < 0.3
                    else f"op{rng.randrange(9)}")
            events.append(ev(name, a, b - a, "cpu_op", tid=tid))
            nest(a, b, tid, depth + 1)
            t = b
    for tid in (1, 2, 3):
        nest(0.0, 10000.0, tid, 0)
    t = 0.0
    while t < 10000.0:
        t += rng.uniform(0, 300)
        d = rng.uniform(1, 100)
        events.append(ev(f"k{rng.randrange(3)}", t, d, "kernel"))
        t += d
    rng.shuffle(events)
    got = dict(trace.summarize(events, top=10 ** 6)["idle_gaps"])
    want = _scanned_labels(events)
    assert got.keys() == want.keys()
    assert all(got[k] == pytest.approx(want[k]) for k in want)


def test_readers_on_the_fake_trace():
    from gnss_bench.roofline import search, track
    from gnss_bench import roofline
    s = trace.summarize(EVENTS)
    cfg = dict(fs=2.048e6, fft_len=4096, max_fo=5000.0, n_coherent=4,
               prns=list(range(1, 33)), num_chans=12)
    loop = dict(epochs_per_step=10)
    stages = {k: 0.0 for k in run.STAGES}
    stages.update({"receiver.read": 0.01, "receiver.transfer": 0.03,
                   "receiver.acquire": 0.2, "receiver.track": 0.4,
                   "receiver.fetch": 0.05, "receiver.drain": 0.05,
                   "receiver.nav": 0.1, "receiver.solve": 0.2})
    ctx = dict(stages=stages, signal_s=40.0, n_captures=2, trace=s,
               cfg=cfg, loop=loop, kind=H100)
    read = lambda n: run.reader(n)(ctx)
    assert read("link.ms_per_s") == pytest.approx(1.0)
    assert read("acquire.ms_per_capture") == pytest.approx(100.0)
    assert read("track.ms_per_s") == pytest.approx(10.0)
    assert read("navpvt.ms_per_s") == pytest.approx(10.0)
    assert read("device.idle_pct") == pytest.approx(
        100.0 * (1 - 218e-6 / 1e-3))
    b = roofline.bound_s(*search.work(cfg), H100)
    assert read("kernel.search_roofline") == pytest.approx(
        100.0 * b / 80e-6)
    bt = roofline.bound_s(*track.work(cfg, loop), H100)
    assert read("kernel.track_roofline") == pytest.approx(
        100.0 * 2 * bt / 128e-6)
    # nothing to read: no value, never 0
    ctx.update(trace=None, signal_s=0.0, n_captures=0)
    for name in ("kernel.search_roofline", "kernel.track_roofline",
                 "device.idle_pct", "link.ms_per_s",
                 "acquire.ms_per_capture"):
        assert read(name) is None


def test_nearest_rank_and_process_age():
    assert run.nearest_rank([5, 1, 4, 2, 3, 6, 7, 8, 9, 10], 0.9) == 9
    assert run.nearest_rank([1.0, float("inf")], 0.9) == float("inf")
    assert 0.0 < run.process_age_s() < 1e6
