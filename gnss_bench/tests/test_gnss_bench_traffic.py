"""The traffic keys ``start``, ``streams`` and ``sky``: each read and
checked, the visible sky where it is placed, a warm start's checkpoint
as the program loads it, the warm path to a fix, and several streams
giving, capture by capture, what one stream gives."""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from conftest import tiny_cell


def _with_traffic(monkeypatch, change):
    from gnss_bench import run
    orig = run.load_json

    def patched(*parts):
        d = orig(*parts)
        return change(dict(d)) if "traffic" in parts else d
    monkeypatch.setattr(run, "load_json", patched)
    return run


@pytest.mark.parametrize("key", ["start", "streams", "sky"])
def test_a_mix_without_start_or_streams_is_refused(monkeypatch, key):
    run = _with_traffic(monkeypatch, lambda d: {k: v for k, v in d.items()
                                                if k != key})
    with pytest.raises(SystemExit, match=key):
        run.cell_spec("nottingham_1bit.cold4")


@pytest.mark.parametrize("key, value", [("start", "hot"), ("start", None),
                                        ("streams", 0), ("streams", 1.5),
                                        ("streams", True), ("streams", "2"),
                                        ("sky", "earth"), ("sky", None)])
def test_start_and_streams_take_only_their_values(monkeypatch, key, value):
    run = _with_traffic(monkeypatch, lambda d: dict(d, **{key: value}))
    with pytest.raises(SystemExit, match="streams a whole number"):
        run.cell_spec("nottingham_1bit.cold4")


def test_each_cell_reads_its_start_and_streams():
    from gnss_bench import run
    cells = [w["name"] for w in run.load_json(run.ROOT, "BENCHMARK.json")[
        "workloads"]]
    got = {w: (t["start"], t["streams"], t["sky"])
           for w in cells for t in [run.cell_spec(w)[2]]}
    want = {"cold4": ("cold", 1, "e2e"), "replay20": ("cold", 1, "e2e"),
            "warm8": ("warm", 1, "visible")}
    assert got == {w: want[w.split(".")[1]] for w in cells}
    assert "nottingham_1bit.warm8" in got


def _az_el_deg(plan, t: float) -> dict:
    """Each SV's azimuth and elevation from the truth position (its
    geocentric horizon) at receiver time ``t``, from the generator's own
    orbits."""
    from gnss_bench.gen import scene
    rx = np.asarray(plan.rx, np.float64)
    up = rx / np.linalg.norm(rx)
    east = np.array([-up[1], up[0], 0.0]) / np.hypot(up[0], up[1])
    north = np.cross(up, east)
    out = {}
    for sv in plan.svs:
        d = np.asarray(sv.eph.get_xyz(scene.T_RX0 + t)) - rx
        out[sv.prn] = (float(np.degrees(np.arctan2(d @ east, d @ north))
                             % 360.0),
                       float(np.degrees(np.arcsin(d @ up
                                                  / np.linalg.norm(d)))))
    return out


def test_the_visible_sky_stands_where_it_is_placed():
    from gnss_bench.gen import scene
    e2e = scene.plan(8.0, 2.048e6, 6)
    plan = scene.plan(8.0, 2.048e6, 6, visible=True)
    got = _az_el_deg(plan, 0.0)
    for (prn, (az, el)), want in zip(sorted(got.items()),
                                     scene.VISIBLE_AZ_EL):
        assert abs((az - want[0] + 180.0) % 360.0 - 180.0) < 0.5, prn
        assert abs(el - want[1]) < 0.5, prn
    # only the node and the mean anomaly are turned; both skies keep
    # their PRNs, and the Dopplers of the visible one take both signs
    for a, b in zip(e2e.svs, plan.svs):
        assert a.prn == b.prn
        assert ({k: v for k, v in vars(a.eph).items()
                 if k not in ("omega_0", "m_0")}
                == {k: v for k, v in vars(b.eph).items()
                    if k not in ("omega_0", "m_0")})
    dop = plan.dopplers_hz()
    assert dop.min() < -1000.0 and dop.max() > 1000.0
    assert np.abs(dop).max() < 5000.0


@pytest.mark.parametrize("visible, directed", [(False, [3, 6]),
                                               (True, [2, 3, 4, 5, 6, 7])])
def test_the_warm_checkpoint_round_trips(tmp_path, visible, directed):
    from gnss_bench import run
    from gnss_bench.gen import scene
    from gnss_bench.ref import check
    plan = scene.plan(8.0, 2.048e6, 6, visible=visible)
    path = str(tmp_path / "checkpoint.npz")
    run.write_checkpoint(plan, path)
    warm = run.warm_start(path)
    # the saved ephemerides are the truth as the ICD quantizes it
    assert sorted(warm["warm_ephemerides"]) == [2, 3, 4, 5, 6, 7]
    for sv in plan.svs:
        eph = warm["warm_ephemerides"][sv.prn]
        assert eph.valid()
        for name, want in check.quantized(sv.eph).items():
            assert getattr(eph, name) == want, (sv.prn, name)
    # the almanac directs the search to the SVs above the 5 degree mask
    # within the next 30 minutes: in the e2e sky, whose orbits take no
    # account of the Earth, two of the six; in the visible sky, all
    above = set()
    for t in np.arange(0.0, 1801.0, 60.0):
        above |= {p for p, (_, el) in _az_el_deg(plan, t).items()
                  if el >= 5.0}
    assert warm["search_prns"] == sorted(above) == directed


def test_a_cold_start_loads_no_checkpoint(tmp_path):
    from gnss_bench import run
    _, cfg, traffic = tiny_cell("1bit", capture_s=1.0)
    caps = run.Captures(cfg, traffic, 5, "cpu", str(tmp_path / "caps"))
    try:
        assert caps.checkpoint is None
    finally:
        caps.close()


def test_a_warm_run_fixes_within_its_capture_and_is_correct(cpu_run):
    from tpu_gnss_torch.utils.metrics import METRICS
    n0 = len(METRICS.timings.get("acquire.search", []))
    out = cpu_run("1bit", capture_s=8.0, start="warm", sky="visible")
    assert out["correct"], (out["bad"], out["missed"], out["errors"])
    assert out["failed"] == 0 and out["attempted"] == 1
    assert out["numbers"]["fix_err_m"] < 60.0
    # the directed search over the six visible PRNs finds them all, and
    # the re-acquisition at 5 s follows: two searches, where a directed
    # search that came up short would add its retry and the full sweep
    assert len(METRICS.timings["acquire.search"]) - n0 == 2
    assert out["numbers"]["fix_time_err_us"] < 1.0


def test_a_warm_anchor_one_subframe_late_is_not_correct(cpu_run,
                                                       monkeypatch):
    # in 8 s the one complete subframe (a subframe 4 page) anchors the
    # warm channels' transmit time; its TOW one count (6 s) late where
    # the receiver decodes it moves the fixes by thousands of km
    from tpu_gnss_torch.nav import ephemeris
    orig = ephemeris.tow_count
    monkeypatch.setattr(ephemeris, "tow_count", lambda d: orig(d) + 1)
    out = cpu_run("1bit", capture_s=8.0, start="warm", sky="visible")
    assert not out["correct"]
    assert any("last fix" in m for m in out["missed"]), out["missed"]


def test_a_warm_anchor_one_bit_late_is_not_correct(cpu_run, monkeypatch):
    # every anchor's edge one NAV bit (20 ms) late where the receiver
    # finds it: the receiver clock takes up most of it, so the fixes
    # move by tens of metres, under the 60 m gate; the fix's time
    # against the capture's catches it
    from tpu_gnss_torch.nav import bits
    for name in ("frame_sync", "partial_anchors"):
        orig = getattr(bits, name)
        monkeypatch.setattr(bits, name, lambda b, orig=orig: [
            dict(f, start=f["start"] + 1) for f in orig(b)])
    out = cpu_run("1bit", capture_s=8.0, start="warm", sky="visible")
    assert not out["correct"]
    assert out["bad"] == ["fix_time_err_us"], out["bad"]
    assert out["missed"] == [] and out["numbers"]["fix_err_m"] < 60.0
    assert abs(out["numbers"]["fix_time_err_us"] - 20000.0) < 10.0


def test_two_streams_give_what_one_gives(tmp_path, monkeypatch):
    # the set-up's two captures run one after the other, as one stream
    # runs them; the window's two streams run the same two at once
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import torch
    torch.set_num_threads(2)
    from gnss_bench import run
    seen = []
    orig = run.one_capture
    lock = threading.Lock()

    def recorded(cfg, caps, i, device):
        t0 = time.perf_counter()
        got = orig(cfg, caps, i, device)
        with lock:
            seen.append((i, t0, time.perf_counter(), got[0], got[3]))
        return got
    monkeypatch.setattr(run, "one_capture", recorded)
    cell, cfg, traffic = tiny_cell("1bit", sample=2, streams=2, distinct=2,
                                   warm_captures=2)
    out = run.run_cell(cell, cfg, traffic, 20251018, 0.05, False, "cpu")
    assert out["correct"], (out["bad"], out["missed"], out["errors"])
    assert out["attempted"] == 2 and out["failed"] == 0
    alone, together = seen[:2], seen[2:]
    assert [s[0] for s in alone] == [0, 1]
    assert sorted(s[0] for s in together) == [0, 1]
    # the window's two captures overlapped in time
    assert max(s[1] for s in together) < min(s[2] for s in together)
    by_i = {s[0]: s for s in together}
    for i, _, _, res, err in alone:
        other = by_i[i]
        assert err is None and other[4] is None
        assert _digest(res) == _digest(other[3]), i


def _digest(res) -> tuple:
    """What a capture's result says: its detections, every channel's
    prompts and loop outputs, its fixes."""
    dets = tuple(sorted((d["prn"], d["doppler_hz"], d["ca_shift"])
                        for d in res.detections))
    chans = tuple((r.prn, r.start_epoch, r.lost,
                   np.asarray(r.ip_hist).tobytes(),
                   np.asarray(r.qp_hist).tobytes(),
                   np.asarray(r.hist("caf")).tobytes(),
                   np.asarray(r.hist("chips")).tobytes())
                  for r in res.channels)
    fixes = tuple((s.x, s.y, s.z) for s in res.solutions)
    return dets, chans, fixes
