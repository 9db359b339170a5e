"""The port's copy of the metrics and dashboard functions against
``tpu_gnss.utils.metrics`` on the same inputs (the cases of
tests/test_aux.py:74-126)."""

import numpy as np
import pytest

from tpu_gnss.utils import metrics as jm
from tpu_gnss_torch.utils import metrics as tm


def _fill(m):
    m.timings["acq"] += [0.25, 0.5]
    m.counters["acq.samples"] += 2e6
    m.timings["track"] += [0.125]
    m.add("fixes")
    m.add("fixes", 2.0)
    return m


def test_metrics_registry():
    m = tm.Metrics()
    with m.stage("acq", samples=1000):
        pass
    with m.stage("acq", samples=1000):
        pass
    m.add("fixes")
    assert m.throughput("acq") > 0 and m.throughput("none") is None
    rep = m.report()
    assert "acq" in rep and "fixes" in rep and ".samples" not in rep


def test_report_and_throughput_match_jax():
    got, want = _fill(tm.Metrics()), _fill(jm.Metrics())
    assert got.throughput("acq") == want.throughput("acq") == 2e6 / 0.75
    assert got.report() == want.report()
    assert "Msamp/s" in got.report()


@pytest.mark.parametrize("kw", [
    dict(width=10, lo_freqs=[100.0, -250.0], statuses=["track", "acq"]),
    dict(statuses=["eph 45dBHz", "sf2"]), dict()])
def test_channel_bars(kw):
    args = ([1, 22], [1e6, 4e6])
    out = tm.channel_bars(*args, **kw)
    assert out == jm.channel_bars(*args, **kw)
    lines = out.splitlines()
    assert "PRN  1" in lines[0] and "PRN 22" in lines[1]
    assert lines[1].count("#") == kw.get("width", 40)
    assert tm.channel_bars([3], [0.0]) == jm.channel_bars([3], [0.0])


@pytest.mark.parametrize("lat,lon", [(52.95, -1.15), (-33.5, 151.25),
                                     (0.0, -0.0), (12.9999999, 179.99999)])
def test_latlon_dms(lat, lon):
    assert tm.latlon_dms(lat, lon) == jm.latlon_dms(lat, lon)
    assert tm.latlon_dms(52.95, -1.15).startswith("52°57'00.00\"N")


@pytest.mark.parametrize("week,tow", [(1910, 0.0), (1910, 86400 + 3723.5),
                                      (900, 302490.9996), (2, 604799.9999)])
def test_gps_day_time(week, tow):
    assert tm.gps_day_time(week, tow) == jm.gps_day_time(week, tow)
    assert tm.gps_day_time(1910, 86400 + 3723.5) == \
        "week 1910 Monday 01:02:03.500 GPS"


def test_iq_scatter_and_log(tmp_path):
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, 400) * 2 - 1
    ip = 1000.0 * bits + 30.0 * rng.standard_normal(400)
    qp = 30.0 * rng.standard_normal(400)
    art = tm.iq_scatter_ascii(ip, qp)
    assert art == jm.iq_scatter_ascii(ip, qp)
    assert tm.iq_scatter_ascii(qp, ip, size=11, half_width=500.0) == \
        jm.iq_scatter_ascii(qp, ip, size=11, half_width=500.0)
    assert tm.iq_scatter_ascii([], []) == jm.iq_scatter_ascii([], [])
    lines = art.splitlines()
    assert len(lines) == 21 and all(len(ln) == 21 for ln in lines)
    assert any(c not in " |-" for c in lines[10])
    assert all(c in " |-" for c in lines[0] + lines[-1])

    class Rec:
        prn = 7
        ip_hist = ip.tolist()
        qp_hist = qp.tolist()
        code_freq_hist = [1.023e6] * 400

    p_t, p_j = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tm.save_iq_log(p_t, [Rec(), Rec()])
    jm.save_iq_log(p_j, [Rec(), Rec()])
    got, want = np.load(p_t), np.load(p_j)
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k])
