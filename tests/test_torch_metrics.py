"""The port's copy of the metrics and dashboard functions against
``tpu_gnss.utils.metrics`` on the same inputs (the cases of
tests/test_aux.py:74-126)."""

import numpy as np
import pytest

from tpu_gnss.utils import metrics as jm
from tpu_gnss_torch.utils import metrics as tm


def _fill(m):
    m.timings["acq"] += [0.25, 0.5]
    m.timings["track"] += [0.125]
    m.add("fixes")
    m.add("fixes", 2.0)
    return m


def test_metrics_registry():
    m = tm.Metrics()
    with m.stage("acq"):
        pass
    with m.stage("acq"):
        pass
    m.add("fixes")
    assert len(m.timings["acq"]) == 2 and m.counters["fixes"] == 1.0
    rep = m.report()
    assert "acq" in rep and "fixes" in rep
    # recording was off: nothing kept
    assert m.drain() == ([], [], 0)


def test_report_and_throughput_match_jax():
    """The report of stages and counters, the reference's rows (the port
    takes no ``samples=``, so prints no throughput)."""
    got, want = _fill(tm.Metrics()), _fill(jm.Metrics())
    assert got.report() == want.report()
    assert "Msamp/s" not in got.report()


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


def _seeded_block(xp, x):
    """A small seeded computation: Gram matrix, its trace and row sums."""
    g = x @ x.T
    return xp.trace(g), g.sum(1)


def test_device_trace_torch_cpu(tmp_path, capsys):
    """Around a seeded torch computation on the CPU the block's result is
    unchanged and a TensorBoard ``*.pt.trace.json`` lands under logdir."""
    import json

    import torch
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((48, 32)))
    want = _seeded_block(torch, x)
    with tm.device_trace(str(tmp_path)):
        got = _seeded_block(torch, x)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("aten::mm" in str(e.get("name", "")) for e in events)
    assert "device_trace" not in capsys.readouterr().err


def test_device_trace_profiler_that_cannot_start(tmp_path, monkeypatch,
                                                 capsys):
    """The reference's contract: the block runs and nothing raises when
    the profiler cannot start; the port adds one line on stderr."""
    import torch.profiler

    def broken(*a, **kw):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    ran = []
    with tm.device_trace(str(tmp_path)):
        ran.append(1)
    assert ran == [1] and list(tmp_path.iterdir()) == []
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and err[0].startswith(
        f"device_trace: no trace written to {tmp_path} (the profiler did "
        "not start")


def test_device_trace_jax_cpu(tmp_path, monkeypatch):
    """The JAX ``device_trace`` on the same block leaves its result
    unchanged too.  Its file is asserted only when ``jax.profiler``
    started here (the reference swallows a failed start)."""
    import jax
    import jax.numpy as jnp
    started = []
    real = jax.profiler.start_trace

    def spy(logdir, *a, **kw):
        real(logdir, *a, **kw)
        started.append(logdir)

    monkeypatch.setattr(jax.profiler, "start_trace", spy)
    x = np.random.default_rng(5).standard_normal((48, 32)).astype(np.float32)
    want = [np.asarray(v) for v in _seeded_block(jnp, jnp.asarray(x))]
    with jm.device_trace(str(tmp_path)):
        got = [np.asarray(v) for v in _seeded_block(jnp, jnp.asarray(x))]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    if started:
        assert list(tmp_path.rglob("*.xplane.pb")), list(tmp_path.rglob("*"))
