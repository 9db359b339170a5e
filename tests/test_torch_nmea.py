"""The port's NMEA monitor (``tpu_gnss_torch.cli.nmea``) and writer
(``cli.nmea_out``) against the JAX package's.

The cases of tests/test_nmea.py run on the port's modules; the parsed
state of every sentence equals the reference parser's, and ``--compare``
prints the JAX CLI's JSON on the same two files.
"""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest

from tpu_gnss.cli import nmea as ref
from tpu_gnss_torch.cli import nmea, nmea_out
from tpu_gnss_torch.pvt import solve as ps


def cs(body: str) -> str:
    c = 0
    for ch in body:
        c ^= ord(ch)
    return f"${body}*{c:02X}"


SENTENCES = [
    cs("GPGGA,123519,4807.038,N,01131.000,E,1,08,0.9,545.4,M,46.9,M,,"),
    cs("GPGGA,0,3356.1,S,01829.2,W,1,05,1.0,10.0,M,,M,,"),
    cs("GPGGA,1,,,,,0,00,,,M,,M,,"),
    cs("GPGSA,A,3,04,05,09,12,,,,,,,,,2.5,1.3,2.1"),
    cs("GPGSV,2,1,08,01,40,083,46,02,17,308,41,12,07,344,39,14,22,228,45"),
    cs("GPGSV,2,2,08,23,66,120,42,25,05,090,31,29,57,200,50,31,30,270,44"),
    cs("GLGSV,1,1,02,70,10,100,30,71,,,"),
    cs("GPRMC,123519,A,4807.038,N,01131.000,E,022.4,084.4,230394,003.1,W"),
    cs("GPVTG,054.7,T,034.4,M,005.5,N,010.2,K"),
    cs("GPVTG,0.0,T,,M,,N,,K"),
    cs("GPGST,024603.00,3.2,6.6,4.7,47.3,5.8,5.6,22.0"),
    cs("GPZDA,1,2,3"),
    "$GPGGA,1,2,3*00",
    "GPGGA,no dollar",
]


def test_checksum_and_constellations_equal():
    for s in SENTENCES:
        assert nmea.checksum_ok(s) == ref.checksum_ok(s)
    for prn, talker in ((8, "GP"), (40, "GP"), (70, "GP"), (5, "GA"),
                        (5, "BD"), (5, "GQ"), (195, "GP"), (300, "GP")):
        assert (nmea.prn_constellation(prn, talker)
                == ref.prn_constellation(prn, talker))
    assert nmea.prn_constellation(5, "GA") == "Galileo"
    assert nmea.prn_constellation(195) == "QZSS"


def test_state_equal_sentence_by_sentence():
    """Every sentence moves the port's state as the reference's."""
    st, want = nmea.NmeaState(), ref.NmeaState()
    for s in SENTENCES:
        assert st.feed(s) == want.feed(s), s
        assert dataclasses.asdict(st) == dataclasses.asdict(want), s
    assert st.summary() == want.summary()
    assert abs(st.lat - (48 + 7.038 / 60)) < 1e-9
    assert st.used_prns == [4, 5, 9, 12] and st.speed_kmh == 10.2
    assert st.course_deg == 0.0 and st.alt_err_m == 22.0
    assert len(st.sats_in_view["GP"]) == 8


def test_compare_tracks_and_reader(tmp_path):
    class Sol:
        lat_deg = 52.9501
        lon_deg = -1.1499
    fixes = [("120000", 52.9500, -1.1500, 48.0)]
    out = nmea.compare_tracks(fixes, [Sol()])
    assert out == ref.compare_tracks(fixes, [Sol()])
    assert out["n"] == 1 and abs(out["d_north_m"] - 11.1) < 0.5
    assert nmea.compare_tracks([], [Sol()]) == dict(n=0)
    p = tmp_path / "track.nmea"
    p.write_text("\n".join([SENTENCES[0], "garbage", SENTENCES[1]]) + "\n")
    st = nmea.NmeaState()
    assert sum(1 for s in nmea.read_sentences(str(p)) if st.feed(s)) == 2
    assert list(nmea.read_sentences(iter(["a", "b"]))) == ["a", "b"]


def fake_solution(lat=52.95, lon=-1.15, alt=48.0, speed=3.0, course=45.0):
    """tests/test_nmea.py:95 with the port's PVT types."""
    x, y, z = ps.geodetic_to_ecef(lat, lon, alt)
    sol = ps.Solution(x=x, y=y, z=z, t_bias=1e-4, t_rx=302405.0,
                      iterations=5, converged=True, lat_deg=lat,
                      lon_deg=lon, alt_m=alt, n_sats=6, residual_rms_m=2.5)
    sol.vel = ps.VelocitySolution(
        vx=0, vy=0, vz=0, clk_drift=0.0,
        ve=speed * np.sin(np.radians(course)),
        vn=speed * np.cos(np.radians(course)), vu=0.0,
        speed_mps=speed, course_deg=course, n_sats=6)
    sol.dops = dict(pdop=2.1, hdop=1.2, vdop=1.7)
    sol.sats = [dict(prn=p, elev_deg=20.0 + 7 * i, az_deg=40.0 * i,
                     cn0_dbhz=44.0, used=True)
                for i, p in enumerate([2, 5, 12, 17, 24, 28])]
    return sol


@pytest.mark.parametrize("lat,lon,alt", [(52.95, -1.15, 48.0),
                                         (-33.9, -70.7, 520.0)])
def test_emit_parse_roundtrip(lat, lon, alt):
    """tests/test_nmea.py:114-150: our burst parses back to our fix."""
    sol = fake_solution(lat, lon, alt)
    burst = nmea_out.solution_burst(sol, week=2345)
    assert len(burst) >= 6 and all(nmea.checksum_ok(s) for s in burst)
    st = nmea.NmeaState()
    for s in burst:
        st.feed(s)
    assert abs(st.lat - lat) < 1e-5 and abs(st.lon - lon) < 1e-5
    assert abs(st.alt - alt) < 0.06
    assert st.n_sats_used == 6 and st.used_prns == [2, 5, 12, 17, 24, 28]
    assert abs(st.pdop - 2.1) < 1e-9
    assert abs(st.speed_kmh - sol.vel.speed_mps * 3.6) < 0.02
    assert abs(st.course_deg - 45.0) < 0.06 and abs(st.lat_err_m - 2.5) < 1e-9
    assert sorted(st.sats_in_view["GP"]) == [2, 5, 12, 17, 24, 28]


def test_compare_tracks_closes_loop(tmp_path):
    """fixes -> NMEA file -> monitor state -> compare_tracks ~ 0."""
    sols = [fake_solution() for _ in range(3)]
    path = tmp_path / "track.nmea"
    assert nmea_out.write_track(str(path), sols, week=2345) >= 18
    st = nmea.NmeaState()
    for line in nmea.read_sentences(str(path)):
        st.feed(line)
    assert len(st.fixes) == 3
    cmp = nmea.compare_tracks(st.fixes, sols)
    assert cmp["n"] == 3 and cmp["d_total_m"] < 1.5


def test_compare_cli_json_identical(tmp_path):
    """``--compare`` prints the JAX CLI's JSON on the same two files."""
    a, b = tmp_path / "a.nmea", tmp_path / "b.nmea"
    nmea_out.write_track(str(a), [fake_solution() for _ in range(3)],
                         week=2345)
    nmea_out.write_track(str(b), [fake_solution(lat=52.9501)
                                  for _ in range(3)], week=2345)
    outs = []
    for main in (nmea.main, ref.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main([str(a), "--compare", str(b)]) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    cmp = json.loads(outs[0].strip().splitlines()[-1])
    assert cmp["n"] == 3 and 5.0 < abs(cmp["d_north_m"]) < 20.0
    empty = tmp_path / "empty.nmea"
    empty.write_text("")
    with contextlib.redirect_stdout(io.StringIO()):
        assert nmea.main([str(a), "--compare", str(empty)]) == 1


@pytest.mark.parametrize("flags", [["--every", "2"], ["--live"]],
                         ids=["periodic", "live-headless"])
def test_monitor_cli_output_identical(tmp_path, flags):
    """The periodic dashboard, and ``--live`` without a terminal (it
    falls back to periodic printing), print what the JAX CLI prints."""
    f = tmp_path / "t.nmea"
    f.write_text("\n".join(SENTENCES) + "\n")
    outs = []
    for main in (nmea.main, ref.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            assert main([str(f)] + flags) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "used PRNs: [4, 5, 9, 12]" in outs[0]
