"""The reference's receiver scenarios through both packages on one scene.

Each test builds its scene with the port's ``signal.scene.build_scene``
(sample-identical to ``tests.test_e2e.build_scene``,
tests/test_torch_scene_options.py), runs the JAX ``Receiver`` and the
port's ``Receiver(..., device="cpu")`` on it, both on the fused-kernel
acquisition engine that each runs on its accelerator, holds both to the
oracle's own assertions and requires the same decisions: the same
detected PRNs,
Doppler within one 250 Hz bin, code phase within one sample, the same
locked channels and fix epochs, final positions within 1 m, and each
scenario's own decision (the lost and re-acquisition epochs, the gated
satellite set, the velocity, the IF-offset estimate).

The slow tests are the port's counterparts of tests/test_e2e.py:193,
:290, :326, :360, :405, :445 and tests/test_soak.py:30, at the oracles'
scenes.  The tier-1 tests run the config matrix of
tests/test_stream.py:1243-1290 whole, and the scenarios that show their
behaviour in a few seconds of signal.
"""

import threading
import time

import numpy as np
import pytest

from tpu_gnss_torch.config import ReceiverConfig
from tpu_gnss_torch.io import loaders
from tpu_gnss_torch.signal import rfchannel, scene, synth
from tpu_gnss_torch.track.quality import pll_lock_metric
from tests.torch_threads import one_torch_thread  # noqa: F401

FS = scene.FS
DOP_BIN_HZ = 250.0


def _cfg(pkg, fs=FS, **kw):
    kw = dict(dict(fc=fs / 4, max_fo=5000.0, fft_len=4096,
                   snr_threshold=20.0), **kw)
    if pkg == "jax":
        from tpu_gnss.config import ReceiverConfig as JaxConfig
        return JaxConfig(fs=fs, **kw)
    return ReceiverConfig(fs=fs, **kw)


def _receiver(pkg, cfg, **kw):
    if pkg == "jax":
        from tpu_gnss.receiver import Receiver as JaxReceiver
        # the reference's "auto" picks the kernel engine on its
        # accelerator and the FFT grid engine on the CPU; the port's
        # picks the kernel engine on either (its plain version on the
        # CPU).  Both run the kernel engine here, Pallas interpreted.
        return JaxReceiver(cfg, **dict(dict(acq_engine="mxu"), **kw))
    from tpu_gnss_torch.receiver import Receiver
    return Receiver(cfg, device="cpu", **kw)


def _source(pkg, kind, cfg, data):
    if pkg == "jax":
        from tpu_gnss.io import stream
    else:
        from tpu_gnss_torch.io import stream
    if kind == "1bit":
        return stream.FileSource1Bit(data, cfg)
    if kind == "iq8":
        return stream.IQFileSource(data, cfg.fs, remove_dc=False)
    return stream.ArraySource(data, cfg.fs)


def run_both(kind, data, *, fs=FS, cfg_kw=None, rx_kw=None, chunk_s=1.0):
    """``{"jax": (receiver, result), "torch": (...)}`` of one scene:
    ``kind`` "iq" (a complex array), "1bit" or "iq8" (a capture path)."""
    out = {}
    for pkg in ("jax", "torch"):
        cfg = _cfg(pkg, fs, **(cfg_kw or {}))
        recv = _receiver(pkg, cfg, **(rx_kw or {}))
        out[pkg] = recv, recv.process_source(_source(pkg, kind, cfg, data),
                                             chunk_s=chunk_s)
    return out


def write_1bit(iq, tmp_path, name="cap_1bit.bin", fs=FS):
    path = tmp_path / name
    scene.write_1bit_capture(iq, fs / 4, fs, path)
    return str(path)


def locked(res, min_epochs=2000):
    return {(r.ch, r.prn) for r in res.channels
            if not r.lost and r.n_epochs >= min_epochs
            and pll_lock_metric(r.ip_hist, r.qp_hist, window=1000) > 0.45}


def pos(sol):
    return np.array([sol.x, sol.y, sol.z])


def err_m(sol, truth):
    return float(np.linalg.norm(pos(sol) - np.asarray(truth)))


def assert_same_decisions(runs, fs=FS, min_locked_epochs=2000):
    """Same PRNs, Doppler within a bin, code phase within a sample, the
    same locked channels and fix epochs, final fixes within 1 m."""
    got, want = runs["torch"][1], runs["jax"][1]
    g = {d["prn"]: d for d in got.detections}
    w = {d["prn"]: d for d in want.detections}
    assert set(g) == set(w), (sorted(g), sorted(w))
    p = fs / 1000
    for prn in g:
        assert abs(g[prn]["doppler_hz"] - w[prn]["doppler_hz"]) < DOP_BIN_HZ
        dca = (g[prn]["ca_shift"] - w[prn]["ca_shift"] + p / 2) % p - p / 2
        assert abs(dca) < 1.0, (prn, g[prn]["ca_shift"], w[prn]["ca_shift"])
    assert (locked(got, min_locked_epochs)
            == locked(want, min_locked_epochs))
    assert ([s.snap_epoch for s in got.solutions]
            == [s.snap_epoch for s in want.solutions])
    if want.solutions:
        assert np.linalg.norm(pos(got.solutions[-1])
                              - pos(want.solutions[-1])) < 1.0


# ---------------------------------------------------------------------------
# slow: the reference's oracles at their own scenes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene20():
    return scene.build_scene(duration=20.0)


@pytest.mark.slow
def test_complex_input_fix(scene20):
    """tests/test_e2e.py:193: ``process_iq`` on the 20 s scene."""
    iq, _, rx = scene20
    runs = run_both("iq", iq, chunk_s=2.0)
    for _, res in runs.values():
        assert len(res.detections) >= 4
        assert sum(r.eph.valid() for r in res.channels) >= 4
        assert len(res.solutions) >= 4
        sol = res.solutions[-1]
        assert err_m(sol, rx) < 8.0
        assert abs(sol.lat_deg - scene.TRUTH_LLA[0]) < 0.01
        assert abs(sol.lon_deg - scene.TRUTH_LLA[1]) < 0.01
        assert sol.vel is not None and sol.vel.speed_mps < 1.0
        assert abs(sol.vel.vu) < 2.0
    assert_same_decisions(runs)


@pytest.mark.slow
def test_fix_count_chunk_size_invariant(scene20, tmp_path):
    """tests/test_e2e.py:290: the same fix count at every ``chunk_s``."""
    iq, _, rx = scene20
    path = write_1bit(iq, tmp_path)
    counts = {}
    for ch_s in (0.5, 1.0, 4.0, 8.0):
        runs = run_both("1bit", path, cfg_kw=dict(snr_threshold=17.0),
                        chunk_s=ch_s)
        for pkg, (_, res) in runs.items():
            assert res.solutions, (pkg, ch_s)
            assert err_m(res.solutions[-1], rx) < 60.0, (pkg, ch_s)
            counts[pkg, ch_s] = len(res.solutions)
        assert_same_decisions(runs)
    assert len(set(counts.values())) == 1, counts


@pytest.mark.slow
def test_quality_gate_excludes_faded_sv():
    """tests/test_e2e.py:326: SV 3 faded to 0.05 from 20 s is gated out."""
    deg_idx = 3
    iq, _, rx = scene.build_scene(duration=26.0, degrade=(deg_idx, 20.0, 0.05))
    deg_prn = scene.eph_prn(deg_idx)
    sats = {}
    for gate in (True, False):
        runs = run_both("iq", iq, chunk_s=2.0,
                        rx_kw=dict(los_power_ratio=0.002, quality_gate=gate))
        assert_same_decisions(runs)
        for pkg, (_, res) in runs.items():
            sol = res.solutions[-1]
            assert sol.snap_epoch >= 24000
            sats[pkg, gate] = (sorted(s["prn"] for s in sol.sats),
                               err_m(sol, rx))
    for pkg in ("jax", "torch"):
        (g_prns, err_g), (u_prns, err_u) = sats[pkg, True], sats[pkg, False]
        assert deg_prn in u_prns and deg_prn not in g_prns, sats
        assert err_g < 10.0 and err_g <= err_u + 0.5, sats
    assert sats["jax", True][0] == sats["torch", True][0]
    assert sats["jax", False][0] == sats["torch", False][0]


@pytest.mark.slow
def test_moving_receiver_velocity():
    """tests/test_e2e.py:360: velocity and the RMC / VTG sentences."""
    from tpu_gnss.cli import nmea_out as jax_nmea_out
    from tpu_gnss_torch.cli import nmea_out
    v_enu = np.array([15.0, 8.0, 0.0])
    iq, _, rx = scene.build_scene(duration=20.0, rx_vel_enu=v_enu)
    runs = run_both("iq", iq, chunk_s=2.0)
    speed_true = float(np.hypot(v_enu[0], v_enu[1]))
    course_true = float(np.degrees(np.arctan2(v_enu[0], v_enu[1])))
    vels = {}
    for pkg, (_, res) in runs.items():
        assert res.solutions
        sol = res.solutions[-1]
        rx_t = (np.asarray(rx) + scene.enu_to_ecef_matrix(
            *scene.TRUTH_LLA[:2]) @ v_enu * (sol.snap_epoch * 1e-3))
        assert err_m(sol, rx_t) < 15.0
        v = sol.vel
        assert abs(v.ve - v_enu[0]) < 0.5 and abs(v.vn - v_enu[1]) < 0.5
        assert abs(v.vu - v_enu[2]) < 1.0
        assert abs(v.speed_mps - speed_true) < 0.5
        assert abs((v.course_deg - course_true + 180) % 360 - 180) < 3.0
        burst = (jax_nmea_out if pkg == "jax" else nmea_out).solution_burst(sol)
        rmc = next(s for s in burst if s.startswith("$GPRMC"))
        vtg = next(s for s in burst if s.startswith("$GPVTG"))
        rmc_f = rmc.split("*")[0].split(",")
        assert abs(float(rmc_f[7]) - speed_true * 3600.0 / 1852.0) < 1.0
        assert abs((float(rmc_f[8]) - course_true + 180) % 360 - 180) < 3.0
        assert abs(float(vtg.split("*")[0].split(",")[7])
                   - speed_true * 3.6) < 1.8
        vels[pkg] = np.array([v.ve, v.vn, v.vu])
    assert_same_decisions(runs)
    assert np.abs(vels["torch"] - vels["jax"]).max() < 0.1, vels


def wide_offset_capture(tmp_path, duration):
    """The replay scene of tests/test_e2e.py:405: noise 0.5 through
    ``apply_channel(+60 kHz, delay 777, gain 1.3)``, as a 1-bit capture."""
    iq, _, rx = scene.build_scene(duration=duration, noise=0.5)
    rxed = rfchannel.apply_channel(iq, FS, freq_offset_hz=60e3,
                                   delay_samples=777.0, gain=1.3)
    return write_1bit(rxed, tmp_path, "replay_1bit.bin"), rx


WIDE = dict(max_fo=100000.0, snr_threshold=17.0)


def assert_wide_offset(runs, min_dets=4):
    for pkg, (recv, res) in runs.items():
        assert len(res.detections) >= min_dets, pkg
        med = np.median([d["doppler_hz"] for d in res.detections])
        assert abs(med - 60e3) < 2000.0, (pkg, med)
        assert abs(recv._if_offset - 60e3) < 2000.0, (pkg, recv._if_offset)
    assert abs(runs["torch"][0]._if_offset - runs["jax"][0]._if_offset) < 250.0
    assert_same_decisions(runs)


@pytest.mark.slow
def test_wide_offset_replay_to_fix(tmp_path):
    """tests/test_e2e.py:405: a 60 kHz offset searched on +-100 kHz."""
    path, rx = wide_offset_capture(tmp_path, 20.0)
    runs = run_both("1bit", path, cfg_kw=WIDE)
    assert_wide_offset(runs)
    for _, res in runs.values():
        assert sum(r.eph.valid() for r in res.channels) >= 4
        assert res.solutions and err_m(res.solutions[-1], rx) < 15.0


@pytest.mark.slow
def test_doppler_ramp_high_dynamics():
    """tests/test_e2e.py:445: a 5 Hz/s common Doppler ramp."""
    iq, _, rx = scene.build_scene(duration=20.0, doppler_ramp_hz_s=5.0)
    runs = run_both("iq", iq, chunk_s=2.0)
    for _, res in runs.values():
        assert res.solutions
        sol = res.solutions[-1]
        assert sol.snap_epoch >= 16000
        assert err_m(sol, rx) < 15.0
    assert_same_decisions(runs)


def dropout_epochs(res, prn):
    """``(start, end, lost)`` of each of ``prn``'s channel records."""
    return [(r.start_epoch, r.start_epoch + r.n_epochs, r.lost)
            for r in res.channels if r.prn == prn]


@pytest.mark.slow
def test_soak_dropout_reacquire_fix_cadence(tmp_path):
    """tests/test_soak.py:30: PRN 2 blocked from 8 to 14 s of a 32 s
    capture is lost, re-acquired and held; fixes every 4 s."""
    duration, t0, t1 = 32.0, 8.0, 14.0
    iq, _, rx = scene.build_scene(duration=duration, dropout=(0, t0, t1))
    path = write_1bit(iq, tmp_path)
    del iq
    runs = run_both("1bit", path, cfg_kw=dict(snr_threshold=17.0))
    prn = scene.eph_prn(0)
    for pkg, (_, res) in runs.items():
        recs = [r for r in res.channels if r.prn == prn]
        assert len(recs) >= 2 and recs[0].lost, pkg
        t_lost = (recs[0].start_epoch + recs[0].n_epochs) * 1e-3
        assert t0 < t_lost < t1, (pkg, t_lost)
        assert recs[1].start_epoch * 1e-3 >= t1 and not recs[1].lost
        assert recs[1].n_epochs >= 5000
        snap_s = [s.snap_epoch * 1e-3 for s in res.solutions]
        assert snap_s and snap_s[0] <= 8.0
        expected = [t for t in np.arange(4.0, duration - 1.0, 4.0)
                    if t >= snap_s[0]]
        assert not set(np.round(expected, 3)) - set(np.round(snap_s, 3))
        assert max(err_m(s, rx) for s in res.solutions) < 4.0
    assert (dropout_epochs(runs["torch"][1], prn)
            == dropout_epochs(runs["jax"][1], prn))
    assert_same_decisions(runs)


MATRIX = [
    (2.046e6, 0.5, "1bit", 0),     # p=2046: chunk not 32-aligned
    (2.046e6, 1.0, "iq8", 123),    # odd tail on the rawiq path
    (2.048e6, 2.0, "1bit", 8216),  # packed path + odd word tail
    (2.048e6, 0.5, "iq8", 0),      # int2 link
]


def matrix_capture(tmp_path, fs, fmt, tail):
    """tests/test_stream.py:1250-1281: PRNs 9 and 17, 3 s plus ``tail``."""
    n = int(3.0 * fs) + tail
    n -= n % 8
    svs = [synth.SvSignal(prn=9, doppler_hz=500.0, code_phase_chips=300.0),
           synth.SvSignal(prn=17, doppler_hz=-1200.0, code_phase_chips=10.0)]
    iq = synth.synth_baseband(svs, fs, n, noise_std=0.4, seed=4)
    if fmt == "1bit":
        path = tmp_path / "cap.bin"
        path.write_bytes(loaders.pack_1bit(
            synth.baseband_to_1bit_if(iq, fs / 4, fs)))
        return str(path), n
    raw = np.empty(2 * n, np.int8)
    scale = 100.0 / max(np.abs(iq.real).max(), np.abs(iq.imag).max())
    raw[0::2] = np.clip(np.rint(iq.real * scale), -127, 127)
    raw[1::2] = np.clip(np.rint(iq.imag * scale), -127, 127)
    path = tmp_path / "cap_iq8.bin"
    raw.tofile(path)
    return str(path), n


def check_matrix(tmp_path, fs, chunk_s, fmt, tail, engine="mxu"):
    """The oracle's checks on both packages, and the same decisions.  On
    the kernel engine the 2.046 Msps 1-bit combination also detects PRN 3
    (SNR 17.415 against the threshold 17, in both packages alike): the
    oracle's exact PRN set holds on the FFT grid engine, which the
    reference's "auto" runs on the CPU, and not on the kernel engine that
    it runs on its accelerator.  There, PRNs 9 and 17 are held to the
    oracle's checks and the extra detection to the same in both."""
    path, n = matrix_capture(tmp_path, fs, fmt, tail)
    rx_kw = dict(acq_engine=engine)
    if fmt == "iq8":
        rx_kw["transfer_dtype"] = "int2" if chunk_s == 0.5 else "int8"
    runs = run_both(fmt, path, fs=fs, chunk_s=chunk_s, rx_kw=rx_kw,
                    cfg_kw=dict(snr_threshold=17.0))
    p = round(fs * 1e-3)
    for _, res in runs.values():
        prns = sorted(d["prn"] for d in res.detections)
        assert prns == ([3, 9, 17] if (engine, fs, fmt) ==
                        ("mxu", 2.046e6, "1bit") else [9, 17]), prns
        for r in res.channels:
            if r.prn in (9, 17):
                ip = np.abs(np.asarray(r.ip_hist[-100:]))
                assert ip.mean() > 0.2 * p
            assert (n // p // 10) * 10 - 10 <= r.n_epochs <= n // p
    assert_same_decisions(runs, fs=fs, min_locked_epochs=1000)
    assert ([r.n_epochs for r in runs["torch"][1].channels]
            == [r.n_epochs for r in runs["jax"][1].channels])


# ---------------------------------------------------------------------------
# tier-1: the scenarios that show in a few seconds of signal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fs,chunk_s,fmt,tail,engine",
                         [MATRIX[0] + ("xla",)]
                         + [m + ("mxu",) for m in MATRIX])
def test_receiver_config_matrix(tmp_path, fs, chunk_s, fmt, tail, engine):
    """tests/test_stream.py:1243-1290 whole (3 s scenes), on the kernel
    engine, and its 2.046 Msps 1-bit combination on the FFT grid engine
    too (P = 2046, chunks not 32-aligned)."""
    check_matrix(tmp_path, fs, chunk_s, fmt, tail, engine=engine)


def test_wide_offset_search_short(tmp_path):
    """2 s of the +60 kHz replay on the +-100 kHz grid: the same
    detections and offset estimate as the JAX receiver."""
    path, _ = wide_offset_capture(tmp_path, 2.0)
    runs = run_both("1bit", path, cfg_kw=WIDE)
    assert_wide_offset(runs)


def test_doppler_ramp_short():
    """3 s under the 5 Hz/s ramp: the same channels locked."""
    iq, _, _ = scene.build_scene(duration=3.0, n_sv=4,
                                 doppler_ramp_hz_s=5.0)
    runs = run_both("iq", iq, chunk_s=1.0)
    for _, res in runs.values():
        assert len(locked(res)) == 4
    assert_same_decisions(runs)


def test_dropout_reacquire_short(tmp_path):
    """PRN 2 blocked from 1.0 to 2.5 s of an 8 s capture, with the
    watchdog window and the search cadence cut to 1 s and 2 s (the soak
    runs the defaults, 2 s and 5 s): lost at 2 s, when the watchdog first
    reads a whole window without it, and re-acquired by the background
    search at 7 s, after the signal's return.  Both packages agree on
    both epochs."""
    iq, _, _ = scene.build_scene(duration=8.0, n_sv=4, dropout=(0, 1.0, 2.5))
    path = write_1bit(iq, tmp_path)
    runs = run_both("1bit", path, cfg_kw=dict(snr_threshold=17.0),
                    rx_kw=dict(los_timeout_s=1.0, reacq_interval_s=2.0))
    prn = scene.eph_prn(0)
    for _, res in runs.values():
        assert dropout_epochs(res, prn) == [(0, 2000, True),
                                            (7000, 8000, False)]
    assert_same_decisions(runs, min_locked_epochs=1000)


def test_reacquisition_applies_at_the_boundary_after_launch(tmp_path,
                                                            monkeypatch):
    """The port applies a background re-acquisition search at the chunk
    boundary after its launch, however long the search takes (its
    ``process_source`` docstring; the reference applies it when done,
    tpu_gnss/receiver.py:1037).  The dropout scene of
    ``test_dropout_reacquire_short`` through the port twice: as is, and
    with every background ``_cold_detections`` held for twice the first
    run's wall per chunk, longer than the tracker takes for a chunk.
    Both give the same channel records (PRN 2 lost at 2 s and back at 7
    s) and the same fixes."""
    from tpu_gnss_torch.receiver import Receiver
    iq, _, _ = scene.build_scene(duration=8.0, n_sv=4, dropout=(0, 1.0, 2.5))
    path = write_1bit(iq, tmp_path)
    del iq

    def run():
        cfg = _cfg("torch", snr_threshold=17.0)
        recv = _receiver("torch", cfg, los_timeout_s=1.0,
                         reacq_interval_s=2.0)
        t0 = time.perf_counter()
        res = recv.process_source(_source("torch", "1bit", cfg, path),
                                  chunk_s=1.0)
        return res, time.perf_counter() - t0

    def records(res):
        return [(r.prn, r.start_epoch, r.n_epochs, r.lost)
                for r in res.channels]

    base, wall = run()
    hold_s = 2.0 * wall / 8
    search = Receiver._cold_detections
    held = []

    def slow_search(self, *args, **kw):
        if threading.current_thread() is not threading.main_thread():
            time.sleep(hold_s)
            held.append(hold_s)
        return search(self, *args, **kw)

    monkeypatch.setattr(Receiver, "_cold_detections", slow_search)
    slow, _ = run()
    assert held, "no background search ran"
    prn = scene.eph_prn(0)
    for res in (base, slow):
        assert dropout_epochs(res, prn) == [(0, 2000, True),
                                            (7000, 8000, False)]
    assert records(slow) == records(base)
    assert ([(s.snap_epoch, *pos(s)) for s in slow.solutions]
            == [(s.snap_epoch, *pos(s)) for s in base.solutions])
