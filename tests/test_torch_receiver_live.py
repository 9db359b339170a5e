"""The port's receiver options beyond the offline default: live mode, the
gather correlator, the grid acquisition engine, history bounding and the
probation watchdog, against the JAX receiver or its own tests.

Scenes are the reference's SMALL two-SV recipes of tests/test_stream.py
(2.048 Msps), the port on the CPU.
"""

import threading
import time

import numpy as np
import pytest

from tpu_gnss.config import ReceiverConfig
from tpu_gnss_torch.io import loaders as tld
from tpu_gnss_torch.io import stream as tst
from tpu_gnss_torch.receiver import ChannelRecord, Receiver
from tpu_gnss_torch.signal import synth

from tests.test_torch_receiver_iq import assert_matches_jax
from tests.torch_threads import one_torch_thread  # noqa: F401

SMALL = ReceiverConfig(fs=2.048e6, fc=0.512e6, max_fo=5000.0, fft_len=4096)
FS = SMALL.fs
SVS = [synth.SvSignal(prn=9, doppler_hz=500.0, code_phase_chips=300.0),
       synth.SvSignal(prn=17, doppler_hz=-1200.0, code_phase_chips=10.0)]


@pytest.fixture(scope="module")
def payload():
    """Bit-packed 1-bit IF bytes of the 2 s two-SV scene."""
    iq = synth.synth_baseband(SVS, FS, int(2.0 * FS), noise_std=0.4, seed=4)
    return tld.pack_1bit(synth.baseband_to_1bit_if(iq, SMALL.fc, FS))


@pytest.mark.parametrize("opts", [dict(fft_correlator=False),
                                  dict(acq_engine="xla")],
                         ids=["gather", "xla-engine"])
def test_options_match_jax(tmp_path, payload, opts):
    """The gather correlator (code tables, no spectra) and the FFT grid
    acquisition engine, against the JAX receiver with the same option.
    The two searches refine the code phase in different float orders
    (1e-8 chips apart), which the prompt histories carry at 1e-4."""
    from tpu_gnss.io.stream import FileSource1Bit as JaxFileSource1Bit
    from tpu_gnss.receiver import Receiver as JaxReceiver
    path = tmp_path / "cap.bin"
    path.write_bytes(payload)
    got = Receiver(SMALL, device="cpu", **opts).process_source(
        tst.FileSource1Bit(str(path), SMALL), chunk_s=1.0)
    want = JaxReceiver(SMALL, **opts).process_source(
        JaxFileSource1Bit(str(path), SMALL), chunk_s=1.0)
    assert_matches_jax(got, want, prompt_rel=1e-3)


def test_follow_receiver_live_mode(tmp_path, payload):
    """Live mode follows a growing 1-bit capture from a writer thread to
    tracking lock (tests/test_stream.py:372-407), with in-stream solving
    and history bounding on; 2 s hold no subframe, so no fix arrives."""
    path = tmp_path / "live.bin"
    path.write_bytes(b"")

    def writer():
        step = len(payload) // 16
        with open(path, "ab") as f:
            for i in range(0, len(payload), step):
                f.write(payload[i: i + step])
                f.flush()
                time.sleep(0.01)
        (tmp_path / "live.bin.done").touch()

    src = tst.FollowSource1Bit(str(path), SMALL, stall_timeout_s=10.0)
    fixes = []
    t = threading.Thread(target=writer)
    t.start()
    out = Receiver(SMALL, max_history_s=600.0, device="cpu").process_source(
        src, chunk_s=0.5, on_solution=fixes.append)
    t.join()
    assert not src.stalled
    assert sorted(d["prn"] for d in out.detections) == [9, 17]
    for r in out.channels:
        assert r.n_epochs == 2000 and not r.lost
        assert np.abs(r.ip_hist[-100:]).mean() > 0.4 * 2048
    assert fixes == out.solutions == []


def test_follow_skip_ahead_recovers(tmp_path, payload):
    """With max_lag set and the whole capture on disk, the reader skips
    ahead; the upload's sample index advances by the skipped samples, so
    the 1-bit LO mix stays in phase and the PRN is tracked at the tail
    (tests/test_stream.py:682-709)."""
    path = tmp_path / "lag.bin"
    path.write_bytes(payload)
    (tmp_path / "lag.bin.done").touch()
    src = tst.FollowSource1Bit(str(path), SMALL, stall_timeout_s=5.0,
                               max_lag_s=1.0)
    out = Receiver(SMALL, los_timeout_s=1.0, reacq_interval_s=1.0,
                   device="cpu").process_source(
        src, chunk_s=0.5, on_solution=lambda s: None)
    assert src.reader.skipped_bytes > 0
    prn9 = [r for r in out.channels if r.prn == 9]
    assert prn9
    assert np.abs(prn9[-1].ip_hist[-100:]).mean() > 0.4 * 2048


def test_probation_frees_false_acquisition():
    """A channel whose decoded stream never yields a parity-valid
    subframe is freed after ``probation_s`` (tests/test_stream.py:
    712-740)."""
    recv = Receiver(SMALL, probation_s=30.0, device="cpu")
    z = np.zeros(40000, np.float32)
    steady = np.full(40000, 50.0, np.float32)
    chans = []
    for ch, decoded, subs in ((0, 35000, []),
                              (1, 35000, [dict(sid=1, tow=7, bit_epoch=100,
                                               a_edge=0.0)]),
                              (2, 10000, [])):
        r = ChannelRecord(ch=ch, prn=5 + ch, start_epoch=0)
        r.append_hist(steady, z, z, z, z)
        r._decoded_upto = decoded
        r.subframes = subs
        chans.append(r)
    recv._watchdog(chans)
    assert [r.lost for r in chans] == [True, False, False]


def test_trim_and_code_lock_bookkeeping_match_jax():
    """``trim_to``, ``abs_slice``/``abs_at`` and ``code_lock_at`` on a
    trimmed history equal the reference's ChannelRecord."""
    from tpu_gnss.receiver import ChannelRecord as JaxRecord
    rng = np.random.default_rng(0)
    recs = (ChannelRecord(ch=0, prn=5, start_epoch=0, code_phase0=10.0),
            JaxRecord(ch=0, prn=5, start_epoch=0, code_phase0=10.0))
    for k in range(6):
        ip, qp, cf, caf = (rng.standard_normal(1000).astype(np.float32)
                           for _ in range(4))
        cp = ((10.0 + np.arange(1000) * 1e-3 + k) % 1023).astype(np.float32)
        recs[0].append_hist(ip, qp, cf, caf, cp)
        recs[1].append_hist(ip, qp, cf, caf, 1e-3, cp=cp)
        for r in recs:
            r.code_lock_hist.append((r.n_epochs, 2.0 - 0.2 * k))
    for r in recs:
        r.trim_to(2500)
    got, want = recs
    assert got.trim_epochs == want.trim_epochs == 3000
    for key in ("ip", "chips", "caf"):
        np.testing.assert_array_equal(got.abs_slice(key, 2000, 4500),
                                      want.abs_slice(key, 2000, 4500))
        assert got.abs_at(key, 4321) == want.abs_at(key, 4321)
    for e in (100, 999, 1500, 3200, 5999, 6500, 9000):
        assert got.code_lock_at(e) == want.code_lock_at(e)


def test_unknown_engine_raises():
    with pytest.raises(ValueError, match="acq_engine"):
        Receiver(SMALL, acq_engine="fast", device="cpu")
