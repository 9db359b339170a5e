"""The port's receiver on an 8-bit I/Q capture, link by link, against
the JAX receiver.

The SMALL 2 s scene of tests/test_stream.py:428-537 (PRNs 9 and 17 at
2.048 Msps, x40-gain int8 I/Q) goes through ``IQFileSource`` into both
receivers, the port's on the CPU.  For every ``transfer_dtype`` the two
must detect the same PRNs with Doppler within one 250 Hz bin and code
phase within one sample, and lock the same channels; their prompt
histories agree to 1e-4 (the quantizers are the same arithmetic).  DC
removal is off, as in the reference's link tests; the device-side DC
removal is held in tests/test_torch_xfer.py.  Within the port, the
raw-byte link equals the host conversion path, and the int4 and int2
links meet the reference's own bars against int8.
"""

import numpy as np
import pytest

from tpu_gnss.config import ReceiverConfig
from tpu_gnss_torch.io import stream as tst
from tpu_gnss_torch.receiver import Receiver
from tpu_gnss_torch.signal import synth
from tpu_gnss_torch.track.quality import pll_lock_metric
from tests.torch_threads import one_torch_thread  # noqa: F401

SMALL = ReceiverConfig(fs=2.048e6, fc=0.512e6, max_fo=5000.0, fft_len=4096)
FS = SMALL.fs


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """x40-gain int8 I/Q capture of the reference's two-SV SMALL scene."""
    svs = [synth.SvSignal(prn=9, doppler_hz=500.0, code_phase_chips=300.0),
           synth.SvSignal(prn=17, doppler_hz=-1200.0, code_phase_chips=10.0)]
    iq = synth.synth_baseband(svs, FS, int(2.0 * FS), noise_std=0.4, seed=4)
    scale = 40.0 / np.abs(iq).max()
    raw = np.empty(2 * len(iq), np.int8)
    raw[0::2] = np.clip(np.rint(iq.real * scale), -127, 127)
    raw[1::2] = np.clip(np.rint(iq.imag * scale), -127, 127)
    path = tmp_path_factory.mktemp("torch_iq") / "cap_iq8.bin"
    raw.tofile(path)
    return str(path)


def _locked(res):
    return {(r.ch, r.prn) for r in res.channels
            if not r.lost and r.n_epochs >= 2000
            and pll_lock_metric(r.ip_hist, r.qp_hist, window=1000) > 0.45}


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


def assert_matches_jax(got, want, prompt_rel=1e-4):
    """Same PRNs, Doppler within one bin, code phase within one sample,
    same locked channels, prompt histories within ``prompt_rel``."""
    g = {d["prn"]: d for d in got.detections}
    w = {d["prn"]: d for d in want.detections}
    assert len(g) >= 2 and set(g) == set(w)
    p = FS / 1000
    for prn in g:
        assert abs(g[prn]["doppler_hz"] - w[prn]["doppler_hz"]) < 250.0
        dca = (g[prn]["ca_shift"] - w[prn]["ca_shift"] + p / 2) % p - p / 2
        assert abs(dca) < 1.0
    assert len(_locked(got)) >= 2 and _locked(got) == _locked(want)
    assert len(got.channels) == len(want.channels)
    for a, b in zip(got.channels, want.channels):
        assert (a.ch, a.prn, a.start_epoch) == (b.ch, b.prn, b.start_epoch)
        assert _rel(a.ip_hist, b.ip_hist) < prompt_rel


@pytest.fixture(scope="module")
def port_run(capture):
    """The port's receiver on the capture over one link (remove_dc off, as
    the reference's link tests), each link run once for the module."""
    cache = {}

    def run(link):
        if link not in cache:
            cache[link] = Receiver(SMALL, transfer_dtype=link,
                                   device="cpu").process_source(
                tst.IQFileSource(capture, FS, remove_dc=False), chunk_s=1.0)
        return cache[link]
    return run


@pytest.mark.parametrize("link", ["int8", "int4", "int2", "float32"])
def test_iq_capture_links_match_jax(capture, port_run, link):
    from tpu_gnss.io.stream import IQFileSource as JaxIQFileSource
    from tpu_gnss.receiver import Receiver as JaxReceiver
    want = JaxReceiver(SMALL, transfer_dtype=link).process_source(
        JaxIQFileSource(capture, FS, remove_dc=False), chunk_s=1.0)
    assert_matches_jax(port_run(link), want)


class NoRaw(tst.SampleSource):
    """The same source with the raw-byte link hidden."""

    def __init__(self, inner):
        self._inner = inner
        self.fs = inner.fs

    def blocks(self, block_len):
        return self._inner.blocks(block_len)


def test_rawiq_path_equals_host_path(capture, port_run):
    """The capture's own bytes converted on the device equal the host
    conversion uploaded as exact samples, end to end (remove_dc off, so
    both paths see the same samples)."""
    res_raw = port_run("int8")
    res_host = Receiver(SMALL, transfer_dtype="float32",
                        device="cpu").process_source(
        NoRaw(tst.IQFileSource(capture, FS, remove_dc=False)), chunk_s=1.0)
    assert ([d["prn"] for d in res_raw.detections]
            == [d["prn"] for d in res_host.detections] != [])
    assert len(res_raw.channels) == len(res_host.channels)
    for a, b in zip(res_raw.channels, res_host.channels):
        assert (a.prn, a.start_epoch) == (b.prn, b.start_epoch)
        np.testing.assert_array_equal(a.ip_hist, b.ip_hist)
        np.testing.assert_array_equal(a.code_freq_hist, b.code_freq_hist)


def test_int4_and_int2_links_meet_the_reference_bars(port_run):
    """tests/test_stream.py:473-537: int4 within 5% of the int8 prompt
    history; int2 within 25% with NAV-bit signs kept after epoch 200."""
    res8 = port_run("int8")
    for link, bar in (("int4", 0.05), ("int2", 0.25)):
        res = port_run(link)
        assert ([d["prn"] for d in res.detections]
                == [d["prn"] for d in res8.detections])
        for a, b in zip(res.channels, res8.channels):
            assert (a.prn, a.start_epoch) == (b.prn, b.start_epoch)
            assert _rel(a.ip_hist, b.ip_hist) < bar
            assert np.mean(np.sign(a.ip_hist[200:])
                           == np.sign(b.ip_hist[200:])) > 0.98
