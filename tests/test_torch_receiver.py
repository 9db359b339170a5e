"""The port's streaming receiver as a whole, against the JAX receiver.

Both receivers run ``process_source(FileSource1Bit)`` on the same short
1-bit IF capture of the e2e scene recipe (4 s, 6 SVs, 2.048 Msps), the
port on the CPU.  They must detect the same PRNs, with Doppler within
one 250 Hz search bin and code phase within one sample, and lock the
same channels.  The slow test is the port's counterpart of
tests/test_e2e.py::test_full_chain_from_1bit_if.
"""

import numpy as np
import pytest
import torch

from tpu_gnss.config import ReceiverConfig
from tpu_gnss_torch.io.stream import FileSource1Bit
from tpu_gnss_torch.receiver import Receiver
from tpu_gnss_torch.signal import scene
from tpu_gnss_torch.track.quality import pll_lock_metric
from tests.torch_threads import one_torch_thread  # noqa: F401

FS = scene.FS
CFG = ReceiverConfig(fs=FS, fc=FS / 4, max_fo=5000.0, fft_len=4096,
                     snr_threshold=17.0)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    iq, _, _ = scene.build_scene(duration=4.0)
    path = tmp_path_factory.mktemp("torch_rx") / "cap_1bit.bin"
    scene.write_1bit_capture(iq, CFG.fc, FS, path)
    return str(path)


def _locked(res):
    return {(r.ch, r.prn) for r in res.channels
            if not r.lost and r.n_epochs >= 2000
            and pll_lock_metric(r.ip_hist, r.qp_hist, window=1000) > 0.45}


def test_receiver_matches_jax_on_1bit_capture(capture):
    from tpu_gnss.io.stream import FileSource1Bit as JaxFileSource1Bit
    from tpu_gnss.receiver import Receiver as JaxReceiver
    got = Receiver(CFG, device="cpu").process_source(
        FileSource1Bit(capture, CFG))
    want = JaxReceiver(CFG).process_source(JaxFileSource1Bit(capture, CFG))
    g = {d["prn"]: d for d in got.detections}
    w = {d["prn"]: d for d in want.detections}
    assert len(g) >= 4 and set(g) == set(w)
    p = FS / 1000
    for prn in g:
        assert abs(g[prn]["doppler_hz"] - w[prn]["doppler_hz"]) < 250.0
        dca = (g[prn]["ca_shift"] - w[prn]["ca_shift"] + p / 2) % p - p / 2
        assert abs(dca) < 1.0
    assert len(_locked(got)) >= 4
    assert _locked(got) == _locked(want)


def test_scene_copy_is_sample_identical():
    from tests.test_e2e import build_scene
    want, ephs_w, rx_w = build_scene(duration=1.0, seed=42)
    got, ephs_g, rx_g = scene.build_scene(duration=1.0, seed=42)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(rx_g, rx_w)
    assert [e.m_0 for e in ephs_g] == [e.m_0 for e in ephs_w]


def test_unported_options_raise():
    """``mesh`` is not ported; a link name the reference does not know
    (``complex64`` among them) is refused."""
    with pytest.raises(NotImplementedError):
        Receiver(CFG, mesh=object(), device="cpu")
    for name in ("complex64", "int16", ""):
        with pytest.raises(ValueError, match="transfer_dtype"):
            Receiver(CFG, transfer_dtype=name, device="cpu")
    assert Receiver(CFG, device="cpu").transfer_dtype == "int8"


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        Receiver(CFG, device="cuda")


def test_process_iq_array_source():
    """Complex captures cross the default int8 link (ArraySource path)."""
    iq, _, _ = scene.build_scene(duration=1.0, n_sv=4, seed=3)
    cfg = ReceiverConfig(fs=FS, fc=FS / 4, max_fo=5000.0, fft_len=4096,
                         snr_threshold=20.0)
    recv = Receiver(cfg, device="cpu")
    assert recv.transfer_dtype == "int8"
    res = recv.process_iq(iq, chunk_s=0.5)
    assert {d["prn"] for d in res.detections} == {2, 3, 4, 5}
    assert all(r.n_epochs == 1000 for r in res.channels)


def test_default_link_matches_jax():
    """Both packages' default constructors run ``process_iq`` on one seeded
    scene: same PRNs, same locked channels, NAV-bit signs agreeing after
    epoch 200, and prompt histories within 1e-4.  The bound holds only
    when both quantize to int8 planes at the same scale: exact complex64
    samples differ from the reference's int8 planes by 5e-4 here."""
    from tpu_gnss.receiver import Receiver as JaxReceiver
    iq, _, _ = scene.build_scene(duration=2.0, n_sv=4, seed=9)
    got = Receiver(CFG, device="cpu").process_iq(iq)
    want = JaxReceiver(CFG).process_iq(iq)
    assert len(got.detections) >= 4
    assert ({d["prn"] for d in got.detections}
            == {d["prn"] for d in want.detections})
    lock = lambda res: {(r.ch, r.prn) for r in res.channels
                        if pll_lock_metric(r.ip_hist, r.qp_hist, 1000) > 0.45}
    assert len(lock(got)) >= 4 and lock(got) == lock(want)
    assert len(got.channels) == len(want.channels)
    for a, b in zip(got.channels, want.channels):
        assert (a.ch, a.prn) == (b.ch, b.prn)
        assert np.mean(np.sign(a.ip_hist[200:])
                       == np.sign(b.ip_hist[200:])) > 0.98
        assert (np.linalg.norm(a.ip_hist - b.ip_hist)
                < 1e-4 * np.linalg.norm(b.ip_hist))


@pytest.mark.slow
def test_full_chain_from_1bit_if(tmp_path):
    iq, _, rx = scene.build_scene(duration=20.0)
    path = tmp_path / "cap_1bit.bin"
    scene.write_1bit_capture(iq, CFG.fc, FS, path)
    res = Receiver(CFG, device="cpu").process_source(
        FileSource1Bit(str(path), CFG))
    assert len(res.detections) >= 4, res.detections
    decoded = [r for r in res.channels if r.eph.valid()]
    assert len(decoded) >= 4, f"only {len(decoded)} ephemerides decoded"
    assert res.solutions, "no fix through the 1-bit chain"
    sol = res.solutions[-1]
    err = np.linalg.norm(np.array([sol.x, sol.y, sol.z]) - np.array(rx))
    assert err < 60.0, f"position error {err:.1f} m through 1-bit front end"
