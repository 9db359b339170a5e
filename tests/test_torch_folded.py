"""Port's FoldedSearcher.detections_refined_fast vs the JAX one.

Both run the fused correlate-reduce grid (JAX: Pallas interpret mode,
bf16; port: the plain float32 version) and then the same ±2-bin FFT
window refinement in float32.  Bounds: the same PRNs; SNR rtol 0.03
(the bf16 kernel bound); Doppler within 1 Hz and code phase within 0.05
samples — once both grids pick the same centre bin, the refinement is
the same float32 FFT arithmetic, so only rounding order differs (the
JAX package holds its refined-vs-grid paths to the same 1 Hz / 0.05
sample bounds, tests/test_mxu.py:154-169).
"""

import dataclasses

import numpy as np
import pytest

from tpu_gnss.acquire import folded as jf
from tpu_gnss.config import SYNTHETIC, ReceiverConfig
from tpu_gnss.signal import synth
from tpu_gnss_torch.acquire import folded as tf
from tests.torch_threads import one_torch_thread  # noqa: F401

CFG = ReceiverConfig(fs=1.024e6, fc=0.256e6, max_fo=5000.0, fft_len=4096)


def _compare(want, got):
    assert [d["prn"] for d in got] == [d["prn"] for d in want]
    for w, g in zip(want, got):
        np.testing.assert_allclose(g["snr"], w["snr"], rtol=0.03)
        assert abs(g["doppler_hz"] - w["doppler_hz"]) < 1.0
        dca = (g["ca_shift"] - w["ca_shift"] + CFG.fs / 2000) % (
            CFG.fs / 1000) - CFG.fs / 2000
        assert abs(dca) < 0.05


@pytest.mark.parametrize("k", [1, 4])
def test_detections_refined_fast_matches_jax(k):
    svs = [synth.SvSignal(prn=7, doppler_hz=1840.0, code_phase_chips=303.4),
           synth.SvSignal(prn=21, doppler_hz=-2460.0,
                          code_phase_chips=777.7, amplitude=0.8 if k == 1
                          else 0.3)]
    js = jf.FoldedSearcher(CFG, n_coherent=4, dop_chunk=8)
    ts = tf.FoldedSearcher(CFG, n_coherent=4, device="cpu")
    iq = synth.synth_baseband(svs, CFG.fs, k * js.block_len, noise_std=0.6,
                              seed=7 + k)
    want = js.detections_refined_fast(iq=iq, n_noncoherent=k)
    got = ts.detections_refined_fast(iq=iq, n_noncoherent=k)
    assert {d["prn"] for d in got} == {7, 21}
    _compare(want, got)


def test_detections_from_bits_and_skip():
    """1-bit input mixed on device; skip_prns drops tracked PRNs."""
    cfg = ReceiverConfig(fs=2.048e6, fc=0.512e6, max_fo=5000.0,
                         fft_len=4096)
    ts = tf.FoldedSearcher(cfg, n_coherent=4, device="cpu")
    js = jf.FoldedSearcher(cfg, n_coherent=4)
    sv = synth.SvSignal(prn=13, doppler_hz=600.0, code_phase_chips=200.0)
    iq = synth.synth_baseband([sv], cfg.fs, ts.block_len, noise_std=0.5,
                              seed=2)
    bits = synth.baseband_to_1bit_if(iq, cfg.fc, cfg.fs)
    got = ts.detections_refined_fast(bits=bits)
    want = js.detections_refined_fast(bits=bits)
    assert [d["prn"] for d in got] == [d["prn"] for d in want] == [13]
    assert abs(got[0]["doppler_hz"] - want[0]["doppler_hz"]) < 1.0
    assert ts.detections_refined_fast(bits=bits, skip_prns=(13,)) == []


def test_zero_head_gives_no_detections():
    ts = tf.FoldedSearcher(CFG, n_coherent=4, device="cpu")
    assert ts.detections_refined_fast(
        iq=np.zeros(ts.block_len, np.complex64)) == []


def test_short_input_raises():
    ts = tf.FoldedSearcher(CFG, n_coherent=4, device="cpu")
    with pytest.raises(ValueError):
        ts.detections_refined_fast(iq=np.zeros(10, np.complex64))


def test_helpers_match_reference():
    for p in (1023, 2048, 5456, 8184, 10000):
        assert tf.fft_len_for_period(p) == jf.fft_len_for_period(p)
    for k in (1, 2, 4, 8):
        assert tf.noncoherent_threshold(25.0, k) == pytest.approx(
            jf.noncoherent_threshold(25.0, k))
    np.testing.assert_array_equal(tf.doppler_grid_hz(CFG, 250.0),
                                  jf.doppler_grid_hz(CFG, 250.0))


def test_prn8_fixture(synth_fixture_path):
    """The reference's PRN-8 capture: both engines find PRN 8."""
    from tpu_gnss.io import loaders
    cfg = dataclasses.replace(SYNTHETIC, prns=(7, 8, 21))
    js = jf.FoldedSearcher(cfg, n_coherent=4)
    ts = tf.FoldedSearcher(cfg, n_coherent=4, device="cpu")
    bits = loaders.load_1bit(synth_fixture_path, count=ts.block_len)
    want = js.detections_refined_fast(bits=bits)
    got = ts.detections_refined_fast(bits=bits)
    assert 8 in [d["prn"] for d in got]
    assert [d["prn"] for d in got] == [d["prn"] for d in want]
