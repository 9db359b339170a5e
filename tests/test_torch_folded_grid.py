"""Port's folded search API (grid engine, kernel engine, packed input) vs
the JAX FoldedSearcher, on the scenes of tests/test_folded.py,
tests/test_mxu.py:110-169 and tests/test_onebit.py:74-89.

Bounds, each with its reason:

* Grid engine (``engine="xla"``, ``power_grid``): equal ``ca_shift`` and
  ``doppler_hz``; SNR rtol 1e-4 and the power grid within 1e-4 of its
  max.  Both packages run float32 FFTs; only the summation order and the
  replica spectra's rounding (float64-built here, a float32 FFT there)
  differ.
* Kernel engine (``engine="mxu"``): the same decisions; SNR rtol 0.03, the
  bound of the JAX package's bf16 kernel (the port's plain version on the
  CPU is float32).
* ``detections_refined``: the same PRNs; Doppler within 1 Hz and code
  phase within 0.05 samples (tests/test_torch_folded.py).
* Port against itself where only the batch layout or the mixing route
  differs (batch vs per block, packed vs bits): equal lags, SNR rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gnss.acquire import folded as jf
from tpu_gnss.config import ReceiverConfig
from tpu_gnss.signal import synth
from tpu_gnss_torch.acquire import folded as tf
from tests.torch_threads import one_torch_thread  # noqa: F401

SMALL = ReceiverConfig(fs=2.048e6, fc=0.512e6, max_fo=5000.0, fft_len=4096)
MXU_CFG = ReceiverConfig(fs=1.024e6, fc=0.256e6, max_fo=5000.0, fft_len=4096)


def _searchers(cfg, n_coherent=4):
    return (jf.FoldedSearcher(cfg, n_coherent=n_coherent, dop_chunk=8),
            tf.FoldedSearcher(cfg, n_coherent=n_coherent, device="cpu"))


def _two_sv_iq(js):
    """tests/test_mxu.py:110-131: PRNs 7 and 21, complex baseband."""
    svs = [synth.SvSignal(prn=7, doppler_hz=1800.0, code_phase_chips=303.0),
           synth.SvSignal(prn=21, doppler_hz=-2500.0,
                          code_phase_chips=777.0, amplitude=0.8)]
    return dict(iq=synth.synth_baseband(svs, MXU_CFG.fs, js.block_len,
                                        noise_std=0.4, seed=3))


def _one_sv_bits(js):
    """tests/test_folded.py:15-32: PRN 9 at +3 bins, 1-bit IF."""
    sv = synth.SvSignal(prn=9, doppler_hz=3 * SMALL.dop_bin_hz,
                        code_phase_chips=100.5)
    iq = synth.synth_baseband([sv], SMALL.fs, js.block_len, noise_std=0.5,
                              seed=5)
    return dict(bits=synth.baseband_to_1bit_if(iq, SMALL.fc, SMALL.fs))


SCENES = {"two_sv_iq": (MXU_CFG, _two_sv_iq, [7, 21]),
          "one_sv_bits": (SMALL, _one_sv_bits, [9])}


def _same_decisions(got, want, rows, snr_rtol):
    for name in ("ca_shift", "doppler_hz"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy()[rows],
            np.asarray(getattr(want, name))[rows])
    np.testing.assert_allclose(got.snr.numpy()[rows],
                               np.asarray(want.snr)[rows], rtol=snr_rtol)


@pytest.mark.parametrize("engine,snr_rtol", [("xla", 1e-4), ("mxu", 0.03)])
@pytest.mark.parametrize("scene", list(SCENES))
def test_acquire_matches_jax(scene, engine, snr_rtol):
    cfg, make, prns = SCENES[scene]
    js, ts = _searchers(cfg)
    data = make(js)
    want = js.acquire(**data, engine=engine)
    got = ts.acquire(**data, engine=engine)
    assert got.ca_shift.dtype == torch.int32
    assert got.snr.shape == (len(cfg.prns),)
    rows = [p - 1 for p in prns]
    _same_decisions(got, want, rows, snr_rtol)
    assert [d["prn"] for d in ts.detections(got)] == \
        [d["prn"] for d in js.detections(want)] == prns


@pytest.mark.parametrize("engine,snr_rtol", [("xla", 1e-4), ("mxu", 0.03)])
def test_noncoherent_3_matches_jax(engine, snr_rtol):
    """tests/test_mxu.py:134-151: a weak PRN 13 over 3 blocks of 2 ms."""
    js, ts = _searchers(MXU_CFG, n_coherent=2)
    sv = synth.SvSignal(prn=13, doppler_hz=900.0, code_phase_chips=42.0,
                        amplitude=0.35)
    iq = synth.synth_baseband([sv], MXU_CFG.fs, 3 * js.block_len,
                              noise_std=1.0, seed=11)
    want = js.acquire(iq=iq, n_noncoherent=3, engine=engine)
    got = ts.acquire(iq=iq, n_noncoherent=3, engine=engine)
    _same_decisions(got, want, [12], snr_rtol)


def test_noncoherent_16_weak_signal_and_false_alarm():
    """tests/test_folded.py:163-187: invisible in one block, found in 16;
    pure noise stays silent under the same 16-block threshold."""
    js, ts = _searchers(SMALL)
    k = 16
    sv = synth.SvSignal(prn=22, doppler_hz=800.0, code_phase_chips=50.0,
                        amplitude=0.06)
    iq = synth.synth_baseband([sv], SMALL.fs, k * ts.block_len,
                              noise_std=1.0, seed=7)
    bits = synth.baseband_to_1bit_if(iq, SMALL.fc, SMALL.fs)
    assert ts.detections(ts.acquire(bits=bits)) == []
    got = ts.acquire(bits=bits, n_noncoherent=k)
    want = js.acquire(bits=bits, n_noncoherent=k)
    _same_decisions(got, want, [21], 1e-4)
    dets = ts.detections(got, n_noncoherent=k)
    assert [d["prn"] for d in dets] == [22]
    assert dets == [{**d, "snr": pytest.approx(d["snr"], rel=1e-4)}
                    for d in js.detections(want, n_noncoherent=k)]
    nbits = np.random.default_rng(3).integers(
        0, 2, k * ts.block_len).astype(np.uint8)
    assert ts.detections(ts.acquire(bits=nbits, n_noncoherent=k),
                         n_noncoherent=k) == []


def test_power_grid_and_detections_refined_match_jax():
    """tests/test_mxu.py:154-169's scene, through the full grid."""
    js, ts = _searchers(MXU_CFG)
    svs = [synth.SvSignal(prn=7, doppler_hz=1840.0, code_phase_chips=303.4),
           synth.SvSignal(prn=21, doppler_hz=-2460.0,
                          code_phase_chips=777.7, amplitude=0.8)]
    iq = synth.synth_baseband(svs, MXU_CFG.fs, js.block_len, noise_std=0.4,
                              seed=7)
    pj = np.asarray(js.power_grid(iq=iq))
    pt = ts.power_grid(iq=iq)
    assert pt.shape == pj.shape == (32, len(ts.dops_hz), ts.period)
    assert float(np.abs(pt.numpy() - pj).max()) <= 1e-4 * float(pj.max())
    want = js.detections_refined(pj)
    got = ts.detections_refined(pt)
    assert [d["prn"] for d in got] == [d["prn"] for d in want] == [7, 21]
    p = ts.period
    for w, g in zip(want, got):
        assert abs(g["doppler_hz"] - w["doppler_hz"]) < 1.0
        assert abs((g["ca_shift"] - w["ca_shift"] + p / 2) % p - p / 2) < 0.05
    # the kernel path refines to the same seeds (tests/test_mxu.py:154-169)
    fast = ts.detections_refined_fast(iq=iq)
    assert [d["prn"] for d in fast] == [7, 21]
    for w, g in zip(got, fast):
        assert abs(g["doppler_hz"] - w["doppler_hz"]) < 1.0
        assert abs((g["ca_shift"] - w["ca_shift"] + p / 2) % p - p / 2) < 0.05


@pytest.mark.parametrize("case", ["edge_row", "wrap_lag", "interior",
                                  "zero_row"])
def test_refine_peak_matches_jax(case):
    rng = np.random.default_rng(4)
    n_dop, p = 7, 50
    dops = (np.arange(n_dop) - 3) * 250.0
    g = rng.random((2, n_dop, p)).astype(np.float32)
    d0, l0 = {"edge_row": (0, 20), "wrap_lag": (4, p - 1),
              "interior": (3, 0), "zero_row": (0, 0)}[case]
    g[1, d0, l0] = 40.0
    if case == "zero_row":
        g[1] = 0.0
    want = jf.refine_peak(g, dops, 1)
    got = tf.refine_peak(g, dops, 1)
    assert got == pytest.approx(want)
    if case == "zero_row":
        assert got["snr"] == 0.0


def test_reduce_grid_first_max_tie_break():
    """Equal cells: the first maximal lag and the first best Doppler win,
    as in the reference."""
    pwr = np.ones((2, 4, 6), np.float32)
    pwr[0, :, [1, 4]] = 5.0             # every row: lags 1 and 4 tie
    pwr[1, 2, 3] = pwr[1, 3, 0] = 7.0   # Doppler rows 2 and 3 tie
    dops = np.array([-500.0, 0.0, 500.0, 1000.0], np.float32)
    want = jf.reduce_grid(jnp.asarray(pwr), jnp.asarray(dops))
    got = tf.reduce_grid(torch.from_numpy(pwr), torch.from_numpy(dops))
    np.testing.assert_array_equal(got.ca_shift.numpy(), [1, 3])
    np.testing.assert_array_equal(got.doppler_hz.numpy(), [-500.0, 500.0])
    _same_decisions(got, want, [0, 1], 1e-6)   # SNR: sum order only


def _batch_bits(ts):
    """tests/test_folded.py:68-89: a PRN 11 block and a noise block."""
    sv = synth.SvSignal(prn=11, doppler_hz=900.0, code_phase_chips=77.0)
    iq = synth.synth_baseband([sv], SMALL.fs, ts.block_len, noise_std=0.6,
                              seed=1)
    b1 = synth.baseband_to_1bit_if(iq, SMALL.fc, SMALL.fs)
    b2 = np.random.default_rng(5).integers(0, 2, ts.block_len
                                           ).astype(np.uint8)
    return np.stack([b1, b2])


def test_acquire_folded_batch_matches_per_block_and_jax():
    js, ts = _searchers(SMALL)
    batch = _batch_bits(ts)
    kw = dict(fs=SMALL.fs, lo_rate=SMALL.lo_rate, n_coherent=4,
              from_bits=True, period=ts.period)
    got = tf.acquire_folded_batch(torch.from_numpy(batch), ts.code_ffts_p,
                                  ts.dops_hz, **kw)
    assert got.snr.shape == (2, 32)
    one = ts.acquire(bits=batch[0])
    assert int(got.ca_shift[0, 10]) == int(one.ca_shift[10])
    np.testing.assert_allclose(float(got.snr[0, 10]), float(one.snr[10]),
                               rtol=1e-5)
    assert float(got.snr[1].max()) < 25
    want = jf.acquire_folded_batch(jnp.asarray(batch), js.code_ffts_p,
                                   js.dops_hz, dop_chunk=js.dop_chunk, **kw)
    for b in range(2):
        rows = list(range(32)) if b == 0 else [10]
        _same_decisions(tf.FoldedResult(*(a[b] for a in got)),
                        jf.FoldedResult(*(a[b] for a in want)), rows, 1e-4)


def test_acquire_folded_batch_mxu_per_block():
    """accumulate=False: each row of the batch == acquire(engine="mxu") of
    that block alone, and the JAX kernel's decisions on the batch."""
    js, ts = _searchers(SMALL)
    batch = _batch_bits(ts)
    cw_r, cw_i = ts.mxu_code_planes()
    kw = dict(fs=SMALL.fs, lo_rate=SMALL.lo_rate, n_coherent=4,
              from_bits=True, period=ts.period, nf=ts.nf)
    got = tf.acquire_folded_batch_mxu(torch.from_numpy(batch), cw_r, cw_i,
                                      ts.dops_hz, **kw)
    assert got.snr.shape == (2, 32)
    for b in range(2):
        one = ts.acquire(bits=batch[b], engine="mxu")
        _same_decisions(tf.FoldedResult(*(a[b] for a in got)),
                        tf.FoldedResult(*(a.numpy() for a in one)),
                        list(range(32)), 1e-5)
    jr, ji = js.mxu_code_planes()
    want = jf.acquire_folded_batch_mxu(
        jnp.asarray(batch), jr, ji, js.dops_hz, dop_chunk=js.dop_chunk,
        interpret=True, **kw)
    _same_decisions(tf.FoldedResult(*(a[0] for a in got)),
                    jf.FoldedResult(*(a[0] for a in want)), [10], 0.03)


def test_acquire_packed_matches_bits_and_jax():
    """tests/test_onebit.py:74-89: the packed route == the bits route."""
    js, ts = _searchers(SMALL)
    sv = synth.SvSignal(prn=13, doppler_hz=600.0, code_phase_chips=200.0)
    iq = synth.synth_baseband([sv], SMALL.fs, ts.block_len, noise_std=0.5,
                              seed=2)
    bits = synth.baseband_to_1bit_if(iq, SMALL.fc, SMALL.fs)
    got = ts.acquire_packed(bits)
    _same_decisions(got, ts.acquire(bits=bits), list(range(32)), 1e-5)
    _same_decisions(got, js.acquire_packed(bits), [12], 1e-4)
    assert [d["prn"] for d in ts.detections(got)] == [13]


def test_acquire_packed_rejects_plane_words_and_short_input():
    _, ts = _searchers(SMALL)
    with pytest.raises(ValueError, match="bit-plane"):
        ts.acquire_packed(np.zeros((8, 128), np.uint32))
    with pytest.raises(ValueError):
        ts.acquire_packed(np.zeros(100, np.uint8))
    with pytest.raises(ValueError):
        ts.acquire(bits=np.zeros(100, np.uint8))
    with pytest.raises(ValueError):
        ts.power_grid(bits=np.zeros(ts.block_len, np.uint8), n_noncoherent=2)
    with pytest.raises(ValueError):
        ts.acquire(iq=np.zeros(ts.block_len, np.complex64), engine="gpu")


@pytest.mark.parametrize("engine", ["xla", "mxu"])
def test_zero_block_gives_no_detections(engine):
    """An all-zero block gives NaN SNRs, which never pass the threshold."""
    _, ts = _searchers(MXU_CFG)
    res = ts.acquire(iq=np.zeros(ts.block_len, np.complex64), engine=engine)
    assert ts.detections(res) == []
    assert ts.detections_refined(
        ts.power_grid(iq=np.zeros(ts.block_len, np.complex64))) == []


def test_mxu_supported_matches_jax():
    for fs in (1.024e6, 2.048e6, 5.456e6):
        cfg = ReceiverConfig(fs=fs, fc=fs / 4, max_fo=5000.0)
        js, ts = _searchers(cfg)
        assert ts.mxu_supported() == js.mxu_supported()
