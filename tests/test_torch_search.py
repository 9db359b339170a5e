"""The port's exact-semantics ``Searcher`` against the JAX searcher and the
loop-form oracle (tests/oracle.py), on the CPU.

The cases of tests/test_acquire.py on its SMALL configuration (2.048 Msps,
fft_len 4096) and the Nottingham 5-SV golden reconstruction: the same
seeded numpy input goes through ``tpu_gnss.acquire.search`` and
``tpu_gnss_torch.acquire.search``.  ``lo_shift`` and ``ca_shift`` must be
equal, the SNR within rtol 2e-3 (the bar of tests/test_acquire.py:47).
"""

import numpy as np
import pytest
import torch

from tpu_gnss.acquire import search as JS
from tpu_gnss.config import NOTTINGHAM, ReceiverConfig
from tpu_gnss.signal import cacode, synth
from tpu_gnss_torch.acquire import search as TS
from tests import oracle
from tests.torch_threads import one_torch_thread  # noqa: F401

SMALL = ReceiverConfig(fs=2.048e6, fc=0.512e6, max_fo=5000.0, fft_len=4096)
SNR_RTOL = 2e-3


def _bits(cfg, svs, seed, noise=1.0):
    iq = synth.synth_baseband(svs, cfg.fs, cfg.fft_len, noise_std=noise,
                              seed=seed)
    return synth.baseband_to_1bit_if(iq, cfg.fc, cfg.fs)


def assert_same(got, want):
    """Port AcqResult against the JAX one: shifts equal, SNR within
    rtol 2e-3."""
    np.testing.assert_array_equal(got.lo_shift.numpy(),
                                  np.asarray(want.lo_shift))
    np.testing.assert_array_equal(got.ca_shift.numpy(),
                                  np.asarray(want.ca_shift))
    np.testing.assert_allclose(got.snr.numpy(), np.asarray(want.snr),
                               rtol=SNR_RTOL)


@pytest.fixture(scope="module")
def prn5_bits():
    return _bits(SMALL, [synth.SvSignal(prn=5, doppler_hz=1200.0,
                                        code_phase_chips=333.25)], seed=3)


def test_acquire_bits_matches_jax_and_oracle(prn5_bits):
    cfg, bits = SMALL, prn5_bits
    got = TS.Searcher(cfg, device="cpu").acquire_bits(bits)
    assert_same(got, JS.Searcher(cfg).acquire_bits(bits))
    data_fft = np.fft.fft(oracle.mix_block(bits, cfg.fc, cfg.fs))
    t1, t2 = cacode.taps(5)
    code_fft = np.fft.fft(oracle.replica(t1, t2, cfg.fs, cfg.fft_len))
    dops = range(-cfg.dop_max_bin, cfg.dop_max_bin + 1)
    snr, dop, lag = oracle.correlate(data_fft, code_fft, dops, cfg.lags)
    assert (int(got.lo_shift[4]), int(got.ca_shift[4])) == (dop, lag)
    np.testing.assert_allclose(float(got.snr[4]), snr, rtol=SNR_RTOL)


@pytest.mark.parametrize("chunk", [1, 7, 16, None])
def test_dop_chunk_invariance(chunk):
    """Every chunking gives the JAX result and the whole-grid result."""
    cfg = SMALL
    bits = _bits(cfg, [synth.SvSignal(prn=30, doppler_hz=-4 * cfg.dop_bin_hz,
                                      code_phase_chips=512.0)], seed=11)
    n = cfg.num_dop_bins if chunk is None else chunk
    got = TS.Searcher(cfg, dop_chunk=n, device="cpu").acquire_bits(bits)
    assert_same(got, JS.Searcher(cfg, dop_chunk=n).acquire_bits(bits))
    whole = TS.Searcher(cfg, dop_chunk=cfg.num_dop_bins,
                        device="cpu").acquire_bits(bits)
    assert torch.equal(got.lo_shift, whole.lo_shift)
    assert torch.equal(got.ca_shift, whole.ca_shift)
    assert (int(got.lo_shift[29]), float(got.snr[29])) == (-4, float(
        whole.snr[29]))


def test_default_dop_chunk_budget():
    """~256 MB per chunk buffer, clamped to the grid (search.py:285-289)."""
    for cfg in (SMALL, NOTTINGHAM,
                ReceiverConfig(fs=10e6, fc=2.6e6, max_fo=100000.0)):
        assert (TS.Searcher(cfg, device="cpu").dop_chunk
                == JS.Searcher(cfg).dop_chunk)


def test_acquire_iq_matches_jax():
    cfg = SMALL
    iq = synth.synth_baseband([synth.SvSignal(prn=2, doppler_hz=0.0,
                                              code_phase_chips=0.0)],
                              cfg.fs, cfg.fft_len, noise_std=0.2, seed=9)
    s = TS.Searcher(cfg, device="cpu")
    got = s.acquire_iq(iq)
    assert_same(got, JS.Searcher(cfg).acquire_iq(iq))
    assert float(got.snr[1]) > 100 and int(got.lo_shift[1]) == 0
    # a complex tensor already on the device takes the same path
    assert_same(s.acquire_iq(torch.from_numpy(iq)), got)


def test_acquire_bits_paired_matches_jax():
    """Compat path: block i searched against PRN i only, LO restarted per
    block."""
    cfg = SMALL
    rng = np.random.default_rng(17)
    blocks = rng.integers(0, 2, (32, cfg.fft_len)).astype(np.uint8)
    blocks[7] = _bits(cfg, [synth.SvSignal(prn=8, doppler_hz=1500.0,
                                           code_phase_chips=100.0)], seed=2)
    got = TS.Searcher(cfg, device="cpu").acquire_bits_paired(blocks)
    assert_same(got, JS.Searcher(cfg).acquire_bits_paired(blocks))
    assert float(got.snr[7]) > 100 and int(got.lo_shift[7]) == 3


def test_acquire_grid_pwr_matches_jax(prn5_bits):
    import jax.numpy as jnp
    cfg = SMALL
    mixed = TS.mix_baseband(torch.from_numpy(prn5_bits), cfg.lo_rate)
    data_fft = torch.fft.fft(mixed)
    code = TS.code_fft_table(cfg, "cpu")[4]
    dops = torch.from_numpy(TS._doppler_bins(cfg))
    got = TS.acquire_grid_pwr(data_fft, code, dops, lags=cfg.lags).numpy()
    want = np.asarray(JS.acquire_grid_pwr(
        jnp.asarray(data_fft.numpy()), jnp.asarray(code.numpy()),
        jnp.asarray(dops.numpy()), lags=cfg.lags))
    assert got.shape == (cfg.num_dop_bins, cfg.lags)
    np.testing.assert_allclose(got, want, rtol=SNR_RTOL,
                               atol=1e-6 * want.max())
    assert np.unravel_index(got.argmax(), got.shape) == np.unravel_index(
        want.argmax(), want.shape)


def test_wide_doppler_grid():
    """±100 kHz replay-style grid (reference README §2.1e)."""
    cfg = ReceiverConfig(fs=2.048e6, fc=0.512e6, max_fo=100000.0,
                         fft_len=4096)
    assert cfg.dop_max_bin == 200
    bits = _bits(cfg, [synth.SvSignal(prn=21, doppler_hz=150 * cfg.dop_bin_hz,
                                      code_phase_chips=700.0)], seed=13,
                 noise=0.5)
    got = TS.Searcher(cfg, device="cpu").acquire_bits(bits)
    assert_same(got, JS.Searcher(cfg).acquire_bits(bits))
    assert int(got.lo_shift[20]) == 150 and float(got.snr[20]) > 50


def test_nottingham_golden_reconstruction():
    """The published Nottingham 5-SV table (tests/test_acquire.py:140-168)
    from a synthetic reconstruction: the same integers as the JAX
    searcher, and the golden ones within one sample of code phase."""
    cfg = NOTTINGHAM
    golden = [(1, 6, 1465), (21, 8, 686), (29, -9, 3868),
              (30, -9, 2998), (31, -8, 2337)]
    svs = [synth.SvSignal(prn=prn, doppler_hz=lo * cfg.dop_bin_hz,
                          code_phase_chips=ca * 1023.0 / cfg.lags,
                          amplitude=1.0) for prn, lo, ca in golden]
    iq = synth.synth_baseband(svs, cfg.fs, cfg.fft_len, noise_std=1.5,
                              seed=29)
    bits = synth.baseband_to_1bit_if(iq, cfg.fc, cfg.fs)
    s = TS.Searcher(cfg, device="cpu")
    got = s.acquire_bits(bits)
    assert_same(got, JS.Searcher(cfg).acquire_bits(bits))
    for prn, lo, ca in golden:
        i = prn - 1
        assert float(got.snr[i]) >= 25, f"PRN {prn} below threshold"
        assert int(got.lo_shift[i]) == lo, f"PRN {prn} lo_shift"
        assert abs(int(got.ca_shift[i]) - ca) <= 1, f"PRN {prn} ca_shift"
    assert ({d["prn"] for d in s.detections(got)}
            >= {prn for prn, _, _ in golden})


def test_noise_gives_no_detection(rng):
    cfg = SMALL
    bits = rng.integers(0, 2, size=cfg.fft_len).astype(np.uint8)
    s = TS.Searcher(cfg, device="cpu")
    res = s.acquire_bits(bits)
    assert s.detections(res) == []
    assert_same(res, JS.Searcher(cfg).acquire_bits(bits))


def test_detection_records_match_jax(prn5_bits):
    got_s = TS.Searcher(SMALL, device="cpu")
    want_s = JS.Searcher(SMALL)
    got = got_s.detections(got_s.acquire_bits(prn5_bits))
    want = want_s.detections(want_s.acquire_bits(prn5_bits))
    assert [d["prn"] for d in got] == [d["prn"] for d in want] == [5]
    for g, w in zip(got, want):
        assert {k: g[k] for k in ("prn", "sv", "lo_shift", "ca_shift",
                                  "doppler_hz")} == \
            {k: w[k] for k in ("prn", "sv", "lo_shift", "ca_shift",
                               "doppler_hz")}
        assert g["snr"] == pytest.approx(w["snr"], rel=SNR_RTOL)


def test_wrong_length_raises():
    s = TS.Searcher(SMALL, device="cpu")
    with pytest.raises(ValueError, match="fft_len=4096"):
        s.acquire_bits(np.zeros(4000, np.uint8))
    with pytest.raises(ValueError, match="fft_len=4096"):
        s.acquire_iq(np.zeros(5000, np.complex64))


def test_first_maximum_wins():
    """Equal maxima resolve to the first, in lag and in Doppler order."""
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0], [5.0, 5.0, 5.0, 5.0],
                      [0.0, float("nan"), 7.0, float("nan")]])
    assert TS._first_argmax(x).tolist() == [1, 0, 1]


def test_code_fft_tables_match_jax():
    """The host replica spectra equal the JAX package's; the device table
    (a torch FFT of the float32 replicas) agrees with them."""
    want = JS.code_fft_table_np(SMALL.fs, SMALL.fft_len, SMALL.prns)
    np.testing.assert_array_equal(
        TS.code_fft_table_np(SMALL.fs, SMALL.fft_len, SMALL.prns), want)
    got = TS.code_fft_table(SMALL, "cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("variant", ["offline", "live"])
def test_mix_baseband_variants_match_jax(variant):
    import jax.numpy as jnp
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, 50_000).astype(np.uint8)
    lo_rate = SMALL.lo_rate * 1.37
    got = TS.mix_baseband(torch.from_numpy(bits), lo_rate, variant).numpy()
    want = np.asarray(JS.mix_baseband(jnp.asarray(bits), lo_rate, variant))
    np.testing.assert_array_equal(got, want)


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        TS.Searcher(SMALL, device="cuda")
