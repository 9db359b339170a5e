"""The port's streaming FIR / polyphase resampler against the reference's.

Every function of ``tpu_gnss_torch.signal.resample`` equals
``tpu_gnss.signal.resample`` on seeded inputs, and the property checks
of tests/test_resample.py run on the port.
"""

import numpy as np
import pytest

from tpu_gnss.signal import resample as ref
from tpu_gnss_torch.signal import resample as rs


@pytest.fixture
def rng():
    return np.random.default_rng(5)


@pytest.mark.parametrize("n_taps,cutoff,fs", [(63, 0.2, 1.0), (101, 0.1, 1.0),
                                               (31, 1.2e6, 8.184e6)])
def test_design_lowpass_equal(n_taps, cutoff, fs):
    np.testing.assert_array_equal(rs.design_lowpass(n_taps, cutoff, fs),
                                  ref.design_lowpass(n_taps, cutoff, fs))
    assert abs(rs.design_lowpass(n_taps, cutoff, fs).sum() - 1.0) < 1e-12


@pytest.mark.parametrize("dtype", ["real", "complex"])
def test_fir_stream_equal(rng, dtype):
    x = rng.standard_normal(10000)
    if dtype == "complex":
        x = x + 1j * rng.standard_normal(10000)
    taps = rs.design_lowpass(63, 0.2)
    sizes = [1000, 1, 37, 4096, 5, 861, 4000]
    edges = np.cumsum([0] + sizes)
    blocks = [x[a:b] for a, b in zip(edges[:-1], edges[1:])]
    got = np.concatenate(list(rs.fir_stream(blocks, taps)))
    want = np.concatenate(list(ref.fir_stream(blocks, taps)))
    np.testing.assert_array_equal(got, want)
    # temp_test.m:10-27: block filtering with tail carry == convolution
    np.testing.assert_allclose(got, np.convolve(x, taps)[:len(x)],
                               atol=1e-12)


@pytest.mark.parametrize("up,down", [(3, 7), (5, 4), (1023, 1091), (1, 1)])
def test_polyphase_equal(rng, up, down):
    x = rng.standard_normal(9000) + 1j * rng.standard_normal(9000)
    one, oref = rs.PolyphaseResampler(up, down), ref.PolyphaseResampler(up,
                                                                      down)
    np.testing.assert_array_equal(one.branches, oref.branches)
    np.testing.assert_array_equal(one.process(x), oref.process(x))
    # streaming, ragged blocks, against the reference's stream
    two, tref = rs.PolyphaseResampler(up, down), ref.PolyphaseResampler(up,
                                                                      down)
    cuts = [0, 1234, 5000, 5001, 9000]
    for a, b in zip(cuts[:-1], cuts[1:]):
        np.testing.assert_array_equal(two.process(x[a:b]),
                                      tref.process(x[a:b]))
    np.testing.assert_array_equal(rs.resample_rational(x, up, down),
                                  ref.resample_rational(x, up, down))


def test_polyphase_matches_bruteforce(rng):
    """tests/test_resample.py:37 on the port."""
    x = rng.standard_normal(800)
    r = rs.PolyphaseResampler(3, 7)
    got = r.process(x)
    h = r.branches[:, ::-1].T.reshape(-1)
    u = np.zeros(len(x) * 3)
    u[::3] = x
    want = np.convolve(u, h)[::7]
    n = min(len(got), len(want))
    np.testing.assert_allclose(got[:n], want[:n], atol=1e-10)


def test_polyphase_streaming_equals_oneshot(rng):
    """tests/test_resample.py:54 on the port."""
    x = rng.standard_normal(9000)
    want = rs.PolyphaseResampler(5, 4).process(x)
    two = rs.PolyphaseResampler(5, 4)
    got = np.concatenate([two.process(x[:1234]), two.process(x[1234:5000]),
                          two.process(x[5000:5001]), two.process(x[5001:])])
    n = min(len(got), len(want))
    np.testing.assert_allclose(got[:n], want[:n], atol=1e-12)
    assert abs(len(got) - len(want)) <= 1


def test_rate_conversion_tone():
    """tests/test_resample.py:66 on the port: a tone resampled 10.912 ->
    10.23 Msps keeps its frequency."""
    fs_in, up, down, f0 = 10.912e6, 1023, 1091, 0.5e6
    x = np.cos(2 * np.pi * f0 * np.arange(40000) / fs_in)
    y = rs.resample_rational(x, up, down)
    fs_out = fs_in * up / down
    spec = np.abs(np.fft.rfft(y[200:] * np.hanning(len(y) - 200)))
    f_est = np.argmax(spec) * fs_out / (len(y) - 200)
    assert abs(f_est - f0) < fs_out / (len(y) - 200) * 2


def test_remove_dc_equal(rng):
    x = (rng.standard_normal(1000) + 3.0
         + 1j * (rng.standard_normal(1000) - 2.0))
    y = rs.remove_dc(x)
    np.testing.assert_array_equal(y, ref.remove_dc(x))
    assert abs(y.real.mean()) < 1e-12 and abs(y.imag.mean()) < 1e-12
