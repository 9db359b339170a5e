"""The port's software RF channel against the reference's.

``tpu_gnss_torch.signal.rfchannel.apply_channel`` on seeded inputs must
equal ``tpu_gnss.signal.rfchannel.apply_channel`` bit for bit, across
the frequency offset, integer, fractional and negative delays, gain,
phase and seeded noise; the exactness cases of
tests/test_playback.py:32 run on the port.
"""

import numpy as np
import pytest

from tpu_gnss.signal import rfchannel as ref
from tpu_gnss_torch.signal import rfchannel


@pytest.mark.parametrize("kw", [
    dict(),
    dict(freq_offset_hz=60e3),
    dict(delay_samples=777.0),
    dict(delay_samples=12.25),
    dict(delay_samples=-5.5),
    dict(delay_samples=-3.0, gain=0.4),
    dict(freq_offset_hz=-2500.0, phase_rad=0.5, gain=1.3),
    dict(noise_std=0.3, seed=11),
    dict(freq_offset_hz=8e3, delay_samples=1234.0, noise_std=0.3, seed=0),
    dict(delay_samples=5000.0),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "none")
def test_apply_channel_equal(kw):
    rng = np.random.default_rng(3)
    iq = (rng.standard_normal(4096)
          + 1j * rng.standard_normal(4096)).astype(np.complex64)
    got = rfchannel.apply_channel(iq, 2.048e6, **kw)
    want = ref.apply_channel(iq, 2.048e6, **kw)
    assert got.dtype == np.complex64 and got.shape == iq.shape
    np.testing.assert_array_equal(got, want)


def test_apply_channel_offsets_are_exact():
    """tests/test_playback.py:32 on the port."""
    fs = 1e6
    t = np.arange(4096) / fs
    tone = np.exp(2j * np.pi * 1000.0 * t).astype(np.complex64)
    out = rfchannel.apply_channel(tone, fs, freq_offset_hz=2500.0,
                                  gain=2.0, phase_rad=0.5)
    want = 2.0 * np.exp(1j * (2 * np.pi * 3500.0 * t + 0.5))
    assert np.allclose(out, want, atol=1e-3)
    d = rfchannel.apply_channel(tone, fs, delay_samples=7)
    assert np.allclose(d[7:], tone[:-7], atol=1e-6)
    assert np.all(d[:7] == 0)
    h = rfchannel.apply_channel(tone, fs, delay_samples=2.5)
    assert np.allclose(h[3:], 0.5 * (tone[:-3] + tone[1:-2]), atol=1e-5)
