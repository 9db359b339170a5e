# Copied from tpu_gnss/signal/rfchannel.py:1-79 (the whole module).
"""Software RF channel: the replay path without radios.

The reference closes its loop over the air — generated or captured files
are transmitted with a HackRF (gps.grc / gps_Nottingham.grc /
hackrf_transfer_script.txt), picked up by an rtl-sdr or commercial
receiver, and re-received (reference: README.md §2; SURVEY §3.5).  The
impairments that loop introduces, and that the reference explicitly
engineers around, are:

* TX/RX oscillator offset — tens of kHz at L1, the reason replayed
  captures are searched with ``max_fo=100000`` instead of 5 kHz
  (reference: README.md §2.1e);
* unknown propagation/trigger delay — shifts the code phase;
* gain scaling and receiver noise.

:func:`apply_channel` models exactly those, so the generate → transmit →
capture → re-receive loop runs as a deterministic software pipeline
(see tpu_gnss_torch.cli.playback) instead of RF hardware.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def apply_channel(iq: np.ndarray, fs: float, *,
                  freq_offset_hz: float = 0.0,
                  delay_samples: float = 0.0,
                  gain: float = 1.0,
                  phase_rad: float = 0.0,
                  noise_std: float = 0.0,
                  seed: Optional[int] = None) -> np.ndarray:
    """Impair a complex-baseband signal like a replay RF loop would.

    Args:
      iq: complex baseband samples.
      fs: sample rate (Hz).
      freq_offset_hz: carrier frequency offset (TX/RX oscillator
        mismatch); applied as ``exp(+j 2π f t)``.
      delay_samples: propagation delay, may be fractional (linear
        interpolation) and negative (advance); the vacated end is
        zero-filled so length is preserved.
      gain: amplitude scale.
      phase_rad: constant carrier phase rotation.
      noise_std: std-dev of complex AWGN added per I/Q rail.
      seed: RNG seed for the noise (deterministic loopbacks).

    Returns complex64 of the same length as ``iq``.
    """
    y = np.asarray(iq, np.complex128)
    n = len(y)
    if delay_samples:
        d_int = int(np.floor(delay_samples))
        frac = float(delay_samples - d_int)

        def shift_int(d: int) -> np.ndarray:
            out = np.zeros(n, np.complex128)
            if 0 <= d < n:
                out[d:] = y[: n - d]
            elif -n < d < 0:
                out[: n + d] = y[-d:]
            return out

        shifted = shift_int(d_int)
        if frac:
            shifted = (1.0 - frac) * shifted + frac * shift_int(d_int + 1)
        y = shifted
    if freq_offset_hz or phase_rad:
        t = np.arange(n, dtype=np.float64) / fs
        y = y * np.exp(1j * (2.0 * np.pi * freq_offset_hz * t + phase_rad))
    if gain != 1.0:
        y = gain * y
    if noise_std:
        rng = np.random.default_rng(seed)
        y = y + noise_std * (rng.standard_normal(n)
                             + 1j * rng.standard_normal(n))
    return y.astype(np.complex64)
