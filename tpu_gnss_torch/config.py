# Copied from tpu_gnss/config.py:1-107.
"""Receiver configuration.

The reference scatters its tunables across compile-time ``#define``s
(reference: c/gps.h:15-26), three argv-set runtime globals
(reference: c/test_search_offline.cpp:31-38) and per-capture hardcoded
MATLAB parameters.  Here they live in one frozen dataclass with the
reference's named capture presets.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from . import constants as C


@dataclasses.dataclass(frozen=True)
class ReceiverConfig:
    """Static configuration for one capture / receiver instance.

    Frozen + hashable so it can be a `jax.jit` static argument.
    """

    fs: float = 10e6            # sampling rate (FS)
    fc: float = 2.6e6           # IF carrier (FC)
    max_fo: float = 5000.0      # max Doppler searched, Hz
    fft_len: int = 40000        # acquisition window, samples
    snr_threshold: float = 25.0 # detection threshold (peak/avg power)
    num_chans: int = 12         # tracking channel bank size
    prns: Tuple[int, ...] = tuple(range(1, C.NUM_SATS + 1))

    # ------------------------------------------------------------------
    # Derived quantities (semantics of reference: c/search_offline.cpp)
    # ------------------------------------------------------------------
    @property
    def lags(self) -> int:
        """Number of code-phase lags scored: one code period of samples.

        Reference: c/search_offline.cpp:190 (``i < FS/1000`` with int i).
        """
        return int(self.fs / 1000)

    @property
    def dop_max_bin(self) -> int:
        """Largest Doppler FFT-bin shift searched (inclusive).

        Reference: c/search_offline.cpp:176 — ``int dop`` initialised from a
        double, i.e. truncation toward zero.
        """
        return int(self.max_fo * self.fft_len / self.fs)

    @property
    def num_dop_bins(self) -> int:
        return 2 * self.dop_max_bin + 1

    @property
    def dop_bin_hz(self) -> float:
        return self.fs / self.fft_len

    @property
    def samples_per_ms(self) -> int:
        return int(round(self.fs * 1e-3))

    @property
    def ca_rate(self) -> float:
        """Code NCO rate in chips per sample."""
        return C.CHIP_RATE_HZ / self.fs

    @property
    def lo_rate(self) -> float:
        """Quadrature square-wave LO rate in quarter-cycles per sample.

        Reference: c/search_offline.cpp:127 (``lo_rate = 4*FC/FS``).
        """
        return 4.0 * self.fc / self.fs


# ---------------------------------------------------------------------------
# Named presets for the reference's capture formats
# ---------------------------------------------------------------------------

#: Live rig: 10 Msps, 2.6 MHz 2nd IF (reference: c/gps.h:23-24)
LIVE = ReceiverConfig(fs=10e6, fc=2.6e6, max_fo=5000.0)

#: Nottingham capture gps.samples.1bit.I.fs5456.if4092.bin
#: (reference: c/test_search_offline.cpp:20-22)
NOTTINGHAM = ReceiverConfig(fs=5.456e6, fc=4.092e6, max_fo=5000.0)

#: Synthetic gps_sig_gen.m signal: fs = 8*1.023 MHz, IF = fs/4
#: (reference: gps_sig_gen.m:8-14,34; README §1.1)
SYNTHETIC = ReceiverConfig(fs=8.184e6, fc=2.046e6, max_fo=5000.0)

#: rtl-sdr replay capture, wide Doppler for TX/RX oscillator offset
#: (reference: proc_rtl_bin_for_gps.m:10-53; README §2.1e,2.2)
RTLSDR_REPLAY = ReceiverConfig(fs=2.8e6, fc=0.62e6, max_fo=100000.0)

#: HackRF replay capture (reference: proc_hackrf_bin_for_gps.m:15-16)
HACKRF_REPLAY = ReceiverConfig(fs=10e6, fc=2.6e6, max_fo=100000.0)

PRESETS = {
    "live": LIVE,
    "nottingham": NOTTINGHAM,
    "synthetic": SYNTHETIC,
    "rtlsdr": RTLSDR_REPLAY,
    "hackrf": HACKRF_REPLAY,
}
