# Copied from tpu_gnss/signal/synth.py:1-196.
"""GPS L1 C/A signal synthesis — test-fixture factory.

Covers the reference's MATLAB signal generator (gps_sig_gen.m): C/A code
oversampling, NAV-bit modulation, raised-cosine pulse shaping, IF up-mix and
1-bit hard limiting — plus a more general multi-SV baseband generator with
per-SV Doppler / code-phase / power ground truth for tracking, NAV and PVT
tests (the reference has no equivalent; its oracle is replay hardware).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from ..constants import CHIP_RATE_HZ, CODE_LEN_CHIPS, CODES_PER_BIT, L1_HZ
from . import cacode


def raised_cosine_fir(oversample: int, rolloff: float = 0.5,
                      delay_chips: int = 3) -> np.ndarray:
    """Raised-cosine interpolation FIR (MATLAB ``rcosine(1, N)`` defaults).

    Reference usage: gps_sig_gen.m:23 — rolloff 0.5, 3-symbol delay, 'normal'
    (full raised cosine, not root).  Peak-normalized like MATLAB's.
    """
    t = np.arange(-delay_chips * oversample, delay_chips * oversample + 1,
                  dtype=np.float64) / oversample
    h = np.sinc(t) * np.cos(np.pi * rolloff * t)
    if rolloff == 0.0:
        return h  # pure sinc: den = 1 everywhere, no singularity
    den = 1.0 - (2.0 * rolloff * t) ** 2
    # L'Hopital at the rolloff singularity |t| = 1/(2R)
    sing = np.isclose(den, 0.0)
    h = np.where(sing, np.pi / 4 * np.sinc(1.0 / (2 * rolloff)), h / np.where(sing, 1.0, den))
    return h


def nav_bit_stream(num_bits: int, rng: np.random.Generator) -> np.ndarray:
    """Random ±1 NAV bits (gps_sig_gen.m:19)."""
    return 1.0 - 2.0 * rng.integers(0, 2, size=num_bits).astype(np.float64)


def synth_1bit_if(prn: int = 8, oversample: int = 8, num_bits: int = 100,
                  seed: int = 0, nav_bits: Optional[np.ndarray] = None
                  ) -> tuple[np.ndarray, dict]:
    """Reproduce gps_sig_gen.m's 1-bit IF test signal.

    PRN ``prn`` C/A code at ``oversample`` samples/chip
    (fs = oversample * 1.023 MHz), 20 code periods per NAV bit,
    zero-insertion upsampling + raised-cosine interpolation, real up-mix to
    IF = fs/4, then 1-bit hard limit with bit 1 = negative sample
    (gps_sig_gen.m:8-41).

    Returns ``(bits {0,1} uint8, meta)`` with meta carrying fs, fc, the NAV
    bits used, and the pulse-shaping group delay in samples.
    """
    fs = oversample * CHIP_RATE_HZ
    fc = fs / 4.0
    rng = np.random.default_rng(seed)
    if nav_bits is None:
        nav_bits = nav_bit_stream(num_bits, rng)

    chips = 1.0 - 2.0 * cacode.code_table()[prn - 1].astype(np.float64)
    # Zero-insertion upsample (MATLAB upsample()) then one NAV bit = 20 periods
    g = np.zeros(CODE_LEN_CHIPS * oversample)
    g[::oversample] = chips
    g = np.tile(g, CODES_PER_BIT)
    data = np.repeat(nav_bits, len(g)) * np.tile(g, len(nav_bits))

    h = raised_cosine_fir(oversample)
    shaped = np.convolve(data, h)  # 'full', like MATLAB conv (gps_sig_gen.m:35)

    n = np.arange(len(shaped), dtype=np.float64)
    y = np.real(shaped * np.exp(2j * np.pi * fc * n / fs))
    bits = (1.0 - np.sign(y)) / 2.0  # gps_sig_gen.m:37
    meta = dict(fs=fs, fc=fc, prn=prn, nav_bits=nav_bits,
                group_delay=(len(h) - 1) // 2,
                samples_per_code=CODE_LEN_CHIPS * oversample)
    return bits.astype(np.uint8), meta


# ---------------------------------------------------------------------------
# General multi-SV baseband synthesis (tracking / NAV / PVT ground truth)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SvSignal:
    """Ground-truth parameters for one synthesized SV."""
    prn: int
    doppler_hz: float = 0.0          # carrier Doppler at L1
    code_phase_chips: float = 0.0    # code phase at sample 0 (chips into code)
    carrier_phase_cycles: float = 0.0
    amplitude: float = 1.0
    nav_bits: Optional[np.ndarray] = None   # ±1, used at 50 bps
    nav_ms_offset: int = 0           # ms into the 20-ms bit at sample 0


def synth_baseband(svs: Sequence[SvSignal], fs: float, n_samples: int,
                   noise_std: float = 0.0, seed: int = 0) -> np.ndarray:
    """Complex-baseband sum of C/A signals with exact ground truth.

    Each SV contributes ``A * d(t) * c(t) * exp(j 2π (f_d t + φ0))`` where the
    code rate is Doppler-scaled by (1 + f_d/L1) — the same carrier/code
    coherence the reference's channel seeding assumes
    (reference: c/channel.cpp:144-145).
    """
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples, dtype=np.float64) / fs
    out = np.zeros(n_samples, dtype=np.complex128)
    table = cacode.code_table()
    for sv in svs:
        chips_bip = 1.0 - 2.0 * table[sv.prn - 1].astype(np.float64)
        code_rate = CHIP_RATE_HZ * (1.0 + sv.doppler_hz / L1_HZ)
        code_phase = sv.code_phase_chips + code_rate * t
        chip_idx = np.floor(code_phase).astype(np.int64)
        code = chips_bip[chip_idx % CODE_LEN_CHIPS]
        if sv.nav_bits is not None:
            # ms counter from elapsed code periods
            period_idx = chip_idx // CODE_LEN_CHIPS
            ms = period_idx + sv.nav_ms_offset
            bit_idx = np.clip(ms // CODES_PER_BIT, 0, len(sv.nav_bits) - 1)
            data = np.asarray(sv.nav_bits, dtype=np.float64)[bit_idx]
        else:
            data = 1.0
        carrier = np.exp(2j * np.pi * (sv.doppler_hz * t + sv.carrier_phase_cycles))
        out += sv.amplitude * data * code * carrier
    if noise_std > 0:
        out += noise_std * (rng.standard_normal(n_samples)
                            + 1j * rng.standard_normal(n_samples)) / np.sqrt(2.0)
    return out.astype(np.complex64)


def synth_from_sv_time(prn: int, t_sv: np.ndarray, nav_stream: np.ndarray,
                       t_stream_origin: float, fs: float,
                       amplitude: float = 1.0,
                       carrier_l1: float = L1_HZ,
                       t_rx: np.ndarray = None,
                       t_rx_ref: float = None,
                       t_sv_ref: float = None) -> np.ndarray:
    """Synthesize one SV's complex baseband from its SV-clock timeline.

    The fully-consistent generator for end-to-end receiver tests: given
    the transmit (SV-clock) time ``t_sv[n]`` observed at each receiver
    sample, the C/A code phase, NAV bit index and carrier phase are all
    derived from the same timeline, so code-locked transmit-time
    reconstruction and PVT close exactly.

    Args:
      t_sv: ``[n]`` float64 SV-clock seconds-of-week at each sample.
      nav_stream: {0,1} NAV bits; bit b spans
        ``t_stream_origin + [b, b+1) * 20 ms`` of SV time.
      t_stream_origin: SV time of nav_stream bit 0 (a subframe boundary).
      carrier_l1: carrier frequency used for the Doppler-consistent
        baseband phase ``exp(-j 2π L1 (t - t_sv))``.
      t_rx / t_rx_ref / t_sv_ref: segmented synthesis support — pass the
        segment's receiver-time axis and the GLOBAL phase references
        (stream-start t_rx and t_sv) so per-segment calls are
        bit-identical to one whole-stream call (bounded-memory scene
        generation for long soaks).  Defaults reproduce the
        whole-stream behavior (refs = first sample).
    """
    n = len(t_sv)
    if t_rx is None:
        t_rx = np.arange(n, dtype=np.float64) / fs
    if t_rx_ref is None:
        t_rx_ref = t_rx[0]
    if t_sv_ref is None:
        t_sv_ref = t_sv[0]
    rel = t_sv - t_stream_origin
    chips_abs = rel * CHIP_RATE_HZ
    chip_idx = np.floor(chips_abs).astype(np.int64)
    code = 1.0 - 2.0 * cacode.code_table()[prn - 1][chip_idx % CODE_LEN_CHIPS
                                                    ].astype(np.float64)
    bit_idx = np.clip((rel * 50.0).astype(np.int64), 0, len(nav_stream) - 1)
    data = 1.0 - 2.0 * np.asarray(nav_stream, np.float64)[bit_idx]
    # carrier: phase advances with the propagation delay (t - t_sv);
    # mod 1 keeps float64 fractional precision at L1 scale
    cycles = -carrier_l1 * (t_rx - (t_sv - t_sv_ref) - t_rx_ref)
    cycles = cycles - np.floor(cycles)
    carrier = np.exp(2j * np.pi * cycles)
    return (amplitude * data * code * carrier).astype(np.complex64)


def baseband_to_1bit_if(iq: np.ndarray, fc: float, fs: float,
                        n0: int = 0) -> np.ndarray:
    """Up-mix complex baseband to a real IF and hard-limit to {0,1} bits.

    ``n0``: global sample index of ``iq[0]`` — lets long captures be
    converted in bounded-memory segments, bit-identical to one whole
    call (the mix phase is an elementwise function of absolute index).
    """
    n = np.arange(n0, n0 + len(iq), dtype=np.float64)
    y = np.real(iq.astype(np.complex128) * np.exp(2j * np.pi * fc * n / fs))
    return (y < 0).astype(np.uint8)
