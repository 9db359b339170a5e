"""Host layer of the generator and the reference: GPS constants, C/A
codes, the IS-GPS-200 ephemeris codec and orbit model, NAV word parity
and WGS-84 geodesy, in float64 numpy.

A frozen copy, so that nothing the benchmark measures against can change
with the program: tpu_gnss_torch/constants.py:9-37,
tpu_gnss_torch/signal/cacode.py:25-169, tpu_gnss_torch/nav/ephemeris.py:24-444
(``resolve_week`` and the UTC helpers left out),
tpu_gnss_torch/nav/bits.py:20-62 and tpu_gnss_torch/pvt/solve.py:354-362.
It imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np


# --- constants (tpu_gnss_torch/constants.py) ---
# --- Signal structure ------------------------------------------------------
L1_HZ = 1575.42e6        # L1 carrier frequency
CHIP_RATE_HZ = 1.023e6   # C/A code chip rate (CPS in the reference)
CODE_LEN_CHIPS = 1023    # chips per C/A code period
CODE_PERIOD_S = 1e-3     # one code period = 1 ms
NAV_BPS = 50.0           # NAV data bit rate
CODES_PER_BIT = 20       # C/A periods per NAV bit
NUM_SATS = 32            # GPS PRNs 1..32
SUBFRAME_BITS = 300      # bits per NAV subframe (10 words x 30 bits)
WORD_BITS = 30
DATA_BITS_PER_WORD = 24

# --- Official GPS / WGS-84 constants (reference: c/gps.h:33-43) -----------
PI_GPS = 3.1415926535898          # ICD value of pi
MU_EARTH = 3.986005e14            # WGS-84 gravitational constant for GPS user
OMEGA_E = 7.2921151467e-5         # WGS-84 earth rotation rate (rad/s)
SPEED_OF_LIGHT = 2.99792458e8
F_REL = -4.442807633e-10          # -2*sqrt(MU)/c^2 (relativistic clock term)

# --- WGS-84 ellipsoid (reference: c/solve.cpp:17-20) ----------------------
WGS84_A = 6378137.0
WGS84_F_INV = 298.257223563
WGS84_B = 6356752.31424518
WGS84_E2 = 0.00669437999014132

# --- NAV framing (reference: c/channel.cpp:75-76) -------------------------
PREAMBLE = (1, 0, 0, 0, 1, 0, 1, 1)   # 8-bit TLM preamble, upright
SECONDS_PER_WEEK = 604800
HALF_WEEK = 302400
SUBFRAME_PERIOD_S = 6.0


# --- C/A codes (tpu_gnss_torch/signal/cacode.py) ---
SATELLITES = {
    1: (63, 2, 6), 2: (56, 3, 7), 3: (37, 4, 8), 4: (35, 5, 9),
    5: (64, 1, 9), 6: (36, 2, 10), 7: (62, 1, 8), 8: (44, 2, 9),
    9: (33, 3, 10), 10: (38, 2, 3), 11: (46, 3, 4), 12: (59, 5, 6),
    13: (43, 6, 7), 14: (49, 7, 8), 15: (60, 8, 9), 16: (51, 9, 10),
    17: (57, 1, 4), 18: (50, 2, 5), 19: (54, 3, 6), 20: (47, 4, 7),
    21: (52, 5, 8), 22: (53, 6, 9), 23: (55, 1, 3), 24: (23, 4, 6),
    25: (24, 5, 7), 26: (26, 6, 8), 27: (27, 7, 9), 28: (48, 8, 10),
    29: (61, 1, 6), 30: (39, 2, 7), 31: (58, 3, 8), 32: (22, 4, 9),
}


def taps(prn: int) -> tuple[int, int]:
    """G2 phase-select tap pair for a PRN (1-based register positions)."""
    _, t1, t2 = SATELLITES[prn]
    return t1, t2


@functools.lru_cache(maxsize=1)
def _lfsr_sequences() -> tuple[np.ndarray, np.ndarray]:
    """Simulate the G1 / G2 registers for one full period.

    Returns ``(g1_out, g2_state)``:
      * ``g1_out[k]``    — G1 output (register position 10) at chip k
      * ``g2_state[k,t]`` — G2 register position t (1..10 at index t-1) at chip k

    Registers start all-ones; G1 feedback taps {3,10}; G2 feedback taps
    {2,3,6,8,9,10} (IS-GPS-200 polynomials; same recurrences as
    reference: c/cacode.h:23-28).
    """
    n = CODE_LEN_CHIPS
    g1 = np.ones(10, dtype=np.uint8)
    g2 = np.ones(10, dtype=np.uint8)
    g1_out = np.empty(n, dtype=np.uint8)
    g2_state = np.empty((n, 10), dtype=np.uint8)
    for k in range(n):
        g1_out[k] = g1[9]
        g2_state[k] = g2
        fb1 = g1[2] ^ g1[9]
        fb2 = g2[1] ^ g2[2] ^ g2[5] ^ g2[7] ^ g2[8] ^ g2[9]
        g1 = np.concatenate(([fb1], g1[:9]))
        g2 = np.concatenate(([fb2], g2[:9]))
    return g1_out, g2_state


@functools.lru_cache(maxsize=1)
def code_table() -> np.ndarray:
    """All 32 C/A codes as a ``[NUM_SATS, 1023]`` uint8 {0,1} chip table.

    Row i is PRN i+1.  Chip value convention matches the reference:
    chip = G1out ^ G2[t1] ^ G2[t2] (reference: c/cacode.h:19-21); a chip of
    1 maps to bipolar −1 (reference: c/search_offline.cpp:68-70).
    """
    g1_out, g2_state = _lfsr_sequences()
    out = np.empty((NUM_SATS, CODE_LEN_CHIPS), dtype=np.uint8)
    for prn in range(1, NUM_SATS + 1):
        t1, t2 = taps(prn)
        out[prn - 1] = g1_out ^ g2_state[:, t1 - 1] ^ g2_state[:, t2 - 1]
    return out


def bipolar(chips: np.ndarray) -> np.ndarray:
    """Map {0,1} chips to {+1,−1} floats (bit 1 -> −1)."""
    return 1.0 - 2.0 * np.asarray(chips, dtype=np.float32)


def resample(chips: np.ndarray, fs: float, n_samples: int,
             chip_rate: float = 1.023e6) -> np.ndarray:
    """Sample a {0,1} chip sequence at ``fs`` with boundary interpolation.

    Reproduces the acquisition replica construction semantics
    (reference: c/search_offline.cpp:86-103): each output sample holds the
    bipolar chip at the start of the sample period, except when a chip
    boundary falls inside the period, in which case the sample is the
    linear blend ``(1-frac)*prev + frac*next`` with ``frac`` the NCO phase
    past the boundary.  Computed with an exact integer/float64 ramp instead
    of an accumulated float32 NCO.

    Args:
      chips: ``[L]`` or ``[B, L]`` chip array ({0,1}).
      fs: sampling rate, Hz.
      n_samples: output length.
      chip_rate: chips per second.

    Returns:
      float32 bipolar replica, shape ``chips.shape[:-1] + (n_samples,)``.
    """
    chips = np.asarray(chips)
    period = chips.shape[-1]
    ca_rate = chip_rate / fs  # chips per sample
    i = np.arange(n_samples, dtype=np.float64)
    # Chip counter before sample i = boundary crossings during samples 0..i-1.
    phase_end = (i + 1.0) * ca_rate
    c_start = np.floor(i * ca_rate).astype(np.int64)
    c_end = np.floor(phase_end).astype(np.int64)
    crossed = c_end > c_start
    frac = (phase_end - c_end).astype(np.float32)

    cur = bipolar(np.take(chips, c_start % period, axis=-1))
    nxt = bipolar(np.take(chips, (c_start + 1) % period, axis=-1))
    w = np.where(crossed, frac, 0.0).astype(np.float32)
    return cur * (1.0 - w) + nxt * w


# --- NAV word parity (tpu_gnss_torch/nav/bits.py) ---
# Data-bit index sets (1-based d1..d24) feeding each parity bit D25..D30.
_PARITY_SETS = (
    (1, 2, 3, 5, 6, 10, 11, 12, 13, 14, 17, 18, 20, 23),
    (2, 3, 4, 6, 7, 11, 12, 13, 14, 15, 18, 19, 21, 24),
    (1, 3, 4, 5, 7, 8, 12, 13, 14, 15, 16, 19, 20, 22),
    (2, 4, 5, 6, 8, 9, 13, 14, 15, 16, 17, 20, 21, 23),
    (1, 3, 5, 6, 7, 9, 10, 14, 15, 16, 17, 18, 21, 22, 24),
    (3, 5, 6, 8, 9, 10, 11, 13, 15, 19, 22, 23, 24),
)
# D29*/D30* participation per parity bit: D25<-D29*, D26<-D30*, D27<-D29*,
# D28<-D30*, D29<-D30*, D30<-D29*
_CARRY = (0, 1, 0, 1, 1, 0)  # 0 -> D29*, 1 -> D30*


def word_parity(source_data: np.ndarray, d29: int, d30: int) -> np.ndarray:
    """D25..D30 for 24 SOURCE data bits (pre-inversion) and carries."""
    d = np.asarray(source_data, dtype=np.uint8)
    out = np.empty(6, dtype=np.uint8)
    carries = (d29, d30)
    for i, idxs in enumerate(_PARITY_SETS):
        out[i] = (carries[_CARRY[i]] + sum(int(d[j - 1]) for j in idxs)) & 1
    return out


def encode_word(source_data: np.ndarray, d29: int, d30: int) -> np.ndarray:
    """Transmitted 30-bit word: data XOR D30*, then computed parity."""
    d = np.asarray(source_data, dtype=np.uint8)
    tx = (d ^ d30).astype(np.uint8)
    return np.concatenate([tx, word_parity(d, d29, d30)])


def decode_word(rx_word: np.ndarray, d29: int, d30: int
                ) -> tuple[Optional[np.ndarray], int, int]:
    """Recover source data from a received 30-bit word; None if parity fails.

    Returns (source_data_24 | None, new_D29, new_D30).
    """
    rx = np.asarray(rx_word, dtype=np.uint8)
    src = (rx[:24] ^ d30).astype(np.uint8)
    want = word_parity(src, d29, d30)
    if not np.array_equal(want, rx[24:30]):
        return None, int(rx[28]), int(rx[29])
    return src, int(rx[28]), int(rx[29])




# --- ephemeris codec and orbit model (tpu_gnss_torch/nav/ephemeris.py) ---
# ---------------------------------------------------------------------------
# Field tables: name -> (subframe, [(word, msb, lsb), ...], signed, scale)
# Bit positions are ICD 1-based within each 24-bit SOURCE data word
# (parity stripped).  Multi-segment fields are listed MSB segment first.
# ---------------------------------------------------------------------------

_PI = PI_GPS

FIELDS = {
    # --- subframe 1 (reference: c/ephemeris.cpp:36-44) ---
    "week":   (1, [(3, 1, 10)], False, 1.0),
    "t_gd":   (1, [(7, 17, 24)], True, 2.0 ** -31),
    "iodc":   (1, [(8, 1, 8)], False, 1.0),   # LSB 8 bits, as the reference
    "t_oc":   (1, [(8, 9, 24)], False, 16.0),
    "a_f2":   (1, [(9, 1, 8)], True, 2.0 ** -55),
    "a_f1":   (1, [(9, 9, 24)], True, 2.0 ** -43),
    "a_f0":   (1, [(10, 1, 22)], True, 2.0 ** -31),
    # --- subframe 2 (reference: c/ephemeris.cpp:46-56) ---
    "iode2":  (2, [(3, 1, 8)], False, 1.0),
    "c_rs":   (2, [(3, 9, 24)], True, 2.0 ** -5),
    "dn":     (2, [(4, 1, 16)], True, 2.0 ** -43 * _PI),
    "m_0":    (2, [(4, 17, 24), (5, 1, 24)], True, 2.0 ** -31 * _PI),
    "c_uc":   (2, [(6, 1, 16)], True, 2.0 ** -29),
    "e":      (2, [(6, 17, 24), (7, 1, 24)], False, 2.0 ** -33),
    "c_us":   (2, [(8, 1, 16)], True, 2.0 ** -29),
    "sqrt_a": (2, [(8, 17, 24), (9, 1, 24)], False, 2.0 ** -19),
    "t_oe":   (2, [(10, 1, 16)], False, 16.0),
    # --- subframe 3 (reference: c/ephemeris.cpp:58-68) ---
    "c_ic":      (3, [(3, 1, 16)], True, 2.0 ** -29),
    "omega_0":   (3, [(3, 17, 24), (4, 1, 24)], True, 2.0 ** -31 * _PI),
    "c_is":      (3, [(5, 1, 16)], True, 2.0 ** -29),
    "i_0":       (3, [(5, 17, 24), (6, 1, 24)], True, 2.0 ** -31 * _PI),
    "c_rc":      (3, [(7, 1, 16)], True, 2.0 ** -5),
    "omega":     (3, [(7, 17, 24), (8, 1, 24)], True, 2.0 ** -31 * _PI),
    "omega_dot": (3, [(9, 1, 24)], True, 2.0 ** -43 * _PI),
    "iode3":     (3, [(10, 1, 8)], False, 1.0),
    "idot":      (3, [(10, 9, 22)], True, 2.0 ** -43 * _PI),
}

# Subframe 4 page 18 ionosphere (parsed, reference: c/ephemeris.cpp:70-79)
IONO_FIELDS = {
    "alpha0": (4, [(3, 9, 16)], True, 2.0 ** -30),
    "alpha1": (4, [(3, 17, 24)], True, 2.0 ** -27),
    "alpha2": (4, [(4, 1, 8)], True, 2.0 ** -24),
    "alpha3": (4, [(4, 9, 16)], True, 2.0 ** -24),
    "beta0":  (4, [(4, 17, 24)], True, 2.0 ** 11),
    "beta1":  (4, [(5, 1, 8)], True, 2.0 ** 14),
    "beta2":  (4, [(5, 9, 16)], True, 2.0 ** 16),
    "beta3":  (4, [(5, 17, 24)], True, 2.0 ** 16),
}

# Subframe 4 page 18, second half: broadcast UTC parameters
# (ICD 20.3.3.5.1.6 / Table 20-IX).  The reference stops at beta
# (c/ephemeris.cpp:70-83) and never learns GPS-UTC leap seconds; decoding
# these lets NMEA timestamps carry true UTC on real sky data.
UTC_FIELDS = {
    "a1_utc":      (4, [(6, 1, 24)], True, 2.0 ** -50),            # s/s
    "a0_utc":      (4, [(7, 1, 24), (8, 1, 8)], True, 2.0 ** -30),  # s
    "t_ot":        (4, [(8, 9, 16)], False, 2.0 ** 12),             # s
    "wn_t":        (4, [(8, 17, 24)], False, 1.0),                  # weeks
    "delta_t_ls":  (4, [(9, 1, 8)], True, 1.0),                     # s
    "wn_lsf":      (4, [(9, 9, 16)], False, 1.0),                   # weeks
    "dn_utc":      (4, [(9, 17, 24)], False, 1.0),                  # days 1-7
    "delta_t_lsf": (4, [(10, 1, 8)], True, 1.0),                    # s
}

def _get_bits(data240: np.ndarray, segs) -> int:
    """Extract a (possibly multi-word) raw unsigned value."""
    v = 0
    for word, msb, lsb in segs:
        for b in range(msb, lsb + 1):
            v = (v << 1) | int(data240[(word - 1) * 24 + (b - 1)])
    return v


def _set_bits(data240: np.ndarray, segs, value: int) -> None:
    nbits = sum(lsb - msb + 1 for _, msb, lsb in segs)
    for word, msb, lsb in segs:
        for b in range(msb, lsb + 1):
            nbits -= 1
            data240[(word - 1) * 24 + (b - 1)] = (value >> nbits) & 1


def _twos(v: int, nbits: int) -> int:
    return v - (1 << nbits) if v & (1 << (nbits - 1)) else v


def decode_field(data240: np.ndarray, name: str, table=FIELDS) -> float:
    _, segs, signed, scale = table[name]
    nbits = sum(lsb - msb + 1 for _, msb, lsb in segs)
    raw = _get_bits(data240, segs)
    if signed:
        raw = _twos(raw, nbits)
    return raw * scale


def subframe_id(data240: np.ndarray) -> int:
    """HOW subframe ID: word 2 source bits 20-22."""
    return _get_bits(data240, [(2, 20, 22)])


def tow_count(data240: np.ndarray) -> int:
    """HOW TOW count (17 bits): time of NEXT subframe start / 6 s."""
    return _get_bits(data240, [(2, 1, 17)])


def time_from_epoch(t: float, t_ref: float) -> float:
    """Week-rollover-safe time difference (reference: c/ephemeris.cpp:16-21)."""
    t = t - t_ref
    if t > HALF_WEEK:
        t -= SECONDS_PER_WEEK
    elif t < -HALF_WEEK:
        t += SECONDS_PER_WEEK
    return t


@dataclasses.dataclass
class Ephemeris:
    """Decoded per-SV ephemeris (field names as in FIELDS)."""
    week: float = 0.0
    t_gd: float = 0.0
    iodc: float = 0.0
    t_oc: float = 0.0
    a_f2: float = 0.0
    a_f1: float = 0.0
    a_f0: float = 0.0
    iode2: float = -1.0
    c_rs: float = 0.0
    dn: float = 0.0
    m_0: float = 0.0
    c_uc: float = 0.0
    e: float = 0.0
    c_us: float = 0.0
    sqrt_a: float = 0.0
    t_oe: float = 0.0
    c_ic: float = 0.0
    omega_0: float = 0.0
    c_is: float = 0.0
    i_0: float = 0.0
    c_rc: float = 0.0
    omega: float = 0.0
    omega_dot: float = 0.0
    iode3: float = -2.0
    idot: float = 0.0
    tow: int = 0
    alpha: tuple = (0.0, 0.0, 0.0, 0.0)
    beta: tuple = (0.0, 0.0, 0.0, 0.0)
    # broadcast UTC parameters (page 18 second half; UTC_FIELDS)
    a0_utc: float = 0.0
    a1_utc: float = 0.0
    t_ot: float = 0.0
    wn_t: float = 0.0
    delta_t_ls: float = 0.0
    wn_lsf: float = 0.0
    dn_utc: float = 0.0
    delta_t_lsf: float = 0.0
    has_utc: bool = False

    # ------------------------------------------------------------------
    def valid(self) -> bool:
        """Consistent issue-of-data across subframes 1..3
        (reference: c/ephemeris.cpp:177-179)."""
        return (self.iodc != 0 and self.iodc == self.iode2
                and self.iodc == self.iode3)

    def ingest(self, data240: np.ndarray) -> int:
        """Apply one parity-valid subframe's fields.  Returns subframe id."""
        sid = subframe_id(data240)
        self.tow = tow_count(data240)
        if sid in (1, 2, 3):
            for name, (sf, *_rest) in FIELDS.items():
                if sf == sid:
                    setattr(self, name, decode_field(data240, name))
        elif sid == 4:
            # page 18 carries the ionosphere model: data ID/page check —
            # sv-id field (word 3 bits 3-8) == 56 (0x38) for page 18;
            # reference checks source byte 0x78 = dataid 01 + svid 111000
            # (c/ephemeris.cpp:81-83)
            svid = _get_bits(data240, [(3, 3, 8)])
            if svid == 56:
                self.alpha = tuple(
                    decode_field(data240, f"alpha{i}", IONO_FIELDS)
                    for i in range(4))
                self.beta = tuple(
                    decode_field(data240, f"beta{i}", IONO_FIELDS)
                    for i in range(4))
                for name in UTC_FIELDS:
                    setattr(self, name,
                            decode_field(data240, name, UTC_FIELDS))
                self.has_utc = True
        return sid

    # ------------------------------------------------------------------
    def eccentric_anomaly(self, t_k: float) -> float:
        """Kepler solve by fixed-point iteration to 1e-10
        (reference: c/ephemeris.cpp:87-110).

        Bounded iterations: an invalid ephemeris (sqrt_a = 0 before
        subframe 2, or NaN time) makes the iterate NaN, for which the
        convergence test is never true — raise instead of hanging.
        """
        a = self.sqrt_a * self.sqrt_a
        if not (a > 0.0 and np.isfinite(t_k)):
            raise ValueError(
                f"Kepler solve on invalid ephemeris (sqrt_a={self.sqrt_a}, "
                f"t_k={t_k}); valid()={self.valid()}")
        n = np.sqrt(MU_EARTH / (a * a * a)) + self.dn
        m_k = self.m_0 + n * t_k
        e_k = m_k
        for _ in range(50):  # GPS e < 0.03 converges in < 10
            prev = e_k
            e_k = m_k + self.e * np.sin(e_k)
            if abs(e_k - prev) < 1e-10:
                return e_k
        raise ValueError(
            f"Kepler iteration did not converge (sqrt_a={self.sqrt_a}, "
            f"e={self.e}, t_k={t_k}); ephemeris valid()={self.valid()}")

    def get_xyz(self, t: float) -> tuple[float, float, float]:
        """ECEF satellite position at GPS time-of-week ``t``
        (ICD 20.3.3.4.3; reference: c/ephemeris.cpp:114-151)."""
        t_k = time_from_epoch(t, self.t_oe)
        e_k = self.eccentric_anomaly(t_k)
        v_k = np.arctan2(np.sqrt(1.0 - self.e ** 2) * np.sin(e_k),
                         np.cos(e_k) - self.e)
        aol = v_k + self.omega
        du = self.c_us * np.sin(2 * aol) + self.c_uc * np.cos(2 * aol)
        dr = self.c_rs * np.sin(2 * aol) + self.c_rc * np.cos(2 * aol)
        di = self.c_is * np.sin(2 * aol) + self.c_ic * np.cos(2 * aol)
        u_k = aol + du
        a = self.sqrt_a ** 2
        r_k = a * (1.0 - self.e * np.cos(e_k)) + dr
        i_k = self.i_0 + di + self.idot * t_k
        x_p = r_k * np.cos(u_k)
        y_p = r_k * np.sin(u_k)
        omega_k = (self.omega_0 + (self.omega_dot - OMEGA_E) * t_k
                   - OMEGA_E * self.t_oe)
        x = x_p * np.cos(omega_k) - y_p * np.cos(i_k) * np.sin(omega_k)
        y = x_p * np.sin(omega_k) + y_p * np.cos(i_k) * np.cos(omega_k)
        z = y_p * np.sin(i_k)
        return float(x), float(y), float(z)

    def clock_correction(self, t: float) -> float:
        """SV clock error at time-of-week ``t`` (ICD 20.3.3.3.3.1;
        reference: c/ephemeris.cpp:155-173)."""
        t_k = time_from_epoch(t, self.t_oe)
        e_k = self.eccentric_anomaly(t_k)
        t_r = F_REL * self.e * self.sqrt_a * np.sin(e_k)
        dt = time_from_epoch(t, self.t_oc)
        return (self.a_f0 + self.a_f1 * dt + self.a_f2 * dt * dt
                + t_r - self.t_gd)

# ---------------------------------------------------------------------------
# Encoder (test-fixture factory: the reference has no equivalent)
# ---------------------------------------------------------------------------

def encode_subframes(eph: Ephemeris, tow_start: int,
                     sids=(1, 2, 3)) -> list[np.ndarray]:
    """Encode subframes as transmitted 300-bit words with valid parity.

    ``tow_start``: TOW count placed in the first subframe's HOW (the count
    names the NEXT subframe boundary; successive subframes increment it).
    ``sids``: subframe ids in transmission order (4/5 encode as almanac
    placeholders with zero payload).  Returns {0,1} arrays of 300 bits,
    parity carries chained across subframes starting from D29*=D30*=0.
    """
    frames = []
    d29 = d30 = 0
    for k, sid in enumerate(sids):
        data = np.zeros(240, dtype=np.uint8)
        # word 1: TLM — preamble + zeros
        data[0:8] = PREAMBLE
        # word 2: HOW — TOW (17b), flags 0, subframe id
        _set_bits(data, [(2, 1, 17)], tow_start + k)
        _set_bits(data, [(2, 20, 22)], sid)

        def put(name, value, table):
            _, segs, signed, scale = table[name]
            raw = int(round(value / scale))
            nbits = sum(lsb - msb + 1 for _, msb, lsb in segs)
            if signed and raw < 0:
                raw += 1 << nbits
            assert 0 <= raw < (1 << nbits), f"{name} out of range"
            _set_bits(data, segs, raw)

        for name, (sf, *_rest) in FIELDS.items():
            if sf == sid:
                put(name, getattr(eph, name), FIELDS)
        if sid == 4:
            # page 18: data ID 01 + sv-id 56 marks the ionosphere page
            _set_bits(data, [(3, 1, 2)], 1)
            _set_bits(data, [(3, 3, 8)], 56)
            for i in range(4):
                put(f"alpha{i}", eph.alpha[i], IONO_FIELDS)
                put(f"beta{i}", eph.beta[i], IONO_FIELDS)
            for name in UTC_FIELDS:   # second half: broadcast UTC
                put(name, getattr(eph, name), UTC_FIELDS)
        # Words 2 and 10 end with D29=D30=0 per ICD, solved via the two
        # reserved t-bits (d23,d24) — this is what lets every subframe be
        # parity-seeded fresh from the preamble polarity.
        tx = np.empty(300, dtype=np.uint8)
        for w in range(10):
            src = data[w * 24:(w + 1) * 24]
            if w in (1, 9):
                _solve_tbits(src, d29, d30)
            word = encode_word(src, d29, d30)
            tx[w * 30:(w + 1) * 30] = word
            d29, d30 = int(word[28]), int(word[29])
        assert (d29, d30) == (0, 0)
        frames.append(tx)
    return frames


def _solve_tbits(src24: np.ndarray, d29: int, d30: int) -> None:
    """Choose d23/d24 so the word's computed D29 = D30 = 0 (in place).

    D29's parity set contains d24 but not d23; D30's contains both — so
    solve d24 from D29 first, then d23 from D30.
    """
    src24[22] = src24[23] = 0
    p = word_parity(src24, d29, d30)
    src24[23] = p[4]           # flip d24 iff D29 would be 1
    p = word_parity(src24, d29, d30)
    src24[22] = p[5]           # flip d23 iff D30 would be 1
    p = word_parity(src24, d29, d30)
    assert p[4] == 0 and p[5] == 0


def geodetic_to_ecef(lat_deg: float, lon_deg: float, alt_m: float
                     ) -> tuple[float, float, float]:
    """WGS-84 geodetic -> ECEF (tpu_gnss_torch/pvt/solve.py:354-362)."""
    lat, lon = np.radians(lat_deg), np.radians(lon_deg)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * np.sin(lat) ** 2)
    x = (n + alt_m) * np.cos(lat) * np.cos(lon)
    y = (n + alt_m) * np.cos(lat) * np.sin(lon)
    z = (n * (1.0 - WGS84_E2) + alt_m) * np.sin(lat)
    return float(x), float(y), float(z)
