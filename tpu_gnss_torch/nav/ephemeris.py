# Copied from tpu_gnss/nav/ephemeris.py:1-443.
"""IS-GPS-200 ephemeris: subframe field codec + orbit/clock model.

Field extraction follows the ICD word/bit layout (the reference extracts
identical fields via byte-packing unions, c/ephemeris.cpp:36-83); the codec
here is declarative — one table drives both decode and encode, so tests and
full-receiver simulations can synthesize parity-valid NAV messages with
known ground truth (the reference has no encoder; its oracle was the sky).

Orbit/clock math is the standard ICD 20.3.3.4.3 Kepler model, float64 on
host — identical structure to the reference's EPHEM::GetXYZ /
GetClockCorrection (c/ephemeris.cpp:87-173).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..constants import (F_REL, HALF_WEEK, MU_EARTH, OMEGA_E, PI_GPS,
                         SECONDS_PER_WEEK)

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

#: Earliest full GPS week the framework assumes a capture can come from
#: (week 2048 = the April-2019 rollover).  Raw subframe-1 weeks are
#: mod-1024; resolving against this pivot lands them in 2019-2039.
MIN_FULL_WEEK = 2048


def resolve_week(week10: int, hint_week: Optional[int] = None) -> int:
    """Resolve a 10-bit (mod-1024) subframe-1 week to a full GPS week.

    The reference stores the raw field and never disambiguates
    (c/ephemeris.cpp:36-44), so its dates alias into 1980+week%1024.
    With ``hint_week`` (e.g. from the host wall clock at capture time)
    the nearest congruent week is chosen; otherwise the smallest full
    week >= :data:`MIN_FULL_WEEK`.
    """
    w = int(week10)
    if w >= 1024:
        return w                      # already a full week (synth scenes)
    if hint_week is not None:
        n = int(round((int(hint_week) - w) / 1024.0))
        return w + 1024 * max(0, n)
    return w + 1024 * ((MIN_FULL_WEEK - w + 1023) // 1024)


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

    def get_velocity(self, t: float) -> tuple[float, float, float]:
        """ECEF satellite velocity (m/s) at GPS time-of-week ``t``.

        Beyond the reference (its solver never computes velocity); feeds
        the Doppler velocity solve (pvt.solve.solve_velocity).  Uses a
        5-point central difference of :meth:`get_xyz` — for a Kepler orbit
        (|f⁽⁵⁾| ≈ r·n⁵ ≈ 2e-12 m/s⁵) the truncation error at h=1 s is
        ~1e-13 m/s and float64 rounding on a 2.7e7 m position contributes
        ~1e-8 m/s, both far below the mm/s solver noise floor.
        """
        h = 1.0
        p = np.array([self.get_xyz(t + k * h) for k in (-2, -1, 1, 2)])
        v = (p[0] - 8.0 * p[1] + 8.0 * p[2] - p[3]) / (12.0 * h)
        return float(v[0]), float(v[1]), float(v[2])

    def clock_drift(self, t: float) -> float:
        """SV clock error rate d/dt clock_correction (s/s) at time ``t``.

        Same 5-point stencil; the constant t_gd cancels and the dominant
        terms are a_f1 (~1e-11 s/s) and the relativistic rate
        (F·e·√A·cos(E_k)·Ė_k, up to ~3e-12 s/s).
        """
        h = 1.0
        c = np.array([self.clock_correction(t + k * h)
                      for k in (-2, -1, 1, 2)])
        return float((c[0] - 8.0 * c[1] + 8.0 * c[2] - c[3]) / (12.0 * h))

    # ------------------------------------------------------------------
    def leap_seconds(self, week: int, tow_s: float) -> int:
        """GPS-UTC integer offset at (full week, TOW) from the broadcast
        page-18 parameters (ICD 20.3.3.5.2.4 effectivity rule).

        Before the end of day DN of week WN_LSF the current offset
        ΔtLS applies; at/after that epoch the future offset ΔtLSF does.
        WN_LSF is an 8-bit field, resolved mod-256 to the nearest
        congruent week.  Returns 0 when no page 18 has been ingested
        (the reference never decodes these at all,
        c/ephemeris.cpp:70-83).
        """
        if not self.has_utc:
            return 0
        week = int(week)
        d = (int(self.wn_lsf) - week) % 256
        wn_lsf_full = week + (d - 256 if d > 127 else d)
        # DN in 1..7; the leap takes effect at the END of that day
        t_event = wn_lsf_full * SECONDS_PER_WEEK + int(self.dn_utc) * 86400.0
        t_now = week * SECONDS_PER_WEEK + float(tow_s)
        return int(self.delta_t_lsf if t_now >= t_event
                   else self.delta_t_ls)

    def utc_offset_s(self, week: int, tow_s: float) -> float:
        """Full GPS-UTC offset Δt_UTC = ΔtLS + A0 + A1·(t - t_ot +
        604800·(WN - WN_t)) (ICD 20.3.3.5.2.4 eq. 1).  The A0/A1 drift
        term is sub-microsecond; :meth:`leap_seconds` carries the part
        NMEA timestamps need."""
        if not self.has_utc:
            return 0.0
        week = int(week)
        d = (int(self.wn_t) - week) % 256
        wn_t_full = week + (d - 256 if d > 127 else d)
        dt = (float(tow_s) - self.t_ot
              + SECONDS_PER_WEEK * (week - wn_t_full))
        return (self.leap_seconds(week, tow_s)
                + self.a0_utc + self.a1_utc * dt)


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
    from ..constants import PREAMBLE
    from .bits import encode_word

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
    from .bits import word_parity
    src24[22] = src24[23] = 0
    p = word_parity(src24, d29, d30)
    src24[23] = p[4]           # flip d24 iff D29 would be 1
    p = word_parity(src24, d29, d30)
    src24[22] = p[5]           # flip d23 iff D30 would be 1
    p = word_parity(src24, d29, d30)
    assert p[4] == 0 and p[5] == 0
