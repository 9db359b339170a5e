# Copied from tpu_gnss/nav/almanac.py:1-241.
"""Subframe 4/5 almanac: page codec, reduced orbit model, visibility.

The reference decodes subframes 1-3 (ephemeris) and parses the subframe-4
page-18 ionosphere, but discards the almanac pages entirely
(c/ephemeris.cpp:183-207 dispatches only ids 1-3 plus the iono page).
Real receivers keep the almanac because it is what makes *warm starts*
fast: a days-old almanac plus a rough position and time predicts which
PRNs are above the horizon, so a cold search only has to sweep the
visible third of the constellation.

This module supplies that layer: the ICD almanac page codec (Table
20-VI: 24 SV pages across subframes 4 and 5), the reduced-precision
Kepler orbit (ICD 20.3.3.5.2 — no harmonic corrections, fixed
inclination about 54 deg), elevation-based visibility prediction, and an
encoder so synthetic scenes can broadcast parity-valid almanac pages
with known truth.  Receiver integration: `Receiver` collects pages from
any tracking channel and `visible_prns` directs the next session's cold
search (see receiver.py / utils/checkpoint.py).

Host-side numpy, like the rest of the 50 bps NAV layer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..constants import MU_EARTH, OMEGA_E, PI_GPS
from .ephemeris import (_get_bits, _set_bits, _solve_tbits, _twos,
                        subframe_id, time_from_epoch)

# ICD Table 20-VI field layout within the 24-bit SOURCE words of an
# almanac page: name -> ([(word, msb, lsb), ...], signed, scale).
# Angles are broadcast in semicircles; scales below fold in PI_GPS so
# decoded values are radians (same convention as ephemeris.FIELDS).
ALM_FIELDS = {
    "e":         ([(3, 9, 24)], False, 2.0 ** -21),
    "t_oa":      ([(4, 1, 8)], False, 2.0 ** 12),
    "delta_i":   ([(4, 9, 24)], True, 2.0 ** -19 * PI_GPS),
    "omega_dot": ([(5, 1, 16)], True, 2.0 ** -38 * PI_GPS),
    "health":    ([(5, 17, 24)], False, 1.0),
    "sqrt_a":    ([(6, 1, 24)], False, 2.0 ** -11),
    "omega_0":   ([(7, 1, 24)], True, 2.0 ** -23 * PI_GPS),
    "omega":     ([(8, 1, 24)], True, 2.0 ** -23 * PI_GPS),
    "m_0":       ([(9, 1, 24)], True, 2.0 ** -23 * PI_GPS),
    # a_f0 is 11 bits split around a_f1 (8 MSBs + 3 LSBs)
    "a_f0":      ([(10, 1, 8), (10, 20, 22)], True, 2.0 ** -20),
    "a_f1":      ([(10, 9, 19)], True, 2.0 ** -38),
}

# Reference inclination: almanac broadcasts delta_i relative to
# 0.30 semicircles (ICD 20.3.3.5.2.1).
I_REF = 0.30 * PI_GPS


def _wrap_pi(x: float) -> float:
    """Wrap an angle to [-pi, pi) (the broadcast semicircle range)."""
    return float((x + np.pi) % (2.0 * np.pi) - np.pi)


@dataclasses.dataclass
class Almanac:
    """Reduced-precision per-SV orbit + clock (one subframe 4/5 page)."""
    prn: int = 0
    e: float = 0.0
    t_oa: float = 0.0
    delta_i: float = 0.0
    omega_dot: float = 0.0
    health: float = 0.0
    sqrt_a: float = 0.0
    omega_0: float = 0.0
    omega: float = 0.0
    m_0: float = 0.0
    a_f0: float = 0.0
    a_f1: float = 0.0

    def valid(self) -> bool:
        return self.prn >= 1 and self.sqrt_a > 0.0 and self.health == 0.0

    def get_xyz(self, t: float) -> tuple[float, float, float]:
        """ECEF position at GPS time-of-week ``t`` (ICD 20.3.3.5.2.1:
        the ephemeris Kepler model minus harmonic/rate corrections)."""
        a = self.sqrt_a * self.sqrt_a
        t_k = time_from_epoch(t, self.t_oa)
        n0 = np.sqrt(MU_EARTH / (a * a * a))
        m_k = self.m_0 + n0 * t_k
        e_k = m_k
        for _ in range(30):  # e < 0.03: converges in a few iterations
            e_k = m_k + self.e * np.sin(e_k)
        v_k = np.arctan2(np.sqrt(1.0 - self.e ** 2) * np.sin(e_k),
                         np.cos(e_k) - self.e)
        u_k = v_k + self.omega
        r_k = a * (1.0 - self.e * np.cos(e_k))
        i_k = I_REF + self.delta_i
        x_p, y_p = r_k * np.cos(u_k), r_k * np.sin(u_k)
        omega_k = (self.omega_0 + (self.omega_dot - OMEGA_E) * t_k
                   - OMEGA_E * self.t_oa)
        x = x_p * np.cos(omega_k) - y_p * np.cos(i_k) * np.sin(omega_k)
        y = x_p * np.sin(omega_k) + y_p * np.cos(i_k) * np.cos(omega_k)
        z = y_p * np.sin(i_k)
        return float(x), float(y), float(z)

    @classmethod
    def from_ephemeris(cls, prn: int, eph) -> "Almanac":
        """Reduce a full ephemeris to almanac precision (scene synthesis
        and in-receiver collection: a decoded ephemeris is strictly
        better almanac data than the broadcast pages).

        t_oa's broadcast LSB is 4096 s, so the epoch moves by up to
        ~2048 s in quantization; the epoch-referenced elements (M0,
        Omega0, delta_i, a_f0) are re-referenced to the quantized epoch
        — otherwise the mean anomaly alone would be off by n0*dt ~ 0.1
        rad (thousands of km along-track).
        """
        t_oa_q = float(np.clip(round(eph.t_oe / 4096.0), 0, 255) * 4096.0)
        dt = t_oa_q - eph.t_oe
        a = eph.sqrt_a * eph.sqrt_a
        n = np.sqrt(MU_EARTH / (a * a * a)) + eph.dn
        alm = cls(prn=prn, e=eph.e, t_oa=t_oa_q,
                  delta_i=(eph.i_0 + eph.idot * dt) - I_REF,
                  omega_dot=eph.omega_dot,
                  health=0.0, sqrt_a=eph.sqrt_a,
                  omega_0=_wrap_pi(eph.omega_0 + eph.omega_dot * dt),
                  omega=eph.omega, m_0=_wrap_pi(eph.m_0 + n * dt),
                  a_f0=eph.a_f0 + eph.a_f1 * dt, a_f1=eph.a_f1)
        return alm.quantized()

    def quantized(self) -> "Almanac":
        """Round every field to its broadcast LSB (what a receiver that
        decoded the page would hold)."""
        out = dataclasses.replace(self)
        for name, (_segs, signed, scale) in ALM_FIELDS.items():
            raw = int(round(getattr(self, name) / scale))
            nbits = sum(lsb - msb + 1 for _, msb, lsb in _segs)
            lim = 1 << (nbits - 1 if signed else nbits)
            raw = max(-lim if signed else 0, min(lim - 1, raw))
            setattr(out, name, raw * scale)
        return out


def ingest_page(data240: np.ndarray) -> Optional[Almanac]:
    """Decode one parity-valid subframe 4/5 page; None if not an SV
    almanac page (data ID != 1 or SV ID outside 1..32)."""
    if subframe_id(data240) not in (4, 5):
        return None
    if _get_bits(data240, [(3, 1, 2)]) != 1:   # data ID: GPS
        return None
    svid = _get_bits(data240, [(3, 3, 8)])
    if not 1 <= svid <= 32:
        return None
    alm = Almanac(prn=svid)
    for name, (segs, signed, scale) in ALM_FIELDS.items():
        raw = _get_bits(data240, segs)
        if signed:
            nbits = sum(lsb - msb + 1 for _, msb, lsb in segs)
            raw = _twos(raw, nbits)
        setattr(alm, name, raw * scale)
    return alm


def encode_pages(almanacs: dict[int, Almanac], tow_start: int
                 ) -> list[np.ndarray]:
    """Encode SV almanac pages as transmitted parity-valid 300-bit
    subframes (PRN 1-24 ride subframe 5, PRN 25-32 subframe 4, per ICD
    Table 20-V page allocation), TOW counts incrementing per subframe."""
    from ..constants import PREAMBLE
    from .bits import encode_word

    frames = []
    d29 = d30 = 0
    for k, prn in enumerate(sorted(almanacs)):
        alm = almanacs[prn]
        data = np.zeros(240, dtype=np.uint8)
        data[0:8] = PREAMBLE
        _set_bits(data, [(2, 1, 17)], tow_start + k)
        _set_bits(data, [(2, 20, 22)], 5 if prn <= 24 else 4)
        _set_bits(data, [(3, 1, 2)], 1)        # data ID
        _set_bits(data, [(3, 3, 8)], prn)      # SV ID names the page
        for name, (segs, signed, scale) in ALM_FIELDS.items():
            raw = int(round(getattr(alm, name) / scale))
            nbits = sum(lsb - msb + 1 for _, msb, lsb in segs)
            if signed and raw < 0:
                raw += 1 << nbits
            assert 0 <= raw < (1 << nbits), f"almanac {name} out of range"
            _set_bits(data, segs, raw)
        tx = np.empty(300, dtype=np.uint8)
        for w in range(10):
            src = data[w * 24:(w + 1) * 24]
            if w in (1, 9):
                _solve_tbits(src, d29, d30)
            word = encode_word(src, d29, d30)
            tx[w * 30:(w + 1) * 30] = word
            d29, d30 = int(word[28]), int(word[29])
        frames.append(tx)
    return frames


def elevation_deg(sat_ecef, rx_ecef) -> float:
    """Elevation of a satellite above the receiver's local horizon.

    Same geodetic ENU geometry as the solver/NMEA path (pvt.iono.az_el)
    so mask comparisons here agree with the GSV elevations emitted for
    the same satellite.
    """
    from ..pvt.iono import az_el
    from ..pvt.solve import lat_lon_alt
    lat, lon, _alt = lat_lon_alt(*np.asarray(rx_ecef, np.float64))  # rad
    _az, el = az_el(rx_ecef, sat_ecef, lat, lon)
    return float(np.degrees(el))


def visible_prns(almanacs: dict[int, Almanac], rx_ecef, t: float,
                 mask_deg: float = 5.0, margin_s: float = 0.0
                 ) -> list[int]:
    """PRNs predicted above ``mask_deg`` elevation at time-of-week ``t``.

    ``margin_s`` widens the check to [t, t + margin_s], sampled every
    <=20 min (a GPS pass rises through a 5 deg mask in ~10 min of a
    ~6 h arc, so a 20-min grid cannot miss a whole pass — endpoint-only
    evaluation could skip one that rises AND sets strictly inside a
    long margin).  A long planned session thus keeps SVs that will
    RISE during it.  Unknown/unhealthy SVs are omitted — the caller
    decides whether to fall back to a full sweep when the directed set
    comes up short.
    """
    if margin_s <= 0:
        times = [t]
    else:
        n = 1 + int(np.ceil(margin_s / 1200.0))
        times = list(t + np.linspace(0.0, margin_s, max(2, n)))
    out = []
    for prn in sorted(almanacs):
        alm = almanacs[prn]
        if not alm.valid():
            continue
        if any(elevation_deg(alm.get_xyz(tt), rx_ecef) >= mask_deg
               for tt in times):
            out.append(prn)
    return out
