# Copied from tpu_gnss/pvt/iono.py:1-77.
"""Klobuchar ionospheric delay model + satellite geometry helpers.

The reference decodes the subframe-4 page-18 alpha/beta coefficients but
never applies them (reference: c/ephemeris.cpp:70-79 parsed, :204 usage
commented out).  Here the full ICD 20.3.3.5.2.5 single-frequency model is
implemented and can be applied as a pseudorange correction, together with
the ECEF->ENU/azimuth-elevation geometry it needs.
"""

from __future__ import annotations

import numpy as np

from ..constants import SPEED_OF_LIGHT

SC = np.pi  # 1 semicircle = pi rad


def ecef_to_enu(rx: np.ndarray, lat: float, lon: float,
                vec: np.ndarray) -> np.ndarray:
    """Rotate an ECEF difference vector into local East/North/Up."""
    sl, cl = np.sin(lat), np.cos(lat)
    so, co = np.sin(lon), np.cos(lon)
    r = np.array([[-so, co, 0.0],
                  [-sl * co, -sl * so, cl],
                  [cl * co, cl * so, sl]])
    return r @ np.asarray(vec)


def az_el(rx_ecef, sv_ecef, lat: float, lon: float) -> tuple[float, float]:
    """Azimuth/elevation (rad) of a satellite from a receiver position."""
    enu = ecef_to_enu(rx_ecef, lat, lon,
                      np.asarray(sv_ecef) - np.asarray(rx_ecef))
    az = np.arctan2(enu[0], enu[1]) % (2 * np.pi)
    el = np.arcsin(enu[2] / np.linalg.norm(enu))
    return float(az), float(el)


def klobuchar_delay(alpha, beta, lat: float, lon: float, az: float,
                    el: float, gps_tow: float) -> float:
    """Ionospheric group delay in SECONDS (ICD 20.3.3.5.2.5).

    Args:
      alpha/beta: 4-element broadcast coefficients (subframe 4 page 18).
      lat/lon: receiver geodetic coordinates, rad.
      az/el: satellite azimuth/elevation, rad.
      gps_tow: GPS time of week, s.
    """
    alpha = np.asarray(alpha, np.float64)
    beta = np.asarray(beta, np.float64)
    e_sc = el / SC                       # elevation in semicircles
    phi_u = lat / SC
    lam_u = lon / SC

    psi = 0.0137 / (e_sc + 0.11) - 0.022
    phi_i = np.clip(phi_u + psi * np.cos(az), -0.416, 0.416)
    lam_i = lam_u + psi * np.sin(az) / np.cos(phi_i * SC)
    phi_m = phi_i + 0.064 * np.cos((lam_i - 1.617) * SC)

    t = (4.32e4 * lam_i + gps_tow) % 86400.0

    amp = max(0.0, float(np.polyval(alpha[::-1], phi_m)))
    per = max(72000.0, float(np.polyval(beta[::-1], phi_m)))

    x = 2.0 * np.pi * (t - 50400.0) / per
    f = 1.0 + 16.0 * (0.53 - e_sc) ** 3
    if abs(x) < 1.57:
        return f * (5e-9 + amp * (1.0 - x * x / 2.0 + x ** 4 / 24.0))
    return f * 5e-9


def iono_range_correction_m(alpha, beta, rx_ecef, sv_ecef, lat: float,
                            lon: float, gps_tow: float) -> float:
    """Klobuchar delay as a pseudorange correction in meters."""
    az, el = az_el(rx_ecef, sv_ecef, lat, lon)
    return SPEED_OF_LIGHT * klobuchar_delay(alpha, beta, lat, lon, az, el,
                                            gps_tow)
