# Copied from tpu_gnss/cli/nmea_out.py:96-127 (sat_geometry only).
"""Satellite view geometry for NMEA emission: elevation, azimuth, DOPs."""

from __future__ import annotations

import numpy as np

from ..pvt.iono import ecef_to_enu
from ..pvt.solve import lat_lon_alt


def sat_geometry(rx_ecef: np.ndarray, sv_ecef: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray, dict]:
    """Elevation/azimuth (deg) of satellites + DOPs at a receiver.

    ``sv_ecef``: ``[n, 3]``.  Returns (elev_deg[n], az_deg[n],
    {'pdop','hdop','vdop','gdop'}) — the quantities GSA/GSV carry.
    DOPs come from the ENU-frame cofactor matrix of the position/clock
    design matrix (same LOS geometry as the solver's Jacobian,
    reference: c/solve.cpp:191-202).
    """
    rx = np.asarray(rx_ecef, np.float64)
    sv = np.asarray(sv_ecef, np.float64).reshape(-1, 3)
    lat, lon, _ = lat_lon_alt(rx[0], rx[1], rx[2])
    d = sv - rx[None, :]
    u = d / np.linalg.norm(d, axis=1)[:, None]
    # one geodesy implementation: the solver's iono path owns ECEF->ENU
    enu = np.stack([ecef_to_enu(rx, lat, lon, ui) for ui in u])
    elev = np.degrees(np.arcsin(np.clip(enu[:, 2], -1.0, 1.0)))
    az = np.degrees(np.arctan2(enu[:, 0], enu[:, 1])) % 360.0
    dops = {}
    if len(sv) >= 4:
        h = np.concatenate([enu, np.ones((len(sv), 1))], axis=1)
        try:
            q = np.linalg.inv(h.T @ h)
            dops = dict(hdop=float(np.sqrt(q[0, 0] + q[1, 1])),
                        vdop=float(np.sqrt(q[2, 2])),
                        pdop=float(np.sqrt(q[0, 0] + q[1, 1] + q[2, 2])),
                        gdop=float(np.sqrt(np.trace(q))))
        except np.linalg.LinAlgError:
            pass
    return elev, az, dops
