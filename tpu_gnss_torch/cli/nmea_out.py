# Copied from tpu_gnss/cli/nmea_out.py:1-261 (the whole module); only
# the imports changed.
"""NMEA-0183 sentence emission from PVT solutions.

Closes the validation loop the reference runs with commercial hardware:
its monitors (reference: python/plot_nmea8-ttyACM0-GPS.py:84-159) consume
GGA/GSA/GSV/RMC/VTG from a serial receiver; here the framework's own
:class:`tpu_gnss_torch.pvt.solve.Solution` fixes are rendered into the same
sentences, so ``cli.nmea``'s monitor and ``compare_tracks`` work on our
output exactly as they do on a u-blox track.

Sentence set per fix (one "burst", the usual per-epoch group a GPS
receiver emits): GGA (position), GSA (used SVs + DOPs), GSV (satellites
in view with elevation/azimuth/C/N0), RMC (recommended minimum), VTG
(ground speed/course from the Doppler velocity solve), GST (pseudorange
error statistics from the solver residuals, when available).
"""

from __future__ import annotations

import datetime
from typing import Optional, Sequence

import numpy as np

from ..pvt.solve import Solution, lat_lon_alt

#: GPS epoch for week/TOW -> calendar conversion.
GPS_EPOCH = datetime.datetime(1980, 1, 6, tzinfo=datetime.timezone.utc)

#: GPS-UTC leap-second fallback, used only when no broadcast page-18 UTC
#: parameters are available (``Ephemeris.has_utc`` False).  The framework's
#: synthetic scenes default to ΔtLS=0 so roundtrips stay exact; on real
#: sky data the broadcast value (18 as of 2026) is decoded and drives the
#: timestamps instead (see ``Ephemeris.leap_seconds``).
DEFAULT_LEAP_S = 0


def checksum(body: str) -> str:
    """XOR checksum over the sentence body (between '$' and '*')."""
    c = 0
    for ch in body:
        c ^= ord(ch)
    return f"{c:02X}"


def sentence(body: str) -> str:
    """Wrap a body into a full ``$body*hh`` sentence."""
    return f"${body}*{checksum(body)}"


def _lat_str(lat_deg: float) -> tuple[str, str]:
    hemi = "N" if lat_deg >= 0 else "S"
    v = abs(lat_deg)
    deg = int(v)
    return f"{deg:02d}{(v - deg) * 60.0:09.6f}", hemi


def _lon_str(lon_deg: float) -> tuple[str, str]:
    hemi = "E" if lon_deg >= 0 else "W"
    v = abs(lon_deg)
    deg = int(v)
    return f"{deg:03d}{(v - deg) * 60.0:09.6f}", hemi


def gps_to_utc(week: Optional[int], tow_s: float,
               leap_s: float = DEFAULT_LEAP_S,
               hint_week: Optional[int] = None) -> datetime.datetime:
    """(week, time-of-week) -> UTC datetime.

    ``week`` may be the raw mod-1024 subframe-1 value — it is resolved
    to a full week via :func:`tpu_gnss_torch.nav.ephemeris.resolve_week`
    (pivot heuristic, or nearest to ``hint_week`` when given; the
    reference keeps the raw field and aliases dates into 1980+week%1024,
    c/ephemeris.cpp:36-44) — or None (epoch date; time-of-day still
    correct mod 1 day).
    """
    from ..nav.ephemeris import resolve_week
    if week is None:
        week = 0
    else:
        week = resolve_week(int(week), hint_week=hint_week)
    t = GPS_EPOCH + datetime.timedelta(weeks=int(week),
                                       seconds=float(tow_s) - leap_s)
    return t


def _hms(t: datetime.datetime) -> str:
    return (f"{t.hour:02d}{t.minute:02d}{t.second:02d}."
            f"{int(t.microsecond / 1e4):02d}")


def _dmy(t: datetime.datetime) -> str:
    return f"{t.day:02d}{t.month:02d}{t.year % 100:02d}"


# ----------------------------------------------------------------------
def sat_geometry(rx_ecef: np.ndarray, sv_ecef: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray, dict]:
    """Elevation/azimuth (deg) of satellites + DOPs at a receiver.

    ``sv_ecef``: ``[n, 3]``.  Returns (elev_deg[n], az_deg[n],
    {'pdop','hdop','vdop','gdop'}) — the quantities GSA/GSV carry.
    DOPs come from the ENU-frame cofactor matrix of the position/clock
    design matrix (same LOS geometry as the solver's Jacobian,
    reference: c/solve.cpp:191-202).
    """
    from ..pvt.iono import ecef_to_enu
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


# ----------------------------------------------------------------------
def gga(sol: Solution, t_utc: datetime.datetime,
        hdop: Optional[float] = None) -> str:
    la, lah = _lat_str(sol.lat_deg)
    lo, loh = _lon_str(sol.lon_deg)
    h = f"{hdop:.1f}" if hdop is not None else ""
    return sentence(f"GPGGA,{_hms(t_utc)},{la},{lah},{lo},{loh},1,"
                    f"{sol.n_sats:02d},{h},{sol.alt_m:.1f},M,0.0,M,,")


def gsa(used_prns: Sequence[int], dops: dict) -> str:
    slots = list(used_prns)[:12] + [""] * (12 - min(len(used_prns), 12))
    fields = ",".join(f"{p:02d}" if p != "" else "" for p in slots)
    fmt = lambda k: f"{dops[k]:.1f}" if k in dops else ""
    return sentence(f"GPGSA,A,3,{fields},"
                    f"{fmt('pdop')},{fmt('hdop')},{fmt('vdop')}")


def gsv(sats: Sequence[dict]) -> list[str]:
    """GSV group: ``sats`` = [{prn, elev_deg, az_deg, cn0_dbhz}, ...]."""
    sats = sorted(sats, key=lambda s: s["prn"])
    total = max(1, (len(sats) + 3) // 4)
    out = []
    for i in range(total):
        chunk = sats[4 * i: 4 * i + 4]
        body = f"GPGSV,{total},{i + 1},{len(sats):02d}"
        for s in chunk:
            cn0 = s.get("cn0_dbhz")
            snr = f"{int(round(cn0)):02d}" if cn0 and cn0 == cn0 else ""
            body += (f",{s['prn']:02d},{int(round(s['elev_deg'])):02d},"
                     f"{int(round(s['az_deg'])):03d},{snr}")
        out.append(sentence(body))
    return out


def rmc(sol: Solution, t_utc: datetime.datetime) -> str:
    la, lah = _lat_str(sol.lat_deg)
    lo, loh = _lon_str(sol.lon_deg)
    if sol.vel is not None:
        knots = f"{sol.vel.speed_mps * 3600.0 / 1852.0:.2f}"
        course = f"{sol.vel.course_deg:.1f}"
    else:
        knots = course = ""
    return sentence(f"GPRMC,{_hms(t_utc)},A,{la},{lah},{lo},{loh},"
                    f"{knots},{course},{_dmy(t_utc)},,,A")


def vtg(sol: Solution) -> Optional[str]:
    if sol.vel is None:
        return None
    v = sol.vel
    return sentence(f"GPVTG,{v.course_deg:.1f},T,,M,"
                    f"{v.speed_mps * 3600.0 / 1852.0:.2f},N,"
                    f"{v.speed_mps * 3.6:.2f},K,A")


def gst(t_utc: datetime.datetime, sigma_m: float) -> str:
    """Minimal GST: one isotropic error estimate in all three slots."""
    s = f"{sigma_m:.1f}"
    return sentence(f"GPGST,{_hms(t_utc)},{s},,,,{s},{s},{s}")


# ----------------------------------------------------------------------
def broadcast_leap_s(eph, week: Optional[int], tow_s: float) -> float:
    """Leap seconds for a fix: the broadcast page-18 value when ``eph``
    carries one, else :data:`DEFAULT_LEAP_S`."""
    if eph is not None and getattr(eph, "has_utc", False):
        from ..nav.ephemeris import resolve_week
        # no explicit week -> the ephemeris's own subframe-1 week (a
        # week-0 fallback would make the mod-256 WN_LSF effectivity
        # comparison arbitrary and could apply a FUTURE leap early)
        if week is None:
            week = getattr(eph, "week", 0)
        w = resolve_week(int(week))
        return eph.leap_seconds(w, tow_s)
    return DEFAULT_LEAP_S


def solution_burst(sol: Solution, week: Optional[int] = None,
                   sats: Optional[Sequence[dict]] = None,
                   leap_s: Optional[float] = None,
                   eph=None) -> list[str]:
    """Render one fix into its NMEA sentence group.

    ``sats``: optional satellite table [{prn, elev_deg, az_deg,
    cn0_dbhz}]; defaults to whatever the receiver attached to the
    solution (``sol.sats`` / ``sol.dops``, set by
    :meth:`tpu_gnss_torch.receiver.Receiver._solve_at`).  ``week``/``leap_s``
    None defer first to what the receiver attached to the solution
    (``sol.week`` raw subframe-1 week, ``sol.leap_s`` broadcast page-18
    value), then to the broadcast value from ``eph`` (any
    :class:`~tpu_gnss_torch.nav.ephemeris.Ephemeris` that ingested page 18)
    or :data:`DEFAULT_LEAP_S`.
    """
    if week is None:
        week = getattr(sol, "week", None)
    if leap_s is None:
        leap_s = getattr(sol, "leap_s", None)
    if leap_s is None:
        leap_s = broadcast_leap_s(eph, week, sol.t_rx)
    t_utc = gps_to_utc(week, sol.t_rx, leap_s)
    sats = sats if sats is not None else getattr(sol, "sats", None)
    dops = getattr(sol, "dops", None) or {}
    out = [gga(sol, t_utc, dops.get("hdop"))]
    if sats:
        out.append(gsa([s["prn"] for s in sats if s.get("used", True)],
                       dops))
        out.extend(gsv(sats))
    out.append(rmc(sol, t_utc))
    v = vtg(sol)
    if v:
        out.append(v)
    sigma = getattr(sol, "residual_rms_m", None)
    if sigma is not None:
        out.append(gst(t_utc, sigma))
    return out


def write_track(path: str, solutions: Sequence[Solution],
                week: Optional[int] = None,
                leap_s: Optional[float] = None, eph=None) -> int:
    """Write an NMEA track file from a solution list; returns sentence
    count.  The output feeds ``cli.nmea`` (monitor / compare_tracks).
    ``leap_s``/``eph`` as in :func:`solution_burst`."""
    n = 0
    with open(path, "w") as f:
        for sol in solutions:
            for s in solution_burst(sol, week=week, leap_s=leap_s,
                                    eph=eph):
                f.write(s + "\r\n")
                n += 1
    return n
