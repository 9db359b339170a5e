"""Consistent multi-SV GPS scene for end-to-end runs without JAX.

The recipe of tests/test_e2e.py:27-190 and tests/test_pvt.py:12-25
(those modules import the JAX receiver): light-time-exact code phases,
parity-valid NAV streams and Doppler-coherent carriers for a receiver at
a known position, so the whole chain — acquisition, tracking, bit/frame
sync, ephemeris decode, PVT — must recover that position.  The scene
options of the reference's recipe (an SV's dropout or fade, a moving
receiver, a common Doppler ramp) are copied from
tests/test_e2e.py:53-190.  Sample-identical to
``tests.test_e2e.build_scene`` at the same arguments and the default rate.
"""

from __future__ import annotations

import numpy as np

from ..constants import L1_HZ, OMEGA_E, SPEED_OF_LIGHT
from ..io import loaders
from ..nav.ephemeris import Ephemeris, encode_subframes
from ..pvt import solve as ps
from ..pvt.iono import ecef_to_enu
from . import synth

FS = 2.048e6
TRUTH_LLA = (52.95, -1.15, 48.0)
T_OE = 302400.0
T_RX0 = T_OE + 88.6          # receiver time of a scene's first sample


def make_constellation(n: int = 6, t_oe: float = T_OE) -> list:
    """GPS-like orbits spread in plane/anomaly, mild clock terms."""
    return [Ephemeris(
        week=900, iodc=10 + k, iode2=10 + k, iode3=10 + k,
        sqrt_a=np.sqrt(26560e3), e=0.01 + 0.001 * k,
        i_0=0.958, omega_0=k * 2 * np.pi / n, omega=0.3 * k,
        m_0=0.5 + k * 1.1, dn=4.3e-9, idot=2e-10,
        omega_dot=-8.0e-9, c_rs=12.5, c_rc=200.0, c_uc=1e-6,
        c_us=5e-6, c_ic=-5e-8, c_is=9e-8,
        t_oe=t_oe, t_oc=t_oe, a_f0=1e-4 * (k - 2), a_f1=1e-11,
        t_gd=4.6e-9) for k in range(n)]


def eph_prn(k: int) -> int:
    """PRN assignment for constellation index k (PRNs 2, 3, ...)."""
    return k + 2


def sv_time_knots(eph, rx_ecef, t_rx_knots) -> np.ndarray:
    """Light-time-exact raw SV times at receiver-time knots.

    ``rx_ecef``: ``[3]`` (static receiver) or ``[len(t_rx_knots), 3]``
    (receiver position at each knot — moving-receiver scenes).
    """
    rx_arr = np.asarray(rx_ecef, np.float64)
    out = []
    for i, t_rx in enumerate(t_rx_knots):
        rx_i = rx_arr if rx_arr.ndim == 1 else rx_arr[i]
        t_tx = t_rx - 0.075
        for _ in range(6):
            svp = np.array(eph.get_xyz(t_tx))
            th = (t_tx - t_rx) * OMEGA_E
            ct, st = np.cos(th), np.sin(th)
            eci = np.array([svp[0] * ct - svp[1] * st,
                            svp[0] * st + svp[1] * ct, svp[2]])
            t_tx = t_rx - np.linalg.norm(rx_i - eci) / SPEED_OF_LIGHT
        raw = t_tx
        for _ in range(4):
            raw = t_tx + eph.clock_correction(raw)
        out.append(raw)
    return np.array(out)


def enu_to_ecef_matrix(lat_deg: float, lon_deg: float) -> np.ndarray:
    """Columns are the local East/North/Up unit vectors in ECEF."""
    lat, lon = np.radians(lat_deg), np.radians(lon_deg)
    r = np.column_stack([ecef_to_enu(None, lat, lon, e)
                         for e in np.eye(3)])
    return r.T   # ecef_to_enu's matrix maps ECEF->ENU; transpose inverts


def sky_dopplers_hz(ephs, rx_ecef, t: float = 0.0) -> np.ndarray:
    """True carrier Doppler (Hz) of each SV of :func:`build_scene` at scene
    time ``t``: ``L1 * (dt_sv/dt_rx - 1)``, the rate of the carrier phase
    that :func:`synth.synth_from_sv_time` gives it (a central difference
    over +-0.5 s, well inside float64 at seconds of week)."""
    return np.array([L1_HZ * (np.diff(sv_time_knots(
        eph, rx_ecef, T_RX0 + t + np.array([-0.5, 0.5])))[0] - 1.0)
        for eph in ephs])


def build_scene(duration: float = 20.0, n_sv: int = 6, noise: float = 0.7,
                seed: int = 42, fs: float = FS, dropout=None, degrade=None,
                rx_vel_enu=None, doppler_ramp_hz_s: float = 0.0):
    """Consistent multi-SV complex-baseband scene: ``(iq, ephs, rx_ecef)``.

    Each SV's NAV stream cycles subframes [4, 1, 2, 3]; the start time is
    chosen so the receiver locks during the subframe-4 filler and then
    catches complete subframes 1-3 (a cold fix needs ~20 s).  Synthesis
    runs in 2 s segments (bounded memory, bit-identical to one pass).

    ``dropout``: optional ``(sv_index, t0_s, t1_s)`` — that SV's signal
    vanishes over [t0, t1) of receiver time (antenna blockage).
    ``degrade``: optional ``(sv_index, t0_s, gain)`` — that SV's amplitude
    drops to ``gain`` from t0 on (a deep fade).
    ``rx_vel_enu``: optional ``[3]`` East/North/Up receiver velocity (m/s),
    constant over the scene; ``rx_ecef`` in the return stays the t=0
    position, and the truth at scene time t is
    ``rx + enu_to_ecef_matrix(lat, lon) @ rx_vel_enu * t``.
    ``doppler_ramp_hz_s``: a common carrier-Doppler ramp (Hz/s at L1), a
    quadratic receiver clock term: every SV's Doppler ramps by
    ``ramp * t``.
    """
    rng = np.random.default_rng(seed)
    ephs = make_constellation(n_sv, t_oe=T_OE)
    rx = ps.geodetic_to_ecef(*TRUTH_LLA)
    vel_ecef = None
    if rx_vel_enu is not None:
        vel_ecef = enu_to_ecef_matrix(TRUTH_LLA[0], TRUTH_LLA[1]) \
            @ np.asarray(rx_vel_enu, np.float64)
    n = int(duration * fs)
    t_knots = np.linspace(0, duration, max(41, int(3 * duration)))
    fit_deg = max(3, int(duration // 12))
    t_rx0 = T_RX0
    n_sf = int(np.ceil(duration / 6.0)) + 2
    sids = tuple(([4, 1, 2, 3] * ((n_sf + 3) // 4))[:n_sf])
    iq = np.zeros(n, dtype=np.complex64)
    seg_n = int(2.0 * fs)
    # receiver-clock acceleration: sample n (receiver time t) sees the
    # field at true time t + 0.5*(ramp/L1)*t^2
    knots_t = t_rx0 + t_knots
    if doppler_ramp_hz_s:
        knots_t = knots_t + 0.5 * (doppler_ramp_hz_s / L1_HZ) * t_knots ** 2
    rx_np = np.asarray(rx, np.float64)
    rx_knots = (rx_np if vel_ecef is None
                else rx_np[None, :] + np.outer(t_knots, vel_ecef))
    for k, eph in enumerate(ephs):
        tsv_k = sv_time_knots(eph, rx_knots, knots_t)
        if duration > 60.0:
            from scipy.interpolate import CubicSpline
            poly = CubicSpline(t_knots, tsv_k)
        else:
            poly = np.polynomial.Polynomial.fit(t_knots, tsv_k, deg=fit_deg)
        tsv0 = float(poly(0.0))
        sf0 = 6.0 * np.floor(tsv0 / 6.0)
        frames = encode_subframes(eph, tow_start=int(sf0 / 6.0) + 1,
                                  sids=sids)
        stream = np.concatenate(frames)
        for s0 in range(0, n, seg_n):
            s1 = min(s0 + seg_n, n)
            t = np.arange(s0, s1, dtype=np.float64) / fs
            sig = synth.synth_from_sv_time(
                eph_prn(k), poly(t), stream, sf0, fs, amplitude=1.0,
                t_rx=t, t_rx_ref=0.0, t_sv_ref=tsv0)
            if dropout is not None and dropout[0] == k:
                a = max(int(dropout[1] * fs), s0) - s0
                b = max(int(dropout[2] * fs), s0) - s0
                sig[a:b] = 0.0
            if degrade is not None and degrade[0] == k:
                a = min(max(int(degrade[1] * fs), s0) - s0, s1 - s0)
                sig[a:] *= degrade[2]
            iq[s0:s1] += sig
    # real rail first, then imag: the historical noise realization
    for rail in (1.0, 1.0j):
        for s0 in range(0, n, seg_n):
            s1 = min(s0 + seg_n, n)
            v = rng.standard_normal(s1 - s0)
            iq[s0:s1] += (rail * (noise / np.sqrt(2)) * v
                          ).astype(np.complex64)
    return iq, ephs, rx


def write_1bit_capture(iq: np.ndarray, fc: float, fs: float, path) -> None:
    """Up-mix to a real IF at ``fc``, hard-limit, and write the
    reference's LSB-first bit-packed 1-bit capture format."""
    bits = synth.baseband_to_1bit_if(iq, fc, fs)
    with open(path, "wb") as f:
        f.write(loaders.pack_1bit(bits))
