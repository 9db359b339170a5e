# Copied from tpu_gnss/pvt/solve.py:1-361.
"""PVT: transmit-time reconstruction + weighted Gauss-Newton position solve.

Mirrors the reference solver's structure (reference: c/solve.cpp): per-
channel transmit-time reconstruction from counter snapshots, SV clock
correction and orbit evaluation, iterative weighted least squares with
per-iteration ECI rotation of satellite positions, and WGS-84 geodetic
conversion — but uses ``np.linalg.solve`` on the weighted normal equations
instead of the reference's hand-expanded 4x4 determinant inverse
(c/solve.cpp:211-235), float64 on host (a 4-unknown problem at 0.25 Hz is
not TPU work; the reference runs it on a Pi for the same reason).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from ..constants import (NAV_BPS, CHIP_RATE_HZ, L1_HZ, OMEGA_E,
                         SPEED_OF_LIGHT, WGS84_A, WGS84_E2)
from ..nav.ephemeris import Ephemeris
from ..signal import cacode

MAX_ITER = 20  # reference: c/solve.cpp:15
CONVERGENCE_M = 1.0


@dataclasses.dataclass
class Snapshot:
    """Per-channel counter snapshot, the solver's raw input.

    Field semantics follow the reference's SNAPSHOT/GetClock
    (c/solve.cpp:24-30,118-133): the transmit time is reconstructed from
    the NAV subframe TOW plus buffered bits, milliseconds, whole chips
    (from a G1 register readout), and fractional code phase.
    """
    eph: Ephemeris
    power: float = 1.0        # least-squares weight (signal power)
    tow: int = 0              # TOW count of next unprocessed subframe
    bits: int = 0             # NAV bits buffered past that subframe
    ms: int = 0               # milliseconds since last bit (0..19)
    g1: Optional[int] = None  # 10-bit G1 register snapshot (FPGA-style)
    chips: int = 0            # alternative: chip count directly
    ca_phase: float = 0.0     # fractional code phase, units of 2^-6 chip

    def transmit_time(self) -> float:
        """Uncorrected SV time at the snapshot (reference: c/solve.cpp:118-133)."""
        chips = (cacode.chips_from_g1_state(self.g1)
                 if self.g1 is not None else self.chips)
        return (self.tow * 6.0
                + self.bits / NAV_BPS
                + self.ms * 1e-3
                + chips / CHIP_RATE_HZ
                + self.ca_phase * (2.0 ** -6) / CHIP_RATE_HZ)


@dataclasses.dataclass
class Solution:
    x: float
    y: float
    z: float
    t_bias: float
    t_rx: float
    iterations: int
    converged: bool
    lat_deg: float = 0.0
    lon_deg: float = 0.0
    alt_m: float = 0.0
    n_sats: int = 0
    vel: Optional["VelocitySolution"] = None  # attached when Doppler known
    residual_rms_m: Optional[float] = None    # weighted post-fit residual
    # NMEA-emission metadata, attached by the receiver (cli.nmea_out):
    sats: Optional[list] = None   # [{prn, elev_deg, az_deg, cn0_dbhz, used}]
    dops: Optional[dict] = None   # {pdop, hdop, vdop, gdop}
    # receiver epoch (1 ms units) of the snapshot this fix came from,
    # attached by the receiver — lets soak tests assert the 4 s fix
    # cadence (reference solver cadence: c/solve.cpp:300)
    snap_epoch: Optional[int] = None


def solve_position(t_tx: np.ndarray, ephs: Sequence[Ephemeris],
                   weights: Optional[np.ndarray] = None,
                   x0: Optional[np.ndarray] = None,
                   apply_iono: bool = False) -> Solution:
    """Weighted Gauss-Newton position/time solve.

    Args:
      t_tx: ``[n]`` uncorrected SV transmit times (s of week).
      ephs: matching ephemerides.
      weights: per-channel weights (reference uses signal power,
        c/solve.cpp:160); default 1.
      apply_iono: two-pass Klobuchar correction using the broadcast
        alpha/beta of the first ephemeris that carries them (the
        reference parses these but never applies them,
        c/ephemeris.cpp:204).
    """
    sol = _solve_once(t_tx, ephs, weights, x0, iono_m=None)
    if not apply_iono or not sol.converged:
        return sol
    alpha = beta = None
    for e in ephs:
        if any(e.alpha) or any(e.beta):
            alpha, beta = e.alpha, e.beta
            break
    if alpha is None:
        return sol
    from .iono import iono_range_correction_m
    rx = np.array([sol.x, sol.y, sol.z])
    lat, lon = np.radians(sol.lat_deg), np.radians(sol.lon_deg)
    iono_m = np.array([
        iono_range_correction_m(alpha, beta, rx, e.get_xyz(t), lat, lon, t)
        for e, t in zip(ephs, t_tx)])
    return _solve_once(t_tx, ephs, weights,
                       np.array([sol.x, sol.y, sol.z, sol.t_bias]),
                       iono_m=iono_m)


def solve_position_raim(t_tx: np.ndarray, ephs: Sequence[Ephemeris],
                        weights: Optional[np.ndarray] = None,
                        apply_iono: bool = False,
                        residual_gate_m: float = 500.0):
    """Position solve with integrity: fault detection and exclusion.

    RAIM-style receiver autonomy the reference lacks (its solver only
    checks step convergence, c/solve.cpp:255-265): a converged solution
    whose weighted post-fit residual RMS exceeds ``residual_gate_m`` is
    inconsistent — one channel's pseudorange is wrong (a code-period
    slip is ~300 km).  With >=5 channels, each channel is dropped in
    turn and the subset with the smallest residual wins if it passes
    the gate.  Returns ``(solution | None, excluded_index | None)``:
    None solution means NO consistent subset exists — refusing to
    report a wrong position is the integrity contract.
    """
    t_tx = np.asarray(t_tx, np.float64)
    sol = solve_position(t_tx, ephs, weights, apply_iono=apply_iono)
    if not sol.converged:
        return None, None
    rms = sol.residual_rms_m
    if rms is None or rms <= residual_gate_m:
        return sol, None
    if len(t_tx) < 5:
        return None, None
    w = None if weights is None else np.asarray(weights, np.float64)
    best = None
    for i in range(len(t_tx)):
        keep = [j for j in range(len(t_tx)) if j != i]
        s2 = solve_position(t_tx[keep], [ephs[j] for j in keep],
                            None if w is None else w[keep],
                            apply_iono=apply_iono)
        if (s2.converged and s2.residual_rms_m is not None
                and (best is None or s2.residual_rms_m < best[0])):
            best = (s2.residual_rms_m, i, s2)
    if best is not None and best[0] <= residual_gate_m:
        return best[2], best[1]
    return None, None


def _solve_once(t_tx, ephs, weights, x0, iono_m) -> Solution:
    n = len(t_tx)
    if n < 4:
        raise ValueError(f"need >=4 channels, got {n}")
    w = np.ones(n) if weights is None else np.asarray(weights, np.float64)

    # SV clock correction + ECEF positions (reference: c/solve.cpp:157-172)
    t_corr = np.array([t - e.clock_correction(t)
                       for t, e in zip(t_tx, ephs)])
    sv = np.array([e.get_xyz(t) for e, t in zip(ephs, t_corr)])

    # starting receiver clock estimate: mean + 75 ms (c/solve.cpp:175-176)
    t_pc = float(t_corr.mean() + 75e-3)

    est = np.zeros(4) if x0 is None else np.asarray(x0, np.float64).copy()
    converged = False
    t_rx = t_pc
    for it in range(1, MAX_ITER + 1):
        t_rx = t_pc - est[3]
        # Earth-rotation (ECI) correction per channel (20.3.3.4.3.3.2;
        # reference: c/solve.cpp:185-189)
        theta = (t_corr - t_rx) * OMEGA_E
        ct, st = np.cos(theta), np.sin(theta)
        sx = sv[:, 0] * ct - sv[:, 1] * st
        sy = sv[:, 0] * st + sv[:, 1] * ct
        sz = sv[:, 2]

        dx, dy, dz = est[0] - sx, est[1] - sy, est[2] - sz
        gr = np.sqrt(dx * dx + dy * dy + dz * dz)
        d_pr = SPEED_OF_LIGHT * (t_rx - t_corr) - gr
        if iono_m is not None:
            # the iono group delay lengthens the measured pseudorange;
            # remove it from the residual
            d_pr = d_pr - iono_m

        jac = np.stack([dx / gr, dy / gr, dz / gr,
                        np.full(n, SPEED_OF_LIGHT)], axis=1)
        a = jac.T @ (w[:, None] * jac)
        b = jac.T @ (w * d_pr)
        step = np.linalg.solve(a, b)

        if np.sqrt(step[:3] @ step[:3]) < CONVERGENCE_M:
            converged = True
            break
        est += step

    lat, lon, alt = lat_lon_alt(est[0], est[1], est[2])
    rms = float(np.sqrt(np.sum(w * d_pr * d_pr) / np.sum(w)))
    return Solution(x=float(est[0]), y=float(est[1]), z=float(est[2]),
                    t_bias=float(est[3]), t_rx=float(t_rx), iterations=it,
                    converged=converged,
                    lat_deg=float(np.degrees(lat)),
                    lon_deg=float(np.degrees(lon)),
                    alt_m=float(alt), n_sats=n,
                    residual_rms_m=rms if converged else None)


def solve_snapshots(snaps: Sequence[Snapshot],
                    x0: Optional[np.ndarray] = None) -> Optional[Solution]:
    """Reference-flow solve: snapshots -> clocks -> WLS (c/solve.cpp:297-317).

    Channels whose ephemeris is not valid() are dropped; returns None when
    fewer than 4 remain or the iteration hits the cap without converging,
    matching the reference's skip conditions (c/solve.cpp:302-304).
    """
    good = [s for s in snaps if s.eph.valid()]
    if len(good) < 4:
        return None
    t_tx = np.array([s.transmit_time() for s in good])
    w = np.array([s.power for s in good])
    sol = solve_position(t_tx, [s.eph for s in good], w, x0=x0)
    return sol if sol.converged else None


@dataclasses.dataclass
class VelocitySolution:
    """Doppler-based receiver velocity + clock drift.

    The reference never computes velocity (its NMEA monitors only display
    VTG sentences from commercial receivers, python/plot_nmea*.py); this
    closes the loop: carrier Doppler from the tracking bank -> ECEF
    velocity -> ENU speed / course over ground (the VTG quantities).
    """
    vx: float                # ECEF velocity (m/s)
    vy: float
    vz: float
    clk_drift: float         # receiver clock drift (s/s)
    ve: float = 0.0          # ENU velocity at the fix (m/s)
    vn: float = 0.0
    vu: float = 0.0
    speed_mps: float = 0.0   # horizontal ground speed
    course_deg: float = 0.0  # course over ground, deg clockwise from N
    n_sats: int = 0


def solve_velocity(rx_ecef: np.ndarray, t_rx: float,
                   t_tx: np.ndarray, ephs: Sequence[Ephemeris],
                   doppler_hz: np.ndarray,
                   weights: Optional[np.ndarray] = None) -> VelocitySolution:
    """One-shot linear velocity solve from carrier Doppler.

    Model (inertial frame coincident with ECEF at ``t_rx``; exact up to
    the ~mm/s light-time-rate term): with ``u`` the unit vector from the
    ECI-rotated satellite toward the receiver,

        -lambda_L1 * f_dop = u.(v_rx + w x r_rx) - u.(R(theta)(v_sv + w x r_sv))
                             + c*ddt_rx - c*ddt_sv

    which is linear in the four unknowns ``[v_rx, c*ddt_rx]``.  Satellite
    positions use the same ECI rotation ``theta = (t_tx - t_rx)*OMEGA_E``
    as the position solver (c/solve.cpp:185-189) so the geometry of the
    two solves is consistent.

    Args:
      rx_ecef: ``[3]`` receiver ECEF position (from ``solve_position``).
      t_rx: receiver time of the snapshot (``Solution.t_rx``).
      t_tx: ``[n]`` uncorrected SV transmit times (s of week).
      ephs: matching ephemerides.
      doppler_hz: ``[n]`` measured carrier Doppler (positive = satellite
        approaching), i.e. the tracking bank's ``carrier_freq`` minus any
        receiver-applied IF offset.
      weights: per-channel weights (default 1).
    """
    n = len(t_tx)
    if n < 4:
        raise ValueError(f"need >=4 channels, got {n}")
    rx = np.asarray(rx_ecef, np.float64)
    w = np.ones(n) if weights is None else np.asarray(weights, np.float64)
    f_d = np.asarray(doppler_hz, np.float64)

    t_corr = np.array([t - e.clock_correction(t)
                       for t, e in zip(t_tx, ephs)])
    sv = np.array([e.get_xyz(t) for e, t in zip(ephs, t_corr)])
    v_sv = np.array([e.get_velocity(t) for e, t in zip(ephs, t_corr)])
    ddt_sv = np.array([e.clock_drift(t) for e, t in zip(ephs, t_corr)])

    # inertial SV velocity before rotation: v_sv + w x r_sv
    v_in = v_sv + np.stack([-OMEGA_E * sv[:, 1],
                            OMEGA_E * sv[:, 0],
                            np.zeros(n)], axis=1)
    theta = (t_corr - t_rx) * OMEGA_E
    ct, st = np.cos(theta), np.sin(theta)
    rot = lambda p: np.stack([p[:, 0] * ct - p[:, 1] * st,
                              p[:, 0] * st + p[:, 1] * ct,
                              p[:, 2]], axis=1)
    sv_r, v_r = rot(sv), rot(v_in)

    d = rx[None, :] - sv_r
    u = d / np.linalg.norm(d, axis=1, keepdims=True)
    w_x_rx = np.array([-OMEGA_E * rx[1], OMEGA_E * rx[0], 0.0])

    lam = SPEED_OF_LIGHT / L1_HZ
    y = (-lam * f_d - u @ w_x_rx + np.einsum("ij,ij->i", u, v_r)
         + SPEED_OF_LIGHT * ddt_sv)
    h = np.concatenate([u, np.ones((n, 1))], axis=1)
    a = h.T @ (w[:, None] * h)
    b = h.T @ (w * y)
    est = np.linalg.solve(a, b)

    lat, lon, _ = lat_lon_alt(rx[0], rx[1], rx[2])
    sl, cl = np.sin(lon), np.cos(lon)
    sp, cp = np.sin(lat), np.cos(lat)
    v = est[:3]
    ve = -sl * v[0] + cl * v[1]
    vn = -sp * cl * v[0] - sp * sl * v[1] + cp * v[2]
    vu = cp * cl * v[0] + cp * sl * v[1] + sp * v[2]
    return VelocitySolution(
        vx=float(v[0]), vy=float(v[1]), vz=float(v[2]),
        clk_drift=float(est[3] / SPEED_OF_LIGHT),
        ve=float(ve), vn=float(vn), vu=float(vu),
        speed_mps=float(np.hypot(ve, vn)),
        course_deg=float(np.degrees(np.arctan2(ve, vn)) % 360.0),
        n_sats=n)


def lat_lon_alt(x: float, y: float, z: float) -> tuple[float, float, float]:
    """WGS-84 ECEF -> geodetic, iterative (reference: c/solve.cpp:273-293)."""
    p = np.sqrt(x * x + y * y)
    if p < 1e-6:  # pole: direct solution, the iteration would divide by 0
        return (np.pi / 2 if z >= 0 else -np.pi / 2, 0.0,
                abs(z) - WGS84_A * np.sqrt(1.0 - WGS84_E2))
    lon = np.arctan2(y, x)  # (half-angle form breaks at the antimeridian)
    lat = np.arctan(z / (p * (1.0 - WGS84_E2)))
    alt = 0.0
    for _ in range(100):
        prev = alt
        n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * np.sin(lat) ** 2)
        alt = p / np.cos(lat) - n
        lat = np.arctan(z / (p * (1.0 - WGS84_E2 * n / (n + alt))))
        if abs(alt - prev) < 1e-3:
            break
    return float(lat), float(lon), float(alt)


def geodetic_to_ecef(lat_deg: float, lon_deg: float, alt_m: float
                     ) -> tuple[float, float, float]:
    """WGS-84 geodetic -> ECEF (test/util helper)."""
    lat, lon = np.radians(lat_deg), np.radians(lon_deg)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * np.sin(lat) ** 2)
    x = (n + alt_m) * np.cos(lat) * np.cos(lon)
    y = (n + alt_m) * np.cos(lat) * np.sin(lon)
    z = (n * (1.0 - WGS84_E2) + alt_m) * np.sin(lat)
    return float(x), float(y), float(z)
