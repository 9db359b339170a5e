"""Captures made on the device from a seed.

The recipe of ``tpu_gnss_torch/signal/scene.build_scene`` and
``signal/synth.synth_from_sv_time`` (the e2e scene of
tests/test_e2e.py:27-190): six SVs in GPS-like orbits seen from a known
position, light-time-exact code phases, parity-valid NAV subframes
[4, 1, 2, 3] and Doppler-coherent carriers, so a receiver that works
recovers that position.  The orbits, the NAV bits and the SV-time
polynomial stay float64 on the host (:func:`plan`); the per-sample
synthesis, the noise and the quantization run on the card
(:func:`baseband`, :func:`onebit_bytes`, :func:`iq8_bytes`), with the
same float64 expressions as the recipe, so that a noiseless baseband
equals ``build_scene(noise=0)`` to complex64 rounding.

The sky is the e2e scene's, whose orbits take no account of the Earth
(four of its six SVs stand below the truth position's horizon), or a
visible one (:func:`visible_constellation`): the same orbits turned so
that every SV stands above that horizon, as an almanac would predict.
The seed only sets each capture's noise and, for an I/Q format, its
common oscillator offset: every capture of every seed carries the same
sky, so every run does the same work.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import gps

TRUTH_LLA = (52.95, -1.15, 48.0)
T_OE = 302400.0
T_RX0 = T_OE + 88.6          # receiver time of a capture's first sample
SEG_S = 2.0                  # synthesis segment, seconds
# where each SV of the visible sky stands from the truth position at
# T_RX0: (azimuth, elevation) in degrees, spread round the sky that
# orbits inclined at 55 degrees leave open from 53 N (none far north)
VISIBLE_AZ_EL = ((160.0, 72.0), (70.0, 34.0), (115.0, 48.0),
                 (200.0, 30.0), (255.0, 52.0), (300.0, 26.0))


def make_constellation(n: int = 6, t_oe: float = T_OE) -> list:
    """GPS-like orbits spread in plane and anomaly, mild clock terms
    (tpu_gnss_torch/signal/scene.py:30-41)."""
    return [gps.Ephemeris(
        week=900, iodc=10 + k, iode2=10 + k, iode3=10 + k,
        sqrt_a=np.sqrt(26560e3), e=0.01 + 0.001 * k,
        i_0=0.958, omega_0=k * 2 * np.pi / n, omega=0.3 * k,
        m_0=0.5 + k * 1.1, dn=4.3e-9, idot=2e-10,
        omega_dot=-8.0e-9, c_rs=12.5, c_rc=200.0, c_uc=1e-6,
        c_us=5e-6, c_ic=-5e-8, c_is=9e-8,
        t_oe=t_oe, t_oc=t_oe, a_f0=1e-4 * (k - 2), a_f1=1e-11,
        t_gd=4.6e-9) for k in range(n)]


def visible_constellation(n: int, rx_ecef) -> list:
    """:func:`make_constellation`'s orbits with each SV's node and mean
    anomaly at epoch (``omega_0``, ``m_0``) set so that at ``T_RX0`` SV
    ``k`` stands at ``VISIBLE_AZ_EL[k]`` from ``rx_ecef`` (a spherical
    Earth; even ``k`` on the ascending pass, odd on the descending, so
    that the Dopplers take both signs; every other field as it was)."""
    if n > len(VISIBLE_AZ_EL):
        raise ValueError(f"a visible sky has at most {len(VISIBLE_AZ_EL)}"
                         f" SVs, not {n}")
    rx = np.asarray(rx_ecef, np.float64)
    r0 = np.linalg.norm(rx)
    lat0, lon0 = np.arcsin(rx[2] / r0), np.arctan2(rx[1], rx[0])
    out = []
    t_k = T_RX0 - T_OE
    for k, eph in enumerate(make_constellation(n, t_oe=T_OE)):
        az, el = np.radians(VISIBLE_AZ_EL[k])
        a = eph.sqrt_a ** 2
        # the Earth-central angle to the sub-satellite point, and that
        # point's latitude and longitude
        psi = np.pi / 2 - el - np.arcsin(r0 / a * np.cos(el))
        lat = np.arcsin(np.sin(lat0) * np.cos(psi)
                        + np.cos(lat0) * np.sin(psi) * np.cos(az))
        lon = lon0 + np.arctan2(np.sin(az) * np.sin(psi) * np.cos(lat0),
                                np.cos(psi) - np.sin(lat0) * np.sin(lat))
        # argument of latitude on the pass, and the node's longitude in
        # the Earth-fixed frame then
        u = np.arcsin(np.sin(lat) / np.sin(eph.i_0))
        if k % 2:
            u = np.pi - u
        node = lon - np.arctan2(np.cos(eph.i_0) * np.sin(u), np.cos(u))
        v = u - eph.omega
        e_anom = 2.0 * np.arctan(np.sqrt((1.0 - eph.e) / (1.0 + eph.e))
                                 * np.tan(v / 2.0))
        n_mean = np.sqrt(gps.MU_EARTH / a ** 3) + eph.dn
        wrap = lambda x: float((x + np.pi) % (2.0 * np.pi) - np.pi)
        out.append(dataclasses.replace(
            eph,
            omega_0=wrap(node - (eph.omega_dot - gps.OMEGA_E) * t_k
                         + gps.OMEGA_E * T_OE),
            m_0=wrap(e_anom - eph.e * np.sin(e_anom) - n_mean * t_k)))
    return out


def sv_time_knots(eph, rx_ecef, t_rx_knots) -> np.ndarray:
    """Light-time-exact raw SV times at receiver-time knots, static
    receiver (tpu_gnss_torch/signal/scene.py:49-72)."""
    rx = np.asarray(rx_ecef, np.float64)
    out = []
    for t_rx in t_rx_knots:
        t_tx = t_rx - 0.075
        for _ in range(6):
            svp = np.array(eph.get_xyz(t_tx))
            th = (t_tx - t_rx) * gps.OMEGA_E
            ct, st = np.cos(th), np.sin(th)
            eci = np.array([svp[0] * ct - svp[1] * st,
                            svp[0] * st + svp[1] * ct, svp[2]])
            t_tx = t_rx - np.linalg.norm(rx - eci) / gps.SPEED_OF_LIGHT
        raw = t_tx
        for _ in range(4):
            raw = t_tx + eph.clock_correction(raw)
        out.append(raw)
    return np.array(out)


@dataclasses.dataclass
class Sv:
    """One SV of a plan: its PRN, ephemeris, SV-time polynomial (numpy's
    fitted ``Polynomial``), NAV bit stream and the SV time of its bit 0."""
    prn: int
    eph: object
    poly: object
    stream: np.ndarray
    sf0: float
    tsv0: float


@dataclasses.dataclass
class Plan:
    """The host half of a capture: what every capture of a run shares."""
    duration: float
    fs: float
    svs: list
    rx: tuple

    @property
    def n(self) -> int:
        return int(self.duration * self.fs)

    def dopplers_hz(self) -> np.ndarray:
        """True carrier Doppler of each SV at t = 0: ``L1 (dt_sv/dt_rx -
        1)`` by a central difference over +-0.5 s
        (tpu_gnss_torch/signal/scene.py:84-92)."""
        return np.array([gps.L1_HZ * (np.diff(sv_time_knots(
            sv.eph, self.rx, T_RX0 + np.array([-0.5, 0.5])))[0] - 1.0)
            for sv in self.svs])

    def code_phases_chips(self) -> np.ndarray:
        """True code phase of each SV at sample 0, chips in [0, 1023)."""
        return np.array([((sv.tsv0 - sv.sf0) * gps.CHIP_RATE_HZ)
                         % gps.CODE_LEN_CHIPS for sv in self.svs])


def plan(duration: float, fs: float, n_sv: int = 6, visible: bool = False
         ) -> Plan:
    """Orbits, NAV streams and SV-time polynomials of a ``duration`` s
    capture at ``fs`` (tpu_gnss_torch/signal/scene.py:98-160, static
    receiver, no dropout, fade or ramp): the e2e scene's sky, or with
    ``visible`` every SV above the horizon."""
    rx = gps.geodetic_to_ecef(*TRUTH_LLA)
    ephs = (visible_constellation(n_sv, rx) if visible
            else make_constellation(n_sv, t_oe=T_OE))
    t_knots = np.linspace(0, duration, max(41, int(3 * duration)))
    fit_deg = max(3, int(duration // 12))
    n_sf = int(np.ceil(duration / 6.0)) + 2
    sids = tuple(([4, 1, 2, 3] * ((n_sf + 3) // 4))[:n_sf])
    svs = []
    for k, eph in enumerate(ephs):
        tsv_k = sv_time_knots(eph, rx, T_RX0 + t_knots)
        poly = np.polynomial.Polynomial.fit(t_knots, tsv_k, deg=fit_deg)
        tsv0 = float(poly(0.0))
        sf0 = 6.0 * np.floor(tsv0 / 6.0)
        frames = gps.encode_subframes(eph, tow_start=int(sf0 / 6.0) + 1,
                                      sids=sids)
        svs.append(Sv(prn=k + 2, eph=eph, poly=poly,
                      stream=np.concatenate(frames), sf0=sf0, tsv0=tsv0))
    return Plan(duration=duration, fs=fs, svs=svs, rx=rx)


def _poly_eval(poly, t: torch.Tensor) -> torch.Tensor:
    """numpy's ``Polynomial.__call__`` on the device, operation for
    operation: map the domain, then Horner from the top coefficient."""
    off, scl = poly.mapparms()
    x = off + scl * t
    c = poly.coef
    out = torch.full_like(x, float(c[-1]))
    for ci in c[-2::-1]:
        out = float(ci) + out * x
    return out


def baseband(p: Plan, device) -> torch.Tensor:
    """The noiseless complex64 baseband ``[n]`` of plan ``p`` on
    ``device``: each SV's ``A d(t) c(t) exp(-j 2 pi L1 (t - dt_sv))`` from
    its SV-time polynomial, in float64, summed in complex64 as the recipe
    sums it."""
    dev = torch.device(device)
    table = torch.from_numpy(1.0 - 2.0 * gps.code_table().astype(
        np.float64)).to(dev)
    iq = torch.zeros(p.n, dtype=torch.complex64, device=dev)
    seg_n = int(SEG_S * p.fs)
    for sv in p.svs:
        code = table[sv.prn - 1]
        data_tbl = torch.from_numpy(
            1.0 - 2.0 * sv.stream.astype(np.float64)).to(dev)
        for s0 in range(0, p.n, seg_n):
            s1 = min(s0 + seg_n, p.n)
            t = torch.arange(s0, s1, dtype=torch.float64, device=dev) / p.fs
            t_sv = _poly_eval(sv.poly, t)
            rel = t_sv - sv.sf0
            chip_idx = torch.floor(rel * gps.CHIP_RATE_HZ).to(torch.int64)
            c = code[chip_idx % gps.CODE_LEN_CHIPS]
            bit_idx = torch.clamp((rel * 50.0).to(torch.int64), 0,
                                  len(sv.stream) - 1)
            d = data_tbl[bit_idx]
            cycles = -gps.L1_HZ * (t - (t_sv - sv.tsv0) - 0.0)
            cycles = cycles - torch.floor(cycles)
            ang = 2.0 * math.pi * cycles
            amp = d * c
            sig = torch.complex(amp * torch.cos(ang), amp * torch.sin(ang))
            iq[s0:s1] += sig.to(torch.complex64)
    return iq


def noise(n: int, std: float, gen: torch.Generator, device
          ) -> torch.Tensor:
    """Complex64 white noise of ``std`` per complex sample from ``gen``."""
    v = torch.randn(2, n, generator=gen, dtype=torch.float32, device=device)
    return torch.complex(v[0], v[1]) * (std / math.sqrt(2.0))


def onebit_bytes(iq: torch.Tensor, fc: float, fs: float) -> np.ndarray:
    """Up-mix to a real IF at ``fc``, hard-limit (bit 1 = negative), and
    pack LSB first: the reference's 1-bit capture format
    (tpu_gnss_torch/signal/synth.py:183-195, io/loaders.pack_1bit).  The
    length is trimmed to whole bytes."""
    dev = iq.device
    n = (iq.shape[0] // 8) * 8
    out = torch.empty(n // 8, dtype=torch.uint8, device=dev)
    weights = (2 ** torch.arange(8, device=dev)).to(torch.int32)
    seg = 1 << 23
    for s0 in range(0, n, seg):
        s1 = min(s0 + seg, n)
        k = torch.arange(s0, s1, dtype=torch.float64, device=dev)
        ang = 2.0 * math.pi * fc * k / fs
        x = iq[s0:s1].to(torch.complex128)
        y = x.real * torch.cos(ang) - x.imag * torch.sin(ang)
        bits = (y < 0).to(torch.int32).reshape(-1, 8)
        out[s0 // 8: s1 // 8] = (bits * weights).sum(1).to(torch.uint8)
    return out.cpu().numpy()


def iq8_bytes(iq: torch.Tensor, fs: float, offset_hz: float = 0.0
              ) -> np.ndarray:
    """Interleaved signed 8-bit I/Q at 100 x the larger rail's peak,
    mixed by a common ``offset_hz`` first (a replay capture's TX/RX
    oscillator offset); with an offset the scale leaves room for the
    rotation (tpu_gnss_torch's chip_smoke.write_iq8)."""
    dev = iq.device
    peak = max(float(iq.real.abs().max()), float(iq.imag.abs().max()))
    scale = 100.0 / (peak * (1.0 if offset_hz == 0.0 else math.sqrt(2.0)))
    n = iq.shape[0]
    out = torch.empty(2 * n, dtype=torch.int8, device=dev)
    seg = 1 << 23
    for s0 in range(0, n, seg):
        s1 = min(s0 + seg, n)
        x = iq[s0:s1].to(torch.complex128)
        if offset_hz:
            k = torch.arange(s0, s1, dtype=torch.float64, device=dev)
            ang = 2.0 * math.pi * torch.remainder(offset_hz * k / fs, 1.0)
            x = x * torch.complex(torch.cos(ang), torch.sin(ang))
        raw = torch.empty(2 * (s1 - s0), dtype=torch.float64, device=dev)
        raw[0::2] = torch.clamp(torch.round(x.real * scale), -127, 127)
        raw[1::2] = torch.clamp(torch.round(x.imag * scale), -127, 127)
        out[2 * s0: 2 * s1] = raw.to(torch.int8)
    return out.cpu().numpy()
