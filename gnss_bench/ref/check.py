"""The comparison that decides ``correct``: the program's answers for a
capture against a plain float64 reference and the capture's truth.

Nothing here imports the program: the reference reads the capture file
that the program read, and the program's outputs (a ``ReceiverResult``
and the receiver's oscillator-offset estimate) only to judge them.

Layer by layer:

* Acquisition (the start): the detected PRNs against the sky the
  generator placed (exact), each detection's Doppler and code phase
  against the truth within the search's resolution.
* Tracking: the tracker's outputs are followed step by step from its
  own recorded NCO trajectory, since a closed loop cannot be re-run
  apart from it.  The reference mixes the capture to baseband itself,
  wipes each 1 ms epoch with the carrier the step used, and correlates it
  against the channel's code at the step's code phase (the FFT-dot
  correlator of the kernels' design, ``corr(tau) = 1/NF sum_k W[k]
  S[k] e^{-j 2 pi k_eff tau / NF}``, in float64).  ``prompt_gap``: the
  widest gap between the program's prompt and the reference's, after
  one common phase per 10 ms step (the float32 carrier-phase
  accumulation, which the PLL absorbs), over the channel's rms prompt.
  ``carrier_gap_hz`` and ``code_rate_gap``: the Costas/FLL and DLL
  filters run in float64 on the program's prompts and the reference's
  early/late magnitudes predict each step's carrier frequency and each
  step's change of the code rate.  ``code_nco_gap``: each step's code phase from the last one and
  the recorded rate.  The start that this skips (the seeds) is checked
  by itself: the seed the first step implies against the detection.
* NAV: every decoded ephemeris field against the generator's ephemeris
  as the ICD quantizes it (exact).
* PVT: every fix against the truth position, and its receiver time
  against the capture's: the scene's receiver clock is exact, so a fix
  taken at epoch ``e`` (1 ms) was taken at ``T_RX0 + e`` ms.  A NAV
  anchor one bit (20 ms) off on every channel moves the clock bias by
  20 ms and the position by only tens of metres.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..gen import gps
from ..gen.scene import T_RX0

LO_OFFLINE = ((0, 1, 1, 0), (1, 1, 0, 0))   # quadrature square-wave LO


def second_order_gains(bn_hz: float, t_s: float, zeta: float = 0.7071
                       ) -> tuple[float, float]:
    """(k1, k2) of a 2nd-order loop filter updated every ``t_s`` s."""
    wn = 8.0 * zeta * bn_hz / (4.0 * zeta * zeta + 1.0)
    return 2.0 * zeta * wn, wn * wn * t_s


def fft_len(p: int) -> int:
    """Transform length of a period-P correlation: P when its only prime
    factors are 2 and 5, else the power of two >= 2P - 1."""
    n = p
    for f in (2, 5):
        while n % f == 0:
            n //= f
    if n == 1:
        return p
    nf = 1
    while nf < 2 * p - 1:
        nf *= 2
    return nf


# angles in semicircles: broadcast modulo a whole circle
ANGLES = ("m_0", "omega_0", "i_0", "omega")


def quantized(eph) -> dict:
    """The subframe 1-3 fields of ``eph`` as the ICD broadcasts them:
    each value rounded to its field's LSB, within the field's range
    (two's complement where signed; an angle wrapped into it).  No
    encoder or decoder is involved, so a scaling or sign fault in the
    receiver's decoder shows."""
    out = {}
    for name, (_sf, segs, signed, step) in gps.FIELDS.items():
        nbits = sum(last - first + 1 for _, first, last in segs)
        raw = round(getattr(eph, name) / step)
        lo, hi = ((-(1 << (nbits - 1)), (1 << (nbits - 1)) - 1) if signed
                  else (0, (1 << nbits) - 1))
        if name in ANGLES:
            raw = (raw - lo) % (1 << nbits) + lo
        if not lo <= raw <= hi:
            raise ValueError(f"{name} = {getattr(eph, name)!r} does not "
                             f"fit its {nbits}-bit field")
        out[name] = raw * step
    return out


def lsb(name: str) -> float:
    return gps.FIELDS[name][3]


# ---------------------------------------------------------------------------
# the capture as the tracker saw it
# ---------------------------------------------------------------------------

def baseband(path: str, cfg: dict, chunk_len: int, device) -> torch.Tensor:
    """The whole capture mixed to complex baseband on ``device``
    (complex64, exact for the 1-bit format): a 1-bit IF capture through
    the quadrature square-wave LO at ``4 fc / fs`` quarter cycles per
    sample; an 8-bit I/Q capture with each ``chunk_len``-sample chunk's
    mean removed from each rail, over the chunk's whole 1 ms epochs."""
    dev = torch.device(device)
    raw = torch.from_numpy(np.fromfile(path, np.uint8)).to(dev)
    fs = cfg["fs"]
    p = round(fs * 1e-3)
    if cfg["format"] == "1bit":
        k = torch.arange(8, device=dev)
        bits = ((raw[:, None].to(torch.int32) >> k) & 1).reshape(-1)
        s = 1.0 - 2.0 * bits.to(torch.float32)
        lo_rate = 4.0 * cfg["fc"] / fs
        i = torch.arange(bits.shape[0], dtype=torch.float64, device=dev)
        q4 = torch.floor(torch.remainder(i * lo_rate, 4.0)).to(torch.int64)
        itab = 1.0 - 2.0 * torch.tensor(LO_OFFLINE[0], dtype=torch.float32,
                                        device=dev)
        qtab = 1.0 - 2.0 * torch.tensor(LO_OFFLINE[1], dtype=torch.float32,
                                        device=dev)
        return torch.complex(s * itab[q4], s * qtab[q4])
    v = raw.view(torch.int8).to(torch.float64).reshape(-1, 2)
    out = torch.empty(v.shape[0], dtype=torch.complex64, device=dev)
    for s0 in range(0, v.shape[0], chunk_len):
        blk = v[s0: s0 + chunk_len]
        n = (blk.shape[0] // p) * p
        blk = blk[:n] - blk[:n].mean(0)
        out[s0: s0 + n] = torch.complex(blk[:, 0], blk[:, 1]).to(
            torch.complex64)
    return out


# ---------------------------------------------------------------------------
# tracking: the step-by-step replay
# ---------------------------------------------------------------------------

def code_spectrum(prn: int, fs: float, p: int, nf: int, device
                  ) -> torch.Tensor:
    """``conj(FFT_NF(replica)) (1 + e^{j 2 pi k P / NF})`` of one PRN's
    code resampled to one 1 ms epoch, complex128."""
    rep = gps.resample(gps.code_table()[prn - 1], fs, p).astype(np.float64)
    spec = np.conj(np.fft.fft(rep, n=nf))
    k = np.arange(nf)
    spec = spec * (1.0 + np.exp(2j * np.pi * k * (p / nf)))
    return torch.from_numpy(spec).to(device)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Each rail of a complex tensor rounded to bfloat16."""
    return torch.complex(x.real.to(torch.bfloat16).to(x.real.dtype),
                         x.imag.to(torch.bfloat16).to(x.imag.dtype))


def split_nf(nf: int) -> tuple[int, int]:
    """NF = n1 * n2 with n2 = 128 where it divides, else the largest
    factor up to sqrt(NF)."""
    if nf % 128 == 0:
        return nf // 128, 128
    r = int(math.isqrt(nf))
    while nf % r:
        r -= 1
    return nf // r, r


def four_step_bf16(w: torch.Tensor, nf: int) -> torch.Tensor:
    """The NF-point DFT of the rows of ``w [B, P]`` (zero-padded) as two
    matrix products, each with its operands rounded to bfloat16 and the
    sums kept wide, as a tensor-core four-step DFT in bfloat16 computes
    it: ``W[k1 n2 + k2] = sum_v f1[v, k1] (wt[k2, v] sum_u f2[k2, u]
    y[u, v])`` with ``y[u, v] = w[u n1 + v]``."""
    dev = w.device
    n1, n2 = split_nf(nf)
    p = w.shape[-1]
    u_rows = min(n2, -(-p // n1))
    y = torch.zeros(w.shape[0], u_rows * n1, dtype=w.dtype, device=dev)
    y[:, :p] = w
    y = y.reshape(-1, u_rows, n1)
    k2 = torch.arange(n2, dtype=torch.float64, device=dev)
    u = torch.arange(u_rows, dtype=torch.float64, device=dev)
    v = torch.arange(n1, dtype=torch.float64, device=dev)
    cis = lambda a: torch.complex(torch.cos(a), torch.sin(a))
    f2 = cis(-2.0 * math.pi * torch.outer(k2, u) / n2)
    wt = cis(-2.0 * math.pi * torch.outer(k2, v) / nf)
    f1 = cis(-2.0 * math.pi * torch.outer(v, v) / n1)
    g = (_bf16(f2) @ _bf16(y)) * wt
    g = _bf16(g) @ _bf16(f1)                       # [B, k2, k1]
    return g.transpose(-1, -2).reshape(-1, nf)


def correlate(x: torch.Tensor, e_abs: np.ndarray, phase0: np.ndarray,
              delta: np.ndarray, taus: np.ndarray, spec: torch.Tensor,
              p: int, nf: int, precision: str = "float64",
              block: int = 1000) -> np.ndarray:
    """``[n, 3]`` complex128 correlations (prompt, early, late) of epochs
    ``e_abs`` of baseband ``x``: each epoch wiped by ``exp(-j 2 pi
    (phase0 + delta n))``, transformed at NF points, times ``spec``, and
    evaluated at the three lags ``taus [n, 3]`` (samples).
    ``precision="bf16"``: the transform as a four-step DFT whose matrix
    operands are rounded to bfloat16 (:func:`four_step_bf16`), the
    control; else ``torch.fft`` in float64."""
    dev = x.device
    keff = torch.arange(nf, dtype=torch.float64, device=dev)
    keff = torch.where(keff >= nf // 2, keff - nf, keff)
    nn = torch.arange(p, dtype=torch.float64, device=dev)
    out = np.empty((len(e_abs), 3), np.complex128)
    if precision == "bf16":
        block = min(block, max(1, (1 << 27) // (16 * nf)))
    for b0 in range(0, len(e_abs), block):
        sl = slice(b0, b0 + block)
        e = torch.from_numpy(e_abs[sl]).to(dev)
        xs = x[(e[:, None] * p + nn.to(torch.int64)[None, :])].to(
            torch.complex128)
        ph = torch.remainder(
            torch.from_numpy(phase0[sl]).to(dev)[:, None]
            + torch.from_numpy(delta[sl]).to(dev)[:, None] * nn[None, :],
            1.0)
        ang = -2.0 * math.pi * ph
        w = xs * torch.complex(torch.cos(ang), torch.sin(ang))
        big_w = (four_step_bf16(w, nf) if precision == "bf16"
                 else torch.fft.fft(w, n=nf, dim=-1))
        z = big_w * spec[None, :]
        tau = torch.from_numpy(taus[sl]).to(dev)
        for j in range(3):
            # range-reduce k_eff * tau / NF in float64 before the angle
            r = torch.remainder(keff[None, :] * tau[:, j:j + 1], nf) / nf
            a = -2.0 * math.pi * r
            out[sl, j] = ((z * torch.complex(torch.cos(a), torch.sin(a)))
                          .sum(-1) / nf).cpu().numpy()
    return out


def replay_channel(rec, x, cfg: dict, loop: dict, seed, aid_offset: float,
                   spec: torch.Tensor, precision: str = "float64") -> dict:
    """Follow one channel record of the program through its steps.

    ``seed``: ``(doppler_hz, code_dev)`` the channel was started with, or
    None when the record has no detection of its own (a re-acquisition):
    its first step is then left out.  Returns the readings of this
    channel (see the module docstring); with ``precision="bf16"`` the
    control's readings on the same steps."""
    fs = cfg["fs"]
    p = round(fs * 1e-3)
    nf = fft_len(p)
    e_sub = loop["epochs_per_step"]
    step_len = p * e_sub
    ip = np.asarray(rec.ip_hist, np.float64)
    qp = np.asarray(rec.qp_hist, np.float64)
    caf = np.asarray(rec.hist("caf"), np.float64)
    cdv = np.asarray(rec.hist("cf"), np.float64)
    chips = np.asarray(rec.hist("chips"), np.float64)
    n_steps = len(ip) // e_sub
    if n_steps < 3:
        return {}
    steps = np.arange(n_steps)
    first = steps * e_sub
    caf_s, cdv_s = caf[first], cdv[first]
    # the device's code phase at each step start: the record's chip count
    # less its float64 seed plus the float32 seed the NCO started from
    cp0 = float(np.float32(rec.code_phase0 % gps.CODE_LEN_CHIPS))
    cp_s = (chips[first] - rec.code_phase0 + cp0) % gps.CODE_LEN_CHIPS

    # the NCO each step correlated with: the previous step's outputs
    f_used = np.empty(n_steps)
    c_used = np.empty(n_steps)
    f_used[1:], c_used[1:] = caf_s[:-1], cdv_s[:-1]
    s_lo = 0
    if seed is None:
        s_lo = 1
        f_used[0] = c_used[0] = np.nan
    else:
        f_used[0] = np.float32(seed[0])
        c_used[0] = np.float32(seed[1])
    ph_s = np.concatenate([[0.0], np.cumsum(caf_s[:-1] * step_len / fs)]) % 1.0

    e_in = np.tile(np.arange(e_sub), n_steps - s_lo)
    s_of = np.repeat(steps[s_lo:], e_sub)
    e_abs = (rec.start_epoch + s_of * e_sub + e_in).astype(np.int64)
    nom_epoch = (gps.CHIP_RATE_HZ * p / fs) % gps.CODE_LEN_CHIPS
    delta = f_used[s_of] / fs
    phase0 = (ph_s[s_of] + delta * e_in * p) % 1.0
    chips0 = cp_s[s_of] + c_used[s_of] / fs * e_in * p + nom_epoch * e_in
    sp = loop["corr_spacing"]
    scale = p / gps.CODE_LEN_CHIPS
    taus = np.stack([(chips0 % gps.CODE_LEN_CHIPS) * scale,
                     ((chips0 + sp) % gps.CODE_LEN_CHIPS) * scale,
                     ((chips0 - sp) % gps.CODE_LEN_CHIPS) * scale], axis=1)
    corr = correlate(x, e_abs, phase0, delta, taus, spec, p, nf)
    rows = np.arange(s_lo * e_sub, n_steps * e_sub)
    pp = ip[rows] + 1j * qp[rows]
    if precision == "bf16":
        # the control in the program's place: its correlator in bfloat16,
        # its loop state held in bfloat16, judged against the reference
        ctl = correlate(x, e_abs, phase0, delta, taus, spec, p, nf, "bf16")
        r16 = lambda a: torch.from_numpy(np.asarray(a, np.float64)).to(
            torch.bfloat16).to(torch.float64).numpy()
        pp = ctl[:, 0]
        ip = np.zeros(len(ip))
        qp = np.zeros(len(qp))
        ip[rows], qp[rows] = pp.real, pp.imag

    # prompt: one common phase per step, then the widest gap
    pr = corr[:, 0]
    rot = (pp * np.conj(pr)).reshape(-1, e_sub).sum(1)
    rot = np.repeat(rot / np.maximum(np.abs(rot), 1e-300), e_sub)
    rms = math.sqrt(float(np.mean(np.abs(pr) ** 2)))
    prompt_gap = float(np.max(np.abs(pp - pr * rot)) / rms)

    # the loop filters in float64 on the prompts and the reference's
    # early / late magnitudes
    t_s = e_sub * 1e-3
    pk1, pk2 = second_order_gains(loop["pll_bn_hz"], t_s)
    dk1, dk2 = second_order_gains(loop["dll_bn_hz"], t_s)
    fll_k2pi = 4.0 * loop["fll_bn_hz"] * (step_len / fs) * 2.0 * math.pi
    ip_m = ip[: n_steps * e_sub].reshape(n_steps, e_sub)
    qp_m = qp[: n_steps * e_sub].reshape(n_steps, e_sub)
    den = np.where(np.abs(ip_m) < 1e-9, 1e-9, ip_m)
    pll_err = np.arctan(qp_m / den).mean(1)
    ipp = np.concatenate([np.zeros((n_steps, 1)), ip_m], 1)
    qpp = np.concatenate([np.zeros((n_steps, 1)), qp_m], 1)
    ipp[1:, 0], qpp[1:, 0] = ip_m[:-1, -1], qp_m[:-1, -1]
    cross = ipp[:, :-1] * qp_m - qpp[:, :-1] * ip_m
    dot = ipp[:, :-1] * ip_m + qpp[:, :-1] * qp_m
    fll_pairs = np.arctan(cross / np.where(np.abs(dot) < 1e-9, 1e-9, dot)
                          ) / (2.0 * math.pi * 1e-3)
    valid = (ipp[:, :-1] ** 2 + qpp[:, :-1] ** 2 > 0).astype(np.float64)
    fll_err = (fll_pairs * valid).sum(1) / np.maximum(valid.sum(1), 1.0)
    pll_acc = np.cumsum(pk2 * pll_err + fll_k2pi * fll_err)
    # the carrier seed the first step implies
    seed_f = caf_s[0] - (pk1 * pll_err[0] + pll_acc[0]) / (2.0 * math.pi)
    caf_pred = seed_f + (pk1 * pll_err + pll_acc) / (2.0 * math.pi)
    got_f = r16(caf_pred) if precision == "bf16" else caf_s
    gaps = np.abs(caf_pred - got_f)[1:]
    if seed is not None:
        gaps = np.append(gaps, abs(seed_f - np.float32(seed[0])))
    carrier_gap = float(np.max(gaps))

    def dll(c):
        mag = np.abs(c[:, 1:]).reshape(-1, e_sub, 2).mean(1)
        e_m, l_m = mag[:, 0], mag[:, 1]
        err = sp * (e_m - l_m) / np.maximum(e_m + l_m, 1e-9)
        aid = ((caf_s - np.float32(aid_offset)) / gps.L1_HZ
               * gps.CHIP_RATE_HZ)
        return aid + dk1 * err + np.cumsum(dk2 * err)

    code_rate_gap = float("nan")
    if seed is not None:
        # each step's update of the code rate, so that the reference's
        # own integrator does not random-walk away from the program's
        cdv_pred = dll(corr)
        got_c = r16(dll(ctl)) if precision == "bf16" else cdv_s
        code_rate_gap = float(max(abs(got_c[0] - cdv_pred[0]), np.max(
            np.abs(np.diff(got_c) - np.diff(cdv_pred)))))

    nom_step = (gps.CHIP_RATE_HZ * step_len / fs) % gps.CODE_LEN_CHIPS
    cp_pred = cp_s[:-1] + cdv_s[:-1] / fs * step_len + nom_step
    got_p = r16(cp_pred) if precision == "bf16" else cp_s[1:]
    d = (got_p - cp_pred + 511.5) % gps.CODE_LEN_CHIPS - 511.5
    code_nco_gap = float(np.max(np.abs(d)))
    return dict(prompt_gap=prompt_gap, carrier_gap_hz=carrier_gap,
                code_rate_gap=code_rate_gap, code_nco_gap=code_nco_gap)


def lock_metric(ip: np.ndarray, qp: np.ndarray, window: int = 1000
                ) -> float:
    """Costas lock detector over the last ``window`` epochs, in [-1, 1]:
    mean (I^2 - Q^2) / (I^2 + Q^2) of the summed powers."""
    ip = np.asarray(ip[-window:], np.float64)
    qp = np.asarray(qp[-window:], np.float64)
    den = float((ip * ip + qp * qp).sum())
    return float((ip * ip - qp * qp).sum() / den) if den > 0 else 0.0


# ---------------------------------------------------------------------------
# the gates of every capture, and the comparison of a sample of them
# ---------------------------------------------------------------------------

class Truth:
    """What the generator put into a capture: the sky of ``plan``, seen
    through a common oscillator offset of ``offset_hz``."""

    def __init__(self, plan, offset_hz: float = 0.0):
        self.prns = [sv.prn for sv in plan.svs]
        self.dop = dict(zip(self.prns, plan.dopplers_hz() + offset_hz))
        self.code = dict(zip(self.prns, plan.code_phases_chips()))
        self.eph = {sv.prn: quantized(sv.eph) for sv in plan.svs}
        self.rx = np.asarray(plan.rx, np.float64)
        self.offset_hz = offset_hz


def gates(res, if_offset: float, truth: Truth, cfg: dict, traffic: dict
          ) -> list:
    """The configuration's truth gates on one capture's result; returns
    the gates it missed (empty: it passed)."""
    g = cfg["gates"]
    missed = []
    det = sorted(d["prn"] for d in res.detections)
    if len(det) < g["min_detections"]:
        missed.append(f"{len(det)} detections")
    min_ep = int(g["lock_min_s"] * 1000)
    locked = {r.prn for r in res.channels
              if not r.lost and r.n_epochs >= min_ep
              and lock_metric(r.ip_hist, r.qp_hist) > g["lock"]}
    if not set(det) <= locked:
        missed.append(f"detected {det}, locked {sorted(locked)}")
    if "offset_hz" in g and det:
        want = truth.offset_hz + float(np.median(
            [truth.dop[p] - truth.offset_hz for p in det if p in truth.dop]))
        if not abs(if_offset - want) < g["offset_hz"]:
            missed.append(f"offset estimate {if_offset:.1f} Hz, want "
                          f"{want:.1f}")
    if traffic.get("fix"):
        n_eph = sum(r.eph.valid() for r in res.channels)
        if n_eph < g["min_ephemerides"]:
            missed.append(f"{n_eph} ephemerides")
        if not res.solutions:
            missed.append("no fix")
        else:
            s = res.solutions[-1]
            err = float(np.linalg.norm(np.array([s.x, s.y, s.z]) - truth.rx))
            if not err < g["fix_m"]:
                missed.append(f"last fix {err:.1f} m off")
    return missed


def compare(res, if_offset: float, truth: Truth, path: str, cfg: dict,
            loop: dict, device, precision: str = "float64") -> dict:
    """Every compared number of one capture (the worst over its channels
    and fixes).  ``precision="bf16"`` gives the control's readings of the
    tracking numbers."""
    fs = cfg["fs"]
    p = round(fs * 1e-3)
    out = {}
    det = {d["prn"]: d for d in res.detections}
    out["acq_prn_mismatch"] = float(len(set(det) ^ set(truth.prns)))
    dop_err = [abs(d["doppler_hz"] - truth.dop[q]) for q, d in det.items()
               if q in truth.dop]
    code_err = []
    for q, d in det.items():
        if q in truth.code:
            c = d["ca_shift"] * gps.CHIP_RATE_HZ / fs - truth.code[q]
            code_err.append(abs((c + 511.5) % gps.CODE_LEN_CHIPS - 511.5)
                            * fs / gps.CHIP_RATE_HZ)
    out["acq_doppler_err_hz"] = max(dop_err, default=float("nan"))
    out["acq_code_err_samples"] = max(code_err, default=float("nan"))

    x = baseband(path, cfg, p * 1000, device)
    nf = fft_len(p)
    tr = {}
    for rec in res.channels:
        seed = None
        d = det.get(rec.prn)
        if d is not None and rec.start_epoch == 0:
            motion = d["doppler_hz"] - if_offset
            seed = (d["doppler_hz"],
                    gps.CHIP_RATE_HZ * motion / gps.L1_HZ)
        got = replay_channel(rec, x, cfg, loop, seed, if_offset,
                             code_spectrum(rec.prn, fs, p, nf, x.device),
                             precision)
        for k, v in got.items():
            if not math.isnan(v):
                tr[k] = max(tr.get(k, 0.0), v)
    del x
    out.update(tr)

    mism = 0
    for rec in res.channels:
        if rec.eph.valid() and rec.prn in truth.eph:
            for name, want in truth.eph[rec.prn].items():
                if abs(getattr(rec.eph, name) - want) > 0.5 * lsb(name):
                    mism += 1
    out["nav_field_mismatch"] = float(mism)
    errs = [float(np.linalg.norm(np.array([s.x, s.y, s.z]) - truth.rx))
            for s in res.solutions]
    if errs:
        out["fix_err_m"] = max(errs)
        # a fix that names no epoch cannot be held to its time
        out["fix_time_err_us"] = max(
            math.inf if s.snap_epoch is None
            else abs(s.t_rx - (T_RX0 + s.snap_epoch * 1e-3)) * 1e6
            for s in res.solutions)
    return out
