"""Tracking channel bank — DLL + Costas loops over 10 ms steps.

Counterpart of :mod:`tpu_gnss.track.channel`.  State is a NamedTuple of
``[n_chan]`` tensors; each step correlates ``epochs_per_step`` 1 ms
epochs of the shared front-end stream for every channel, through
:func:`tpu_gnss_torch.ops.mxu_track.track_corr` (the CUDA kernel on the
card, its plain version on the CPU) or the reference-style gather
correlator, then runs the discriminators and loop filters on the
device.  The reference's ``lax.scan`` over steps is
a Python loop here: nothing in it waits for the device, so the host
only enqueues work and the outputs stay on the device until the caller
fetches them.

Loop design (unchanged from the reference): standard 2nd-order loops
(zeta = 0.707) with NCO frequency = seed + filter(e); the code NCO
carries the rate DEVIATION from the nominal chip rate and advances by
the nominal step reduced mod 1023 in float64 on the host, so float32
rounding cannot bias the code phase (tpu_gnss/track/channel.py:275-298).
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from ..acquire.folded import fft_len_for_period
from ..constants import CHIP_RATE_HZ, CODE_LEN_CHIPS, L1_HZ
from ..ops import mxu_track
from ..ops.mxu_corr import four_step_np, split_nf
from ..signal import cacode


def second_order_gains(bn_hz: float, zeta: float = 0.7071,
                       t_s: float = 1e-3) -> tuple[float, float]:
    """(k1, k2) for a 2nd-order loop updated every ``t_s`` seconds.

    wn = 8*zeta*Bn/(4*zeta^2+1); filter(e) = k1*e + acc, acc += k2*e.
    """
    wn = 8.0 * zeta * bn_hz / (4.0 * zeta * zeta + 1.0)
    return 2.0 * zeta * wn, wn * wn * t_s


class ChannelState(NamedTuple):
    """Batched tracking state, all tensors ``[n_chan]``."""
    active: torch.Tensor         # bool: channel enabled
    carrier_phase: torch.Tensor  # cycles, mod 1
    carrier_seed: torch.Tensor   # Hz: acquisition Doppler seed
    code_phase: torch.Tensor     # chips, mod 1023
    pll_acc: torch.Tensor        # PLL integrator (rad/s)
    dll_acc: torch.Tensor        # DLL integrator (chips/s)
    carrier_freq: torch.Tensor   # Hz: last effective carrier frequency
    code_dev: torch.Tensor       # chips/s deviation from CHIP_RATE_HZ
    pwr_avg: torch.Tensor        # running prompt power average
    ip_prev: torch.Tensor        # previous prompt I (FLL discriminator)
    qp_prev: torch.Tensor        # previous prompt Q
    agc_on: torch.Tensor         # bool: strong-signal gain reduction active


class EpochOut(NamedTuple):
    """Per-epoch outputs, tensors ``[n_epochs, n_chan]``."""
    ip: torch.Tensor
    qp: torch.Tensor
    e_mag: torch.Tensor
    l_mag: torch.Tensor
    carrier_freq: torch.Tensor
    code_dev: torch.Tensor       # chips/s deviation from CHIP_RATE_HZ
    code_phase: torch.Tensor     # chips at epoch START


_BOOL_FIELDS = ("active", "agc_on")


def init_state(n_chan: int, device) -> ChannelState:
    z = lambda: torch.zeros(n_chan, dtype=torch.float32, device=device)
    return ChannelState(**{
        f: (torch.zeros(n_chan, dtype=torch.bool, device=device)
            if f in _BOOL_FIELDS else z())
        for f in ChannelState._fields})


def state_from_numpy(mapping, device) -> ChannelState:
    """ChannelState (or mapping) of numpy arrays -> the port's tensors.

    Accepts e.g. ``jax.tree.map(np.asarray, st)`` of the reference's state.
    Float fields are cast to float32 (the reference runs with x64 off),
    flags to bool.
    """
    if not isinstance(mapping, Mapping):
        mapping = mapping._asdict()
    out = {}
    for f in ChannelState._fields:
        a = np.asarray(mapping[f])
        a = a.astype(bool) if f in _BOOL_FIELDS else a.astype(np.float32)
        out[f] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return ChannelState(**out)


def state_to_numpy(state: ChannelState) -> ChannelState:
    """The port's ChannelState -> the same NamedTuple of numpy arrays."""
    return ChannelState(*(t.detach().cpu().numpy() for t in state))


def start_channels(state: ChannelState, chs, doppler_hz, code_phase_chips,
                   code_doppler_hz) -> ChannelState:
    """Seed channels ``chs`` from acquisition results, one upload.

    ``code_doppler_hz`` is the MOTION part of the Doppler (the detected
    Doppler minus any common oscillator offset) that seeds the code rate
    (tpu_gnss/track/channel.py:101-185).  Seeds are reduced on the host
    in float64 before the float32 cast.
    """
    dev = state.active.device
    seeds = np.empty((4, len(chs)), np.float32)
    seeds[0] = np.asarray(chs, np.float32)
    seeds[1] = np.asarray(doppler_hz, np.float32)
    seeds[2] = (np.asarray(code_phase_chips, np.float64)
                % CODE_LEN_CHIPS).astype(np.float32)
    seeds[3] = (CHIP_RATE_HZ * np.asarray(code_doppler_hz, np.float64)
                / L1_HZ).astype(np.float32)
    sd = torch.from_numpy(seeds).to(dev)
    idx = sd[0].to(torch.int64)
    dop, cp, cdev = sd[1], sd[2], sd[3]
    zero = torch.zeros_like(dop)

    def upd(a, v):
        a = a.clone()
        a[idx] = v
        return a

    return state._replace(
        active=upd(state.active, True), carrier_phase=upd(state.carrier_phase,
                                                          zero),
        carrier_seed=upd(state.carrier_seed, dop),
        code_phase=upd(state.code_phase, cp),
        pll_acc=upd(state.pll_acc, zero), dll_acc=upd(state.dll_acc, zero),
        carrier_freq=upd(state.carrier_freq, dop),
        code_dev=upd(state.code_dev, cdev),
        pwr_avg=upd(state.pwr_avg, zero), ip_prev=upd(state.ip_prev, zero),
        qp_prev=upd(state.qp_prev, zero), agc_on=upd(state.agc_on, False))


def start_channel(state: ChannelState, ch: int, doppler_hz: float,
                  code_phase_chips: float,
                  code_doppler_hz: Optional[float] = None) -> ChannelState:
    """Seed one channel (see :func:`start_channels`)."""
    if code_doppler_hz is None:
        code_doppler_hz = doppler_hz
    return start_channels(state, [ch], [doppler_hz], [code_phase_chips],
                          [code_doppler_hz])


def stop_channel(state: ChannelState, ch: int) -> ChannelState:
    """Deactivate one channel (the SignalLost mask-clear analog)."""
    active = state.active.clone()
    active[ch] = False
    return state._replace(active=active)


def channel_code_tables(prns, n_chan: int) -> np.ndarray:
    """``[n_chan, 1023]`` bipolar chips; unused channels get PRN 1
    (copied from tpu_gnss/track/channel.py:675-681)."""
    tbl = 1.0 - 2.0 * cacode.code_table().astype(np.float32)
    out = np.tile(tbl[0], (n_chan, 1)).astype(np.float32)
    for ch, prn in enumerate(prns):
        out[ch] = tbl[prn - 1]
    return out


def code_spectra_np(prns, n_chan: int, fs: float) -> np.ndarray:
    """``[n_chan, NF]`` complex64 correlator spectra
    ``conj(FFT(replica)) * (1 + e^{j2πkP/NF})`` (the wrap of the padded
    linear correlation folded in); unused channels get PRN 1.  Copied
    from tpu_gnss/track/channel.py:580-598."""
    p = int(round(fs * 1e-3))
    nf = fft_len_for_period(p)
    tbl = cacode.code_table()
    reps = np.zeros((n_chan, p), np.float64)
    for ch in range(n_chan):
        prn = prns[ch] if ch < len(prns) else 1
        reps[ch] = cacode.resample(tbl[prn - 1], fs, p)
    spec = np.conj(np.fft.fft(reps, n=nf, axis=-1))
    k = np.arange(nf)
    wrap = 1.0 + np.exp(2j * np.pi * k * (p / nf))
    return (spec * wrap[None, :]).astype(np.complex64)


# The reference's einsum-path helpers (_dft_tables_np, _tap_vectors_np and
# _frac_ramp, tpu_gnss/track/channel.py:551-666) live beside the kernel
# they feed, as mxu_track.track_tables, dense_taps and frac_ramp.

# carrier-wipe phasor split of the gather path: sample n = K*b + a
# (tpu_gnss/track/channel.py:300-307)
_WIPE_K = 256


def track_epochs(samples: torch.Tensor, state: ChannelState,
                 code_tables: Optional[torch.Tensor] = None, *, fs: float,
                 pll_gains: tuple[float, float],
                 dll_gains: tuple[float, float],
                 fll_bn_hz: float = 3.0,
                 corr_spacing: float = 0.5,
                 carrier_aiding: bool = True,
                 epochs_per_step: int = 1,
                 code_ffts: Optional[torch.Tensor] = None,
                 agc_thresholds: Optional[tuple[float, float]] = None,
                 aid_offset_hz: float = 0.0
                 ) -> tuple[ChannelState, EpochOut]:
    """Run the channel bank over a span of complex baseband samples.

    Same loop semantics and options as
    :func:`tpu_gnss.track.channel.track_epochs` (tpu_gnss/track/
    channel.py:193-547).  The correlator is one of two:

    * ``code_ffts`` (``[n_chan, NF]`` complex64 from
      :func:`code_spectra_np`): the FFT-dot taps of
      :func:`tpu_gnss_torch.ops.mxu_track.track_corr`, the CUDA kernel on
      a card, at ``corr_spacing`` chips;
    * else ``code_tables`` (``[n_chan, 1023]`` bipolar float32 from
      :func:`channel_code_tables`): the reference-style correlator that
      gathers the resampled code per sample, plain torch on the device.

    ``fll_bn_hz`` is the FLL assist bandwidth, ``carrier_aiding`` derives
    the code rate from the carrier loop (minus ``aid_offset_hz``, a common
    oscillator offset), and ``agc_thresholds = (lo, hi)`` halves the
    Costas gain while the running prompt power ``pwr_avg`` sits above
    ``hi`` until it falls below ``lo`` (the reference's strong-signal AGC,
    c/channel.cpp:265-288; ``None`` leaves ``agc_on`` as it is).

    Returns (final state, per-epoch outputs ``[n_steps*e_sub, n_chan]``),
    all on the samples' device, without waiting for the device.
    """
    if code_ffts is None and code_tables is None:
        raise ValueError("track_epochs needs code_ffts (FFT-dot "
                         "correlator) or code_tables (gather correlator)")
    dev = samples.device
    p = int(round(fs * 1e-3))
    e_sub = epochs_per_step
    step_len = p * e_sub
    n_steps = samples.shape[0] // step_len
    pll_k1, pll_k2 = pll_gains
    dll_k1, dll_k2 = dll_gains
    two_pi = 2.0 * np.pi
    t_epoch = step_len / fs
    e_steps = torch.arange(e_sub, dtype=torch.float32, device=dev)[None] * p
    e_idx = torch.arange(e_sub, dtype=torch.float32, device=dev)[None]
    # nominal code advance reduced mod 1023 in float64 on the host (exactly
    # 0 at integer-kHz sample rates); see the module docstring
    nom_step_mod = float((CHIP_RATE_HZ * step_len / fs) % CODE_LEN_CHIPS)
    nom_epoch_mod = float((CHIP_RATE_HZ * p / fs) % CODE_LEN_CHIPS)
    scale = p / CODE_LEN_CHIPS

    if code_ffts is not None:
        nf = code_ffts.shape[-1]
        n1, _ = split_nf(nf)
        u_rows = four_step_np(nf, p)["u_rows"]
        cw_r, cw_i = mxu_track.spec_planes(code_ffts, nf)
        dsamp = corr_spacing * scale
        blocks = samples[: n_steps * step_len].reshape(n_steps, e_sub, p)
        blocks = torch.nn.functional.pad(
            torch.view_as_real(blocks), (0, 0, 0, u_rows * n1 - p))
        blk_r = blocks[..., 0].reshape(n_steps, e_sub, u_rows, n1
                                       ).contiguous()
        blk_i = blocks[..., 1].reshape(n_steps, e_sub, u_rows, n1
                                       ).contiguous()

        def correlate(s, st):
            delta = st.carrier_freq / fs
            phase0 = (st.carrier_phase[:, None]
                      + delta[:, None] * e_steps) % 1.0
            chips0 = (st.code_phase[:, None] + (st.code_dev / fs)[:, None]
                      * e_steps + nom_epoch_mod * e_idx)
            s0p = (chips0 % CODE_LEN_CHIPS) * scale
            s0e = ((chips0 + corr_spacing) % CODE_LEN_CHIPS) * scale
            s0l = ((chips0 - corr_spacing) % CODE_LEN_CHIPS) * scale
            par = torch.stack([phase0, delta[:, None].expand_as(phase0), s0p,
                               (s0e < s0p).to(torch.float32),
                               (s0l > s0p).to(torch.float32)], dim=-1)
            par = par.transpose(0, 1).contiguous()    # [e_sub, n_chan, 5]
            out6 = mxu_track.track_corr(blk_r[s], blk_i[s], par, cw_r, cw_i,
                                        period=p, nf=nf, dsamp=dsamp)
            out6 = out6.transpose(0, 1)               # [n_chan, e_sub, 6]
            return (out6[..., 0], out6[..., 1],
                    torch.hypot(out6[..., 2], out6[..., 3]),
                    torch.hypot(out6[..., 4], out6[..., 5]))
    else:
        blocks = samples[: n_steps * step_len].reshape(n_steps, step_len)
        # per-sample nominal chip index, reduced mod 1023 in float64
        # before the float32 cast
        n_np = (np.arange(e_sub, dtype=np.float64)[:, None] * p
                + np.arange(p, dtype=np.float64)[None, :])
        nom_n = torch.from_numpy(((CHIP_RATE_HZ / fs) * n_np)
                                 % CODE_LEN_CHIPS).to(torch.float32).to(dev)
        n_f = torch.from_numpy(n_np.astype(np.float32)).to(dev)
        wipe_nb = -(-step_len // _WIPE_K)
        wipe_a = torch.arange(_WIPE_K, dtype=torch.float32, device=dev)
        wipe_b = torch.arange(wipe_nb, dtype=torch.float32,
                              device=dev) * _WIPE_K
        ch_idx = torch.arange(code_tables.shape[0], device=dev)[:, None, None]

        def correlate(s, st):
            delta = (st.carrier_freq / fs)[:, None]   # cycles/sample
            pha = (-two_pi) * ((delta * wipe_a[None, :]) % 1.0)
            phb = (-two_pi) * ((st.carrier_phase[:, None]
                                + delta * wipe_b[None, :]) % 1.0)
            ea = torch.complex(torch.cos(pha), torch.sin(pha))
            eb = torch.complex(torch.cos(phb), torch.sin(phb))
            lo = (eb[:, :, None] * ea[:, None, :]).reshape(
                -1, wipe_nb * _WIPE_K)[:, :step_len]
            wiped = (blocks[s][None, :] * lo).reshape(-1, e_sub, p)
            chips_t = (st.code_phase[:, None, None]
                       + (st.code_dev / fs)[:, None, None] * n_f[None]
                       + nom_n[None])

            def corr(offset):
                idx = (torch.floor(chips_t + offset).to(torch.int64)
                       % CODE_LEN_CHIPS)
                return (wiped * code_tables[ch_idx, idx]).sum(-1)

            cp = corr(0.0)
            return (cp.real, cp.imag, corr(corr_spacing).abs(),
                    corr(-corr_spacing).abs())

    st = state
    outs = []
    for s in range(n_steps):
        ip_all, qp_all, e_mag_all, l_mag_all = correlate(s, st)
        ip, qp = ip_all[:, -1], qp_all[:, -1]
        e_mag, l_mag = e_mag_all.mean(1), l_mag_all.mean(1)

        # --- discriminators (averaged over the step's epochs) -------------
        pll_err = torch.atan(qp_all / torch.where(
            ip_all.abs() < 1e-9, 1e-9, ip_all)).mean(1)
        ipp = torch.cat([st.ip_prev[:, None], ip_all], dim=1)
        qpp = torch.cat([st.qp_prev[:, None], qp_all], dim=1)
        cross = ipp[:, :-1] * qp_all - qpp[:, :-1] * ip_all
        dot = ipp[:, :-1] * ip_all + qpp[:, :-1] * qp_all
        fll_pairs = torch.atan(cross / torch.where(
            dot.abs() < 1e-9, 1e-9, dot)) / (two_pi * 1e-3)
        prev_pwr = ipp[:, :-1] ** 2 + qpp[:, :-1] ** 2
        valid = (prev_pwr > 0).to(torch.float32)
        fll_err = (fll_pairs * valid).sum(1) / valid.sum(1).clamp(min=1.0)
        denom = (e_mag + l_mag).clamp(min=1e-9)
        dll_err = corr_spacing * (e_mag - l_mag) / denom

        # --- loop filters: freq = seed + k1*e + acc ------------------------
        # strong-signal AGC: halved Costas gain while agc_on (the decision
        # is one step delayed, as the reference's 4 Hz CheckPower poll)
        if agc_thresholds is not None:
            pll_err = pll_err * torch.where(st.agc_on, 0.5, 1.0)
        fll_k = 4.0 * fll_bn_hz * t_epoch
        act = st.active
        pll_acc = st.pll_acc + torch.where(
            act, pll_k2 * pll_err + fll_k * two_pi * fll_err, 0.0)
        carrier_freq = torch.where(
            act, st.carrier_seed + (pll_k1 * pll_err + pll_acc) / two_pi,
            st.carrier_freq)
        dll_acc = st.dll_acc + torch.where(act, dll_k2 * dll_err, 0.0)
        aid = ((carrier_freq - aid_offset_hz) / L1_HZ * CHIP_RATE_HZ
               if carrier_aiding else torch.zeros_like(carrier_freq))
        code_dev = torch.where(act, aid + dll_k1 * dll_err + dll_acc,
                               st.code_dev)

        # --- NCO phase advance ---------------------------------------------
        carrier_phase = torch.where(
            act, (st.carrier_phase + carrier_freq / fs * step_len) % 1.0,
            st.carrier_phase)
        code_phase = torch.where(
            act, (st.code_phase + code_dev / fs * step_len + nom_step_mod)
            % CODE_LEN_CHIPS, st.code_phase)
        pwr = (ip_all * ip_all + qp_all * qp_all).mean(1)
        pwr_avg = torch.where(act, 0.875 * st.pwr_avg + 0.125 * pwr,
                              st.pwr_avg)
        agc_on = st.agc_on
        if agc_thresholds is not None:
            agc_lo, agc_hi = agc_thresholds
            agc_on = torch.where(
                act, torch.where(pwr_avg > agc_hi, True,
                                 torch.where(pwr_avg < agc_lo, False,
                                             st.agc_on)), st.agc_on)

        bcast = lambda a: a[:, None].expand_as(ip_all)
        phase_per_epoch = (st.code_phase[:, None] + (code_dev / fs)[:, None]
                           * e_steps + nom_epoch_mod * e_idx) % CODE_LEN_CHIPS
        outs.append((ip_all, qp_all, e_mag_all, l_mag_all,
                     bcast(carrier_freq), bcast(code_dev), phase_per_epoch))
        st = ChannelState(active=act, carrier_phase=carrier_phase,
                          carrier_seed=st.carrier_seed,
                          code_phase=code_phase, pll_acc=pll_acc,
                          dll_acc=dll_acc, carrier_freq=carrier_freq,
                          code_dev=code_dev, pwr_avg=pwr_avg,
                          ip_prev=torch.where(act, ip, st.ip_prev),
                          qp_prev=torch.where(act, qp, st.qp_prev),
                          agc_on=agc_on)

    n_chan = state.active.shape[0]
    if not outs:
        empty = torch.zeros(0, n_chan, dtype=torch.float32, device=dev)
        return st, EpochOut(*([empty] * len(EpochOut._fields)))
    # [n_steps][n_chan, e_sub] -> [n_steps * e_sub, n_chan]
    flat = [torch.stack(parts).transpose(1, 2).reshape(-1, n_chan)
            for parts in zip(*outs)]
    return st, EpochOut(*flat)


def carrier_pull_in(state: ChannelState, if_offset_hz: float = 0.0
                    ) -> ChannelState:
    """Re-seed the carrier loop from the locked code rate (copied from
    tpu_gnss/track/channel.py:684-698).

    The reference's acquisition-phase trick: the code loop always locks,
    so after a settling period the code Doppler gives a carrier Doppler
    estimate well inside the Costas capture range
    (reference: c/channel.cpp:190-207).  Resets the PLL integrator so the
    filter restarts around the new seed.
    """
    ca_dop = state.code_dev
    lo_dop = ca_dop * (L1_HZ / CHIP_RATE_HZ) + if_offset_hz
    return state._replace(
        carrier_seed=torch.where(state.active, lo_dop, state.carrier_seed),
        pll_acc=torch.where(state.active, 0.0, state.pll_acc))
