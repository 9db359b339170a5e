"""Tracking channel bank — DLL + Costas loops over 10 ms steps.

Counterpart of :mod:`tpu_gnss.track.channel`.  State is a NamedTuple of
``[n_chan]`` tensors; each step correlates ``epochs_per_step`` 1 ms
epochs of the shared front-end stream for every channel, through
:func:`tpu_gnss_torch.ops.mxu_track.track_corr` (the CUDA kernel on the
card, its plain version on the CPU) or the reference-style gather
correlator, then runs the discriminators, loop filters, AGC and NCO
advance in :func:`loop_update` (``csrc/loop_update.cu`` on the card):
the body of the reference's ``lax.scan`` after its correlators.  The
step loop itself is a Python loop of those two launches per step over a
packed ``[12, n_chan]`` float32 state updated in place; nothing in it
waits for the device.  :class:`tpu_gnss_torch.track.graph.GraphedTracker`
captures it as one CUDA graph per chunk shape, the counterpart of the
reference's one ``jax.jit`` program per chunk.

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

from .. import cache, kernels
from ..acquire.folded import fft_len_for_period
from ..constants import CHIP_RATE_HZ, CODE_LEN_CHIPS, L1_HZ
from ..device import resolve_device
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


def pack_state(state: ChannelState, out: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """ChannelState -> ``[12, n_chan]`` float32, one row per field in
    ``ChannelState._fields`` order, the flags as 0.0 / 1.0 (into ``out``
    when given)."""
    return torch.stack([t.to(torch.float32) for t in state], out=out)


def unpack_state(packed: torch.Tensor) -> ChannelState:
    """Inverse of :func:`pack_state`: float fields are views of
    ``packed``, flags are ``row > 0.5``."""
    return ChannelState(*(row > 0.5 if f in _BOOL_FIELDS else row
                          for f, row in zip(ChannelState._fields, packed)))


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


def _code_replicas(prns, n_chan: int, fs: float
                   ) -> tuple[np.ndarray, int, int]:
    """``(replicas [n_chan, P] float64, P, NF)`` of the correlator
    spectra: each channel's C/A code resampled to one 1 ms epoch; unused
    channels get PRN 1."""
    p = int(round(fs * 1e-3))
    tbl = cacode.code_table()
    reps = np.zeros((n_chan, p), np.float64)
    for ch in range(n_chan):
        prn = prns[ch] if ch < len(prns) else 1
        reps[ch] = cacode.resample(tbl[prn - 1], fs, p)
    return reps, p, fft_len_for_period(p)


def code_spectra_np(prns, n_chan: int, fs: float) -> np.ndarray:
    """``[n_chan, NF]`` complex64 correlator spectra
    ``conj(FFT(replica)) * (1 + e^{j2πkP/NF})`` (the wrap of the padded
    linear correlation folded in); unused channels get PRN 1.  Copied
    from tpu_gnss/track/channel.py:580-598."""
    reps, p, nf = _code_replicas(prns, n_chan, fs)
    spec = np.conj(np.fft.fft(reps, n=nf, axis=-1))
    k = np.arange(nf)
    wrap = 1.0 + np.exp(2j * np.pi * k * (p / nf))
    return (spec * wrap[None, :]).astype(np.complex64)


def code_spectra(prns, n_chan: int, fs: float, device
                 ) -> tuple[torch.Tensor, int]:
    """``(spec [n_chan, NF] complex64 on device, NF)``: the correlator
    spectra of :func:`code_spectra_np` built on ``device`` with the
    reference's float32 arithmetic (tpu_gnss/track/channel.py:601-630):
    float32 replicas, a complex64 FFT, and the wrap ``1 + e^{j2πkP/NF}``
    from float32 angles.  Unused channels get PRN 1.  The receiver keeps
    :func:`code_spectra_np`, as the reference's does."""
    dev = resolve_device(device)
    reps, p, nf = _code_replicas(prns, n_chan, fs)
    r = torch.from_numpy(reps.astype(np.float32)).to(dev)
    spec = torch.conj(torch.fft.fft(r.to(torch.complex64), n=nf, dim=-1))
    # the reference's 2π·k·(P/NF) as its jit runs it: XLA folds the two
    # constants into one float32 factor
    step = np.float32(2.0 * np.pi) * np.float32(p / nf)
    ang = torch.arange(nf, dtype=torch.float32, device=dev) * float(step)
    wrap = 1.0 + torch.complex(torch.cos(ang), torch.sin(ang))
    return spec * wrap[None, :], nf


# The reference's einsum-path helpers (_dft_tables_np, _tap_vectors_np and
# _frac_ramp, tpu_gnss/track/channel.py:551-666) live beside the kernel
# they feed, as mxu_track.track_tables, dense_taps and frac_ramp.

# carrier-wipe phasor split of the gather path: sample n = K*b + a
# (tpu_gnss/track/channel.py:300-307)
_WIPE_K = 256


class LoopOpts(NamedTuple):
    """The static options of one :func:`loop_update` step: the arguments
    of the reference's jitted ``track_epochs`` that shape its scan body."""
    fs: float
    period: int                 # samples per 1 ms epoch
    e_sub: int                  # epochs per loop update
    pll_k1: float
    pll_k2: float
    dll_k1: float
    dll_k2: float
    fll_k2pi: float             # FLL assist gain x 2π
    corr_spacing: float
    nom_step_mod: float         # nominal code advance per step, mod 1023
    nom_epoch_mod: float        # nominal code advance per epoch, mod 1023
    carrier_aiding: bool
    agc_thresholds: Optional[tuple[float, float]]


def loop_opts(*, fs: float, pll_gains: tuple[float, float],
              dll_gains: tuple[float, float], fll_bn_hz: float = 3.0,
              corr_spacing: float = 0.5, carrier_aiding: bool = True,
              epochs_per_step: int = 1,
              agc_thresholds: Optional[tuple[float, float]] = None
              ) -> LoopOpts:
    """:class:`LoopOpts` from :func:`track_epochs`' keywords.  The nominal
    code advances are reduced mod 1023 in float64 on the host (exactly 0
    at integer-kHz sample rates); see the module docstring."""
    p = int(round(fs * 1e-3))
    step_len = p * epochs_per_step
    fll_k = 4.0 * fll_bn_hz * (step_len / fs)   # x t_epoch, as the reference
    return LoopOpts(
        fs=fs, period=p, e_sub=epochs_per_step, pll_k1=pll_gains[0],
        pll_k2=pll_gains[1], dll_k1=dll_gains[0], dll_k2=dll_gains[1],
        fll_k2pi=fll_k * (2.0 * np.pi), corr_spacing=corr_spacing,
        nom_step_mod=float((CHIP_RATE_HZ * step_len / fs) % CODE_LEN_CHIPS),
        nom_epoch_mod=float((CHIP_RATE_HZ * p / fs) % CODE_LEN_CHIPS),
        carrier_aiding=carrier_aiding,
        agc_thresholds=(None if agc_thresholds is None
                        else tuple(float(a) for a in agc_thresholds)))


def step_params(state: torch.Tensor, opts: LoopOpts) -> torch.Tensor:
    """``[e_sub, n_chan, 5]`` float32 :func:`mxu_track.track_corr`
    parameters of the step that starts from packed ``state``: phase0,
    delta, prompt lag in samples, and the early / late wrap flags
    (tpu_gnss/track/channel.py:340-353)."""
    st = ChannelState(*state)
    fs, p = opts.fs, opts.period
    e_idx = torch.arange(opts.e_sub, dtype=torch.float32,
                         device=state.device)[None]
    e_steps = e_idx * p
    delta = st.carrier_freq / fs
    phase0 = (st.carrier_phase[:, None] + delta[:, None] * e_steps) % 1.0
    chips0 = (st.code_phase[:, None] + (st.code_dev / fs)[:, None]
              * e_steps + opts.nom_epoch_mod * e_idx)
    scale = p / CODE_LEN_CHIPS
    s0p = (chips0 % CODE_LEN_CHIPS) * scale
    s0e = ((chips0 + opts.corr_spacing) % CODE_LEN_CHIPS) * scale
    s0l = ((chips0 - opts.corr_spacing) % CODE_LEN_CHIPS) * scale
    par = torch.stack([phase0, delta[:, None].expand_as(phase0), s0p,
                       (s0e < s0p).to(torch.float32),
                       (s0l > s0p).to(torch.float32)], dim=-1)
    return par.transpose(0, 1)


def loop_update_plain(taps: Optional[torch.Tensor], state: torch.Tensor,
                      aid_offset: torch.Tensor,
                      par: Optional[torch.Tensor],
                      outs: Optional[torch.Tensor], s: int,
                      opts: LoopOpts) -> None:
    """Plain PyTorch version of :func:`loop_update` (float32, in place).

    The reference's scan body after its correlators
    (tpu_gnss/track/channel.py:441-541), arithmetic unchanged.
    """
    if taps is not None:
        two_pi = 2.0 * np.pi
        fs, p = opts.fs, opts.period
        step_len = p * opts.e_sub
        st = ChannelState(*state)
        t = taps.transpose(0, 1)                     # [n_chan, e_sub, 6]
        ip_all, qp_all = t[..., 0], t[..., 1]
        e_mag_all = torch.hypot(t[..., 2], t[..., 3])
        l_mag_all = torch.hypot(t[..., 4], t[..., 5])
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
        dll_err = opts.corr_spacing * (e_mag - l_mag) / denom

        # --- loop filters: freq = seed + k1*e + acc ------------------------
        # strong-signal AGC: halved Costas gain while agc_on (the decision
        # is one step delayed, as the reference's 4 Hz CheckPower poll)
        if opts.agc_thresholds is not None:
            pll_err = pll_err * torch.where(st.agc_on > 0.5, 0.5, 1.0)
        act = st.active > 0.5
        pll_acc = st.pll_acc + torch.where(
            act, opts.pll_k2 * pll_err + opts.fll_k2pi * fll_err, 0.0)
        carrier_freq = torch.where(
            act, st.carrier_seed + (opts.pll_k1 * pll_err + pll_acc)
            / two_pi, st.carrier_freq)
        dll_acc = st.dll_acc + torch.where(act, opts.dll_k2 * dll_err, 0.0)
        aid = ((carrier_freq - aid_offset) / L1_HZ * CHIP_RATE_HZ
               if opts.carrier_aiding else torch.zeros_like(carrier_freq))
        code_dev = torch.where(act, aid + opts.dll_k1 * dll_err + dll_acc,
                               st.code_dev)

        # --- NCO phase advance ---------------------------------------------
        carrier_phase = torch.where(
            act, (st.carrier_phase + carrier_freq / fs * step_len) % 1.0,
            st.carrier_phase)
        code_phase = torch.where(
            act, (st.code_phase + code_dev / fs * step_len
                  + opts.nom_step_mod) % CODE_LEN_CHIPS, st.code_phase)
        pwr = (ip_all * ip_all + qp_all * qp_all).mean(1)
        pwr_avg = torch.where(act, 0.875 * st.pwr_avg + 0.125 * pwr,
                              st.pwr_avg)
        agc_on = st.agc_on
        if opts.agc_thresholds is not None:
            agc_lo, agc_hi = opts.agc_thresholds
            agc_on = torch.where(
                act, torch.where(pwr_avg > agc_hi, 1.0,
                                 torch.where(pwr_avg < agc_lo, 0.0,
                                             st.agc_on)), st.agc_on)

        # per-epoch outputs, rows s*e_sub ... of [7, n_steps*e_sub, n_chan]
        e_idx = torch.arange(opts.e_sub, dtype=torch.float32,
                             device=state.device)[None]
        bcast = lambda a: a[:, None].expand_as(ip_all)
        phase_per_epoch = (st.code_phase[:, None] + (code_dev / fs)[:, None]
                           * (e_idx * p) + opts.nom_epoch_mod * e_idx
                           ) % CODE_LEN_CHIPS
        outs[:, s * opts.e_sub:(s + 1) * opts.e_sub] = torch.stack(
            [ip_all, qp_all, e_mag_all, l_mag_all, bcast(carrier_freq),
             bcast(code_dev), phase_per_epoch]).transpose(1, 2)
        state.copy_(torch.stack([
            st.active, carrier_phase, st.carrier_seed, code_phase, pll_acc,
            dll_acc, carrier_freq, code_dev, pwr_avg,
            torch.where(act, ip, st.ip_prev),
            torch.where(act, qp, st.qp_prev), agc_on]))
    if par is not None:
        par.copy_(step_params(state, opts))


# loop_update's launch: blocks of up to LOOP_BLOCK_THREADS threads, one
# per (channel, epoch), unless one channel's epochs need more; a block
# takes at most LOOP_MAX_THREADS (the card's limit)
LOOP_BLOCK_THREADS = 256
LOOP_MAX_THREADS = 1024


def loop_geometry(n_chan: int, e_sub: int) -> tuple[int, int, int, int]:
    """``(chans_per_block, blocks, threads, smem_bytes)`` of the
    ``loop_update`` launch for ``n_chan`` channels of ``e_sub`` epochs.

    A block covers ``chans_per_block`` = C channels x ``e_sub`` epochs,
    one thread per (channel, epoch), thread ``e*C + c`` for channel
    ``blockIdx*C + c`` (threads past ``n_chan`` idle); the blocks are
    balanced.  Shared memory: the block's taps (6 floats per thread) and
    7 floats per channel, within the default 48 KB.  A pure function of
    its arguments, so a captured graph replays the same launch.  Raises
    ``ValueError`` where one channel's epochs exceed a block.
    """
    if n_chan < 1 or e_sub < 1:
        raise ValueError(f"loop_update: n_chan {n_chan} and e_sub {e_sub} "
                         "must be positive")
    if e_sub > LOOP_MAX_THREADS:
        raise ValueError(f"loop_update: e_sub {e_sub} needs more than "
                         f"{LOOP_MAX_THREADS} threads for one channel")
    cap = max(1, LOOP_BLOCK_THREADS // e_sub)
    blocks = -(-n_chan // cap)
    chans = -(-n_chan // blocks)
    return chans, blocks, chans * e_sub, 4 * chans * (6 * e_sub + 7)


def _loop_check(taps, state, aid_offset, par, outs, s, opts) -> None:
    e_sub = opts.e_sub
    if state.ndim != 2 or state.shape[0] != len(ChannelState._fields):
        raise ValueError(f"state must be [{len(ChannelState._fields)}, "
                         f"n_chan], got {tuple(state.shape)}")
    n_chan = state.shape[1]
    shapes = (("taps", taps, (e_sub, n_chan, 6)),
              ("aid_offset", aid_offset, (1,)),
              ("par", par, (e_sub, n_chan, 5)))
    for name, a, shape in shapes:
        if a is not None and tuple(a.shape) != shape:
            raise ValueError(f"loop_update: {name} must be {list(shape)}, "
                             f"got {tuple(a.shape)}")
    if taps is not None:
        if (outs is None or outs.ndim != 3
                or outs.shape[0] != len(EpochOut._fields)
                or outs.shape[2] != n_chan
                or not 0 <= s < outs.shape[1] // e_sub):
            raise ValueError(f"loop_update: outs must be [7, rows, "
                             f"{n_chan}] with step {s} inside it")


def loop_update(taps: Optional[torch.Tensor], state: torch.Tensor,
                aid_offset: torch.Tensor, par: Optional[torch.Tensor],
                outs: Optional[torch.Tensor], s: int,
                opts: LoopOpts) -> None:
    """One loop update of the channel bank, in place.

    Args:
      taps: ``[e_sub, n_chan, 6]`` float32 correlator output of the step
        as :func:`mxu_track.track_corr` gives it (prompt, early, late as
        re/im pairs); the gather correlator packs ``(ip, qp, |e|, 0, |l|,
        0)``.  None: only write ``par`` from ``state``.
      state: ``[12, n_chan]`` float32 packed state (:func:`pack_state`),
        updated in place.
      aid_offset: ``[1]`` float32, the oscillator offset that carrier
        aiding removes (a tensor, so that a captured graph reads the
        value of each replay).
      par: None, or ``[e_sub, n_chan, 5]`` float32 that receives the next
        step's :func:`step_params` from the updated state.
      outs: ``[7, n_steps*e_sub, n_chan]`` float32 EpochOut planes; step
        ``s`` writes rows ``s*e_sub`` to ``(s+1)*e_sub - 1``.

    A CPU tensor runs :func:`loop_update_plain`; a CUDA tensor launches
    ``csrc/loop_update.cu`` at :func:`loop_geometry` or raises.
    """
    dev = state.device
    if dev.type == "cpu":
        return loop_update_plain(taps, state, aid_offset, par, outs, s,
                                 opts)
    if dev.type != "cuda":
        raise ValueError(f"loop_update: unsupported device {dev}")
    _loop_check(taps, state, aid_offset, par, outs, s, opts)
    for name, a in (("taps", taps), ("state", state),
                    ("aid_offset", aid_offset), ("par", par),
                    ("outs", outs)):
        if a is not None and (a.device != dev or a.dtype != torch.float32
                              or not a.is_contiguous()):
            raise ValueError(f"loop_update: {name} must be a contiguous "
                             f"float32 tensor on {dev}")
    geometry = loop_geometry(state.shape[1], opts.e_sub)
    ptr = lambda a: None if a is None else a.data_ptr()
    agc = opts.agc_thresholds
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = kernels.lib().loop_update_launch(
            ptr(taps), state.data_ptr(), aid_offset.data_ptr(), ptr(par),
            ptr(outs), s, 0 if outs is None else outs.shape[1], opts.e_sub,
            state.shape[1], opts.period, int(opts.carrier_aiding),
            int(agc is not None), opts.fs, opts.pll_k1, opts.pll_k2,
            opts.dll_k1, opts.dll_k2, opts.fll_k2pi, opts.corr_spacing,
            opts.nom_step_mod, opts.nom_epoch_mod,
            opts.period / CODE_LEN_CHIPS, *(agc or (0.0, 0.0)), *geometry,
            stream)
    kernels.check("loop_update", err)
    kernels.launched("loop_update")


@cache.built_once(bound=8)
def _gather_tables(fs: float, e_sub: int, device: str) -> tuple:
    """The gather correlator's per-sample nominal chip index (reduced mod
    1023 in float64 before the float32 cast), sample index, and the wipe
    phasor's two index ramps, on ``device``."""
    p = int(round(fs * 1e-3))
    dev = torch.device(device)
    n_np = (np.arange(e_sub, dtype=np.float64)[:, None] * p
            + np.arange(p, dtype=np.float64)[None, :])
    nom_n = torch.from_numpy(((CHIP_RATE_HZ / fs) * n_np)
                             % CODE_LEN_CHIPS).to(torch.float32).to(dev)
    n_f = torch.from_numpy(n_np.astype(np.float32)).to(dev)
    wipe_nb = -(-p * e_sub // _WIPE_K)
    wipe_a = torch.arange(_WIPE_K, dtype=torch.float32, device=dev)
    wipe_b = torch.arange(wipe_nb, dtype=torch.float32, device=dev) * _WIPE_K
    return nom_n, n_f, wipe_a, wipe_b


def aid_tensor(aid_offset_hz: float, device) -> torch.Tensor:
    """``aid_offset_hz`` as the ``[1]`` float32 device tensor that
    :func:`loop_update` reads (a fill, not an upload)."""
    return torch.full((1,), float(aid_offset_hz), dtype=torch.float32,
                      device=device)


def track_packed(samples: torch.Tensor, state: torch.Tensor,
                 code_tables: Optional[torch.Tensor],
                 code_ffts: Optional[torch.Tensor],
                 aid_offset: torch.Tensor, opts: LoopOpts) -> torch.Tensor:
    """The step loop of :func:`track_epochs` on packed ``state`` (updated
    in place).  Returns the ``[7, n_steps*e_sub, n_chan]`` EpochOut
    planes.  Per step: the correlator, then :func:`loop_update`.  Nothing
    waits for the device, and once a shape's tables are cached (by its
    first call) nothing uploads: a CUDA graph can capture it."""
    dev = samples.device
    fs, p, e_sub = opts.fs, opts.period, opts.e_sub
    step_len = p * e_sub
    n_steps = samples.shape[0] // step_len
    n_chan = state.shape[1]
    outs = torch.empty(len(EpochOut._fields), n_steps * e_sub, n_chan,
                       dtype=torch.float32, device=dev)
    if n_steps == 0:
        return outs

    if code_ffts is not None:
        nf = code_ffts.shape[-1]
        n1, _ = split_nf(nf)
        u_rows = four_step_np(nf, p)["u_rows"]
        cw_r, cw_i = mxu_track.spec_planes(code_ffts, nf)
        dsamp = opts.corr_spacing * p / CODE_LEN_CHIPS
        blocks = samples[: n_steps * step_len].reshape(n_steps, e_sub, p)
        blocks = torch.nn.functional.pad(
            torch.view_as_real(blocks), (0, 0, 0, u_rows * n1 - p))
        blk_r = blocks[..., 0].reshape(n_steps, e_sub, u_rows, n1
                                       ).contiguous()
        blk_i = blocks[..., 1].reshape(n_steps, e_sub, u_rows, n1
                                       ).contiguous()
        par = torch.empty(e_sub, n_chan, 5, dtype=torch.float32, device=dev)
        loop_update(None, state, aid_offset, par, None, 0, opts)
        for s in range(n_steps):
            taps = mxu_track.track_corr(blk_r[s], blk_i[s], par, cw_r, cw_i,
                                        period=p, nf=nf, dsamp=dsamp)
            loop_update(taps, state, aid_offset, par, outs, s, opts)
        return outs

    blocks = samples[: n_steps * step_len].reshape(n_steps, step_len)
    nom_n, n_f, wipe_a, wipe_b = _gather_tables(fs, e_sub, str(dev))
    two_pi = 2.0 * np.pi
    ch_idx = torch.arange(n_chan, device=dev)[:, None, None]
    for s in range(n_steps):
        st = ChannelState(*state)
        delta = (st.carrier_freq / fs)[:, None]       # cycles/sample
        pha = (-two_pi) * ((delta * wipe_a[None, :]) % 1.0)
        phb = (-two_pi) * ((st.carrier_phase[:, None]
                            + delta * wipe_b[None, :]) % 1.0)
        ea = torch.complex(torch.cos(pha), torch.sin(pha))
        eb = torch.complex(torch.cos(phb), torch.sin(phb))
        lo = (eb[:, :, None] * ea[:, None, :]).reshape(n_chan, -1)[
            :, :step_len]
        wiped = (blocks[s][None, :] * lo).reshape(-1, e_sub, p)
        chips_t = (st.code_phase[:, None, None]
                   + (st.code_dev / fs)[:, None, None] * n_f[None]
                   + nom_n[None])

        def corr(offset):
            idx = (torch.floor(chips_t + offset).to(torch.int64)
                   % CODE_LEN_CHIPS)
            return (wiped * code_tables[ch_idx, idx]).sum(-1)

        cp = corr(0.0)
        zero = torch.zeros_like(cp.real)
        taps = torch.stack(
            [cp.real, cp.imag, corr(opts.corr_spacing).abs(), zero,
             corr(-opts.corr_spacing).abs(), zero], dim=-1)
        loop_update(taps.transpose(0, 1).contiguous(), state, aid_offset,
                    None, outs, s, opts)
    return outs


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
    opts = loop_opts(fs=fs, pll_gains=pll_gains, dll_gains=dll_gains,
                     fll_bn_hz=fll_bn_hz, corr_spacing=corr_spacing,
                     carrier_aiding=carrier_aiding,
                     epochs_per_step=epochs_per_step,
                     agc_thresholds=agc_thresholds)
    packed = pack_state(state)
    outs = track_packed(samples, packed, code_tables, code_ffts,
                        aid_tensor(aid_offset_hz, samples.device), opts)
    return unpack_state(packed), EpochOut(*outs)


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
