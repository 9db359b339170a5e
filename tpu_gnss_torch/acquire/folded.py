"""Folded acquisition: the FFT grid engine and the fused-kernel engine.

Counterpart of :mod:`tpu_gnss.acquire.folded`.

1. Exact Doppler wipe-off + coherent fold onto one code period, as one
   small complex matmul per block (phase is additive over periods).
2. Either engine correlates every (SV, Doppler) pair of the grid:

   * the grid engine (``fold_power_grid_batch``, ``acquire_folded``,
     ``reduce_grid``; ``FoldedSearcher.acquire(engine="xla")`` and
     ``power_grid``) with ``torch.fft`` in Doppler chunks of
     :data:`DOP_CHUNK`, materializing the ``[n_sv, n_dop, P]`` power grid;
   * the kernel engine (``_corr_reduce_grid_mxu``,
     ``acquire_folded_batch_mxu``, ``acquire_refined_mxu``;
     ``engine="mxu"``) through
     :func:`tpu_gnss_torch.ops.mxu_corr.fold_corr_reduce`, which reduces
     the grid to peak / first-max lag / total per cell inside the kernel.

3. ``refine_peak`` (host, from a grid) or ``_refine_from_centers``
   (device, a ±2-bin window around each SV's best Doppler) refine to
   sub-bin Doppler and sub-sample code phase.

``acquire_folded_packed`` starts from packed 1-bit words, mixed on the
device by :func:`tpu_gnss_torch.ops.onebit.mix_packed` (kernel 3 on a
card).  SNR = peak / mean power over the P lags of one code period, the
reference's detector statistic.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import cache
from ..config import ReceiverConfig
from ..device import full_precision_matmul, resolve_device
from ..ops.mxu_corr import (fold_code_planes_T, fold_corr_reduce,
                            four_step_np, split_nf)
from ..ops.onebit import mix_packed, pack_bits_to_words, words_to_tensor
from ..signal import cacode
from ..utils.metrics import METRICS
from .search import mix_baseband

# Doppler rows per FFT batch of the grid engine (the reference's default
# dop_chunk); bounds the [B, n_sv, chunk, NF] spectra, results do not
# depend on it.
DOP_CHUNK = 64


class FoldedResult(NamedTuple):
    """Per-SV best over the Doppler grid (tensors ``[..., n_sv]``)."""
    snr: torch.Tensor          # peak/avg power at best Doppler
    doppler_hz: torch.Tensor   # best Doppler, Hz (float32)
    ca_shift: torch.Tensor     # code phase advance, samples in [0, P)


@functools.lru_cache(maxsize=8)
def period_replicas_np(fs: float, prns: tuple[int, ...]) -> np.ndarray:
    """``[n_sv, P]`` one-period bipolar replicas, P = fs/1000
    (tpu_gnss/acquire/folded.py:48-53)."""
    p = int(fs / 1000)
    chips = cacode.code_table()[np.array(prns) - 1]
    return cacode.resample(chips, fs, p)


@functools.lru_cache(maxsize=2)
def replica_spectra_np(fs: float, prns: tuple[int, ...], nf: int
                       ) -> np.ndarray:
    """``[n_sv, NF]`` float64 replica spectra on the host, the source of
    both device tables; the last two kept, so that the tables of one key
    come from one FFT."""
    return np.fft.fft(period_replicas_np(fs, prns).astype(np.float64),
                      n=nf, axis=-1)


# the search's device tables, by key, for the process: a fresh Receiver
# or FoldedSearcher must not rebuild and upload them (the reference's
# _code_ffts_device / _mxu_code_planes_device, tpu_gnss/acquire/
# folded.py:61-85); the least recently used beyond TABLE_KEYS is dropped,
# and acquire.table_builds counts each build
TABLE_KEYS = 16
_TABLES = cache.store()


def replica_spectra(device: torch.device, fs: float,
                    prns: tuple[int, ...], nf: int) -> torch.Tensor:
    """``[n_sv, NF]`` complex64 replica spectra on ``device``, cast from
    :func:`replica_spectra_np`; built once per process and key and shared
    by every caller, so read only."""
    return cache.once(
        _TABLES, ("spectra", device, fs, prns, nf), lambda: torch.from_numpy(
            replica_spectra_np(fs, prns, nf).astype(np.complex64)).to(device),
        bound=TABLE_KEYS, counter="acquire.table_builds")


def code_planes(device: torch.device, fs: float, prns: tuple[int, ...],
                nf: int, period: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's wrapped code-spectrum planes ``[n_sv*n2, n1]`` float32
    on ``device`` (:func:`tpu_gnss_torch.ops.mxu_corr.fold_code_planes_T`
    of :func:`replica_spectra_np`); built once per process and key and
    shared by every caller, so read only.  An NF the kernel cannot factor
    raises."""
    def build():
        split_nf(nf)
        cr, ci = fold_code_planes_T(replica_spectra_np(fs, prns, nf), period)
        return torch.from_numpy(cr).to(device), torch.from_numpy(ci).to(device)
    return cache.once(_TABLES, ("planes", device, fs, prns, nf, period),
                      build, bound=TABLE_KEYS, counter="acquire.table_builds")


def fft_len_for_period(p: int) -> int:
    """Transform length for a period-P circular correlation
    (tpu_gnss/acquire/folded.py:96-112): P itself when 2/5-smooth, else
    the next power of two >= 2P-1 (the circular correlation is then
    recovered from the zero-padded linear one by wrapping)."""
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


def doppler_grid_hz(cfg: ReceiverConfig,
                    spacing_hz: Optional[float] = None) -> np.ndarray:
    """Doppler grid in Hz; default spacing matches the reference bins."""
    step = spacing_hz if spacing_hz is not None else cfg.dop_bin_hz
    m = int(cfg.max_fo / step)
    return (np.arange(-m, m + 1, dtype=np.float64) * step).astype(np.float32)


def noncoherent_threshold(t1: float, k: int) -> float:
    """Equal-false-alarm SNR threshold for a k-block accumulated grid
    (tpu_gnss/acquire/folded.py:123-152): the chi^2_{2k} tail matched to
    the k=1 threshold's per-cell false-alarm probability exp(-t1)."""
    if k <= 1:
        return float(t1)
    from scipy.stats import chi2
    return float(chi2.isf(math.exp(-float(t1)), 2 * k) / (2 * k))


# Near-far cross-correlation guard for accumulated (k>1) detections: a
# strong signal's C/A cross-correlation floor accumulates coherently, so
# detections more than ~13 dB below the sweep's strongest are inside that
# ambiguity (tpu_gnss/acquire/folded.py:155-182).
CROSS_GUARD = 1.0 / 20.0


def _near_far_ok(snr: float, snr_max: float, k: int) -> bool:
    return k <= 1 or snr >= snr_max * CROSS_GUARD


def _fold_maker(iq_blocks: torch.Tensor, *, fs: float, n_coherent: int,
                period: int):
    """Shared wipe-off/fold prologue.

    ``folded[f, m] = e_m[f, m] * Σ_c E[f, c] iq[cP + m]`` — the Σ_c is a
    ``[n_dop, NC] x [NC, P]`` complex matmul; ``e_m`` is built from
    K + P/K trig evaluations via the same phase split as the reference.
    Returns ``fold(dops [n_dop]) -> x [B, n_dop, P]``.
    """
    dev = iq_blocks.device
    b = iq_blocks.shape[0]
    n = n_coherent * period
    iqp = iq_blocks[:, :n].reshape(b, n_coherent, period)
    f32 = dict(dtype=torch.float32, device=dev)
    c_t = torch.arange(n_coherent, **f32) * (period / fs)
    K = 256
    njp = -(-period // K)
    i_t = torch.arange(K, **f32) / np.float32(fs)
    j_t = torch.arange(njp, **f32) * (K / fs)
    cis = lambda ph: torch.complex(torch.cos(ph), torch.sin(ph))

    def fold(dops):
        e_c = cis(-2.0 * np.pi * dops[:, None] * c_t[None, :])  # [d, NC]
        aa = cis(-2.0 * np.pi * dops[:, None] * i_t[None, :])   # [d, K]
        bb = cis(-2.0 * np.pi * dops[:, None] * j_t[None, :])   # [d, njp]
        e_m = (bb[:, :, None] * aa[:, None, :]).reshape(
            dops.shape[0], njp * K)[:, :period]                 # [d, P]
        base = torch.einsum("dc,bcm->bdm", e_c, iqp)            # [B, d, P]
        return e_m[None] * base

    return fold


def _baseband(samples: torch.Tensor, lo_rate: float,
              from_bits: bool) -> torch.Tensor:
    """{0,1} samples mixed to complex baseband (along the last axis, the
    LO phase starting at 0), or complex samples as complex64."""
    return (mix_baseband(samples, lo_rate) if from_bits
            else samples.to(torch.complex64))


def fold_power_grid_batch(iq_blocks: torch.Tensor,
                          code_ffts_p: torch.Tensor, dops_hz: torch.Tensor,
                          *, fs: float, n_coherent: int,
                          period: int) -> torch.Tensor:
    """Batched power grids ``[B, n_sv, n_dop, P]`` for B coherent blocks
    (tpu_gnss/acquire/folded.py:251-286).

    ``iq_blocks``: ``[B, >= n_coherent * P]`` complex baseband.
    ``code_ffts_p``: ``[n_sv, NF]`` replica spectra at the transform
    length from :func:`fft_len_for_period`.  The Doppler axis is walked in
    chunks of :data:`DOP_CHUNK` rows, which bounds the ``[B, n_sv, chunk,
    NF]`` spectrum product and its inverse FFT.
    """
    nf = code_ffts_p.shape[-1]
    fold = _fold_maker(iq_blocks, fs=fs, n_coherent=n_coherent,
                       period=period)
    out = []
    for c0 in range(0, dops_hz.shape[0], DOP_CHUNK):
        f = torch.fft.fft(fold(dops_hz[c0:c0 + DOP_CHUNK]), n=nf, dim=-1)
        out.append(_circ_power(code_ffts_p[None, :, None, :]
                               * f.conj()[:, None], period))
    return torch.cat(out, dim=2)                       # [B, sv, dop, P]


def _circ_power(prod: torch.Tensor, period: int) -> torch.Tensor:
    """|circular correlation|² over the P lags from a length-NF spectrum
    product: the padded linear correlation wrapped, circ[n] = lin[n] +
    lin[n - P] (tpu_gnss/acquire/folded.py:96-112)."""
    nf = prod.shape[-1]
    lin = torch.fft.ifft(prod, dim=-1)
    corr = (lin[..., :period] if nf == period
            else lin[..., :period] + lin[..., nf - period:])
    return corr.real ** 2 + corr.imag ** 2


def fold_power_grid(iq: torch.Tensor, code_ffts_p: torch.Tensor,
                    dops_hz: torch.Tensor, *, fs: float, n_coherent: int,
                    period: int) -> torch.Tensor:
    """Power grid ``[n_sv, n_dop, P]`` for one coherent block
    (tpu_gnss/acquire/folded.py:185-202)."""
    return fold_power_grid_batch(iq[None], code_ffts_p, dops_hz, fs=fs,
                                 n_coherent=n_coherent, period=period)[0]


def reduce_grid(pwr: torch.Tensor, dops_hz: torch.Tensor) -> FoldedResult:
    """Best (SNR, Doppler, lag) per SV from a ``[..., n_sv, n_dop, P]``
    power grid (tpu_gnss/acquire/folded.py:526-536).  Both argmaxes keep
    the first maximum, as the reference's."""
    p = pwr.shape[-1]
    max_lag = pwr.argmax(dim=-1)                            # [.., sv, dop]
    snr = pwr.amax(dim=-1) / (pwr.sum(dim=-1) / p)
    best = snr.argmax(dim=-1)                               # [.., sv]
    return FoldedResult(_at(snr, best), dops_hz[best],
                        _at(max_lag, best).to(torch.int32))


def _at(a: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """``a[..., best]`` per leading index: the value at each SV's best
    Doppler."""
    return torch.gather(a, -1, best[..., None])[..., 0]


def _power_grid_sum(samples: torch.Tensor, code_ffts_p: torch.Tensor,
                    dops_hz: torch.Tensor, *, fs: float, lo_rate: float,
                    n_coherent: int, n_noncoherent: int, from_bits: bool,
                    period: int) -> torch.Tensor:
    """Power grid summed non-coherently over ``n_noncoherent`` consecutive
    blocks (tpu_gnss/acquire/folded.py:539-561)."""
    iq = _baseband(samples, lo_rate, from_bits)
    block = n_coherent * period
    pwr = None
    for b in range(n_noncoherent):
        g = fold_power_grid(iq[b * block:(b + 1) * block], code_ffts_p,
                            dops_hz, fs=fs, n_coherent=n_coherent,
                            period=period)
        pwr = g if pwr is None else pwr + g
    return pwr


def acquire_folded(samples: torch.Tensor, code_ffts_p: torch.Tensor,
                   dops_hz: torch.Tensor, *, fs: float, lo_rate: float,
                   n_coherent: int, n_noncoherent: int = 1,
                   from_bits: bool = False, period: int) -> FoldedResult:
    """Grid-engine acquisition: mix -> fold blocks -> power grid sum ->
    reduce (tpu_gnss/acquire/folded.py:564-584)."""
    pwr = _power_grid_sum(samples, code_ffts_p, dops_hz, fs=fs,
                          lo_rate=lo_rate, n_coherent=n_coherent,
                          n_noncoherent=n_noncoherent, from_bits=from_bits,
                          period=period)
    return reduce_grid(pwr, dops_hz)


def acquire_folded_batch(samples: torch.Tensor, code_ffts_p: torch.Tensor,
                         dops_hz: torch.Tensor, *, fs: float, lo_rate: float,
                         n_coherent: int, from_bits: bool = False,
                         period: int) -> FoldedResult:
    """Batched block acquisition: ``samples [B, block_len]`` -> per-block
    FoldedResult with ``[B, n_sv]`` fields
    (tpu_gnss/acquire/folded.py:477-495).  Each row is mixed with its LO
    phase starting at 0, as the reference mixes a batch."""
    iq = _baseband(samples, lo_rate, from_bits)
    pwr = fold_power_grid_batch(iq, code_ffts_p, dops_hz, fs=fs,
                                n_coherent=n_coherent, period=period)
    return reduce_grid(pwr, dops_hz)


def acquire_folded_packed(words: torch.Tensor, code_ffts_p: torch.Tensor,
                          dops_hz: torch.Tensor, *, n_bits: int, fs: float,
                          lo_rate: float, n_coherent: int,
                          n_noncoherent: int = 1,
                          period: int) -> FoldedResult:
    """Grid-engine acquisition straight from packed 1-bit words
    (tpu_gnss/acquire/folded.py:498-523).

    ``words``: int32 tensor of LSB-first uint32 patterns
    (:func:`tpu_gnss_torch.ops.onebit.words_to_tensor`).  They are
    unpacked and mixed by :func:`tpu_gnss_torch.ops.onebit.mix_packed`:
    the CUDA kernel on a card, the plain version on the CPU.
    """
    iq = mix_packed(words, n_bits=n_bits, lo_rate=lo_rate)
    return acquire_folded(iq, code_ffts_p, dops_hz, fs=fs, lo_rate=lo_rate,
                          n_coherent=n_coherent, n_noncoherent=n_noncoherent,
                          period=period)


def _corr_reduce_grid_mxu(iq_blocks: torch.Tensor, cw_r: torch.Tensor,
                          cw_i: torch.Tensor, dops_hz: torch.Tensor, *,
                          fs: float, n_coherent: int, period: int, nf: int,
                          accumulate: bool):
    """Wipe/fold + fused correlate-reduce over ALL Doppler rows in one
    launch (tpu_gnss/acquire/folded.py:289-339).

    ``accumulate=True``: the rows are the Doppler bins and the B blocks
    sum non-coherently in the kernel; returns ``(peak, lag, tot)`` each
    ``[n_sv, n_dop]``.  ``accumulate=False``: B*n_dop rows, one block
    each; returns each ``[B, n_sv, n_dop]``.  The reference walked
    Doppler chunks with ``lax.map`` to bound TPU memory; the results are
    the same.
    """
    n1, _ = split_nf(nf)
    u_rows = four_step_np(nf, period)["u_rows"]
    b = iq_blocks.shape[0]
    n_dop = dops_hz.shape[0]
    x = _fold_maker(iq_blocks, fs=fs, n_coherent=n_coherent,
                    period=period)(dops_hz)                     # [B, d, P]
    x = torch.nn.functional.pad(torch.view_as_real(x),
                                (0, 0, 0, u_rows * n1 - period))
    x = (x.transpose(0, 1).reshape(n_dop, b, u_rows, n1, 2) if accumulate
         else x.reshape(b * n_dop, 1, u_rows, n1, 2))
    out = fold_corr_reduce(
        x[..., 0].contiguous(), x[..., 1].contiguous(), cw_r, cw_i,
        period=period, nf=nf)                                   # [rows, sv]
    if accumulate:
        return tuple(a.T for a in out)
    return tuple(a.reshape(b, n_dop, -1).transpose(1, 2) for a in out)


def acquire_folded_batch_mxu(samples: torch.Tensor, cw_r: torch.Tensor,
                             cw_i: torch.Tensor, dops_hz: torch.Tensor, *,
                             fs: float, lo_rate: float, n_coherent: int,
                             from_bits: bool = False, period: int, nf: int,
                             accumulate: bool = False) -> FoldedResult:
    """Batched folded acquisition through the fused kernel
    (tpu_gnss/acquire/folded.py:342-378).

    ``samples [B, block_len]`` (each row mixed with its LO phase starting
    at 0, as the reference mixes a batch); ``cw_r/cw_i`` from
    :func:`tpu_gnss_torch.ops.mxu_corr.fold_code_planes_T`.  Returns
    FoldedResult fields ``[B, n_sv]``; with ``accumulate=True`` the B
    blocks are successive blocks of one capture, summed non-coherently in
    the kernel, and the fields are ``[n_sv]``.
    """
    iq = _baseband(samples, lo_rate, from_bits)
    pk, lg, tt = _corr_reduce_grid_mxu(iq, cw_r, cw_i, dops_hz, fs=fs,
                                       n_coherent=n_coherent, period=period,
                                       nf=nf, accumulate=accumulate)
    snr = pk / (tt / period)
    best = snr.argmax(dim=-1)                          # first max wins
    return FoldedResult(_at(snr, best), dops_hz[best], _at(lg, best))


def acquire_refined_mxu(samples: torch.Tensor, cw_r: torch.Tensor,
                        cw_i: torch.Tensor, code_ffts_p: torch.Tensor,
                        dops_hz: torch.Tensor, *, fs: float, lo_rate: float,
                        n_coherent: int, n_noncoherent: int = 1,
                        from_bits: bool = False, period: int,
                        nf: int) -> torch.Tensor:
    """Kernel grid reduce + narrow-window refine
    (tpu_gnss/acquire/folded.py:381-419).

    Returns a stacked ``[3, n_sv]`` float32 tensor (snr, doppler_hz,
    ca_shift) on the samples' device.
    """
    iq = _baseband(samples, lo_rate, from_bits)
    block = n_coherent * period
    blocks = iq[: n_noncoherent * block].reshape(n_noncoherent, block)
    pk, _, tt = _corr_reduce_grid_mxu(blocks, cw_r, cw_i, dops_hz, fs=fs,
                                      n_coherent=n_coherent, period=period,
                                      nf=nf, accumulate=True)
    snr_grid = pk / (tt / period)                      # [sv, dop]
    centers = dops_hz[snr_grid.argmax(dim=-1)]         # first max wins
    return _refine_from_centers(blocks, code_ffts_p, centers, dops_hz,
                                fs=fs, n_coherent=n_coherent,
                                period=period, nf=nf)


def _refine_from_centers(blocks: torch.Tensor, code_ffts_p: torch.Tensor,
                         centers: torch.Tensor, dops_hz: torch.Tensor, *,
                         fs: float, n_coherent: int, period: int,
                         nf: int) -> torch.Tensor:
    """±2-bin window re-correlation + parabolic refine around per-SV
    Doppler ``centers`` (tpu_gnss/acquire/folded.py:422-474); returns
    stacked ``[3, n_sv]`` (snr, dop, ca)."""
    dev = blocks.device
    n_dop = dops_hz.shape[0]
    n_sv = code_ffts_p.shape[0]
    step = (dops_hz[1] - dops_hz[0]) if n_dop > 1 else torch.tensor(
        1.0, device=dev)
    offs = (torch.arange(5, dtype=torch.float32, device=dev) - 2.0) * step
    wdops = (centers[:, None] + offs[None, :]).reshape(-1)     # [sv*5]
    fold = _fold_maker(blocks, fs=fs, n_coherent=n_coherent, period=period)
    f = torch.fft.fft(fold(wdops), n=nf, dim=-1).reshape(-1, n_sv, 5, nf)
    pwr = _circ_power(code_ffts_p[None, :, None, :] * f.conj(),
                      period).sum(0)                           # [sv, 5, P]

    flat = pwr.reshape(n_sv, -1).argmax(dim=-1)
    d0 = flat // period                                        # window row
    l0 = flat % period                                         # lag

    def parabola(ym, y0, yp):
        den = ym - 2.0 * y0 + yp
        return torch.where(den < 0.0, 0.5 * (ym - yp)
                           / torch.where(den < 0.0, den, 1.0), 0.0)

    # Doppler parabola at the peak lag (edge rows keep the bin value)
    col = torch.gather(pwr, 2, l0[:, None, None].expand(n_sv, 5, 1))[..., 0]
    take_d = lambda di: torch.gather(
        col, 1, (d0 + di).clamp(0, 4)[:, None])[:, 0]
    dd = torch.where((d0 > 0) & (d0 < 4),
                     parabola(take_d(-1), take_d(0), take_d(1)), 0.0)
    # lag parabola with code-period wraparound
    row = torch.gather(pwr, 1,
                       d0[:, None, None].expand(n_sv, 1, period))[:, 0]
    take_l = lambda li: torch.gather(
        row, 1, ((l0 + li) % period)[:, None])[:, 0]
    y0 = take_l(0)
    dl = parabola(take_l(-1), y0, take_l(1))
    snr = y0 / (row.sum(dim=-1) / period)
    dop = centers + (d0.to(torch.float32) - 2.0 + dd) * step
    ca = (l0.to(torch.float32) + dl) % period
    return torch.stack([snr, dop, ca])


def refine_peak(pwr: np.ndarray, dops_hz: np.ndarray, sv_row: int
                ) -> dict:
    """Sub-bin Doppler / sub-sample code-phase refinement by parabolic
    interpolation around the power-grid peak (host numpy; copied from
    tpu_gnss/acquire/folded.py:587-621).

    Args:
      pwr: ``[n_sv, n_dop, P]`` grid from :meth:`FoldedSearcher.power_grid`
        (as a host array).
      dops_hz: matching Doppler grid.
      sv_row: SV row to refine.

    Returns dict with doppler_hz, ca_shift (float, samples), snr.
    """
    g = np.asarray(pwr[sv_row])
    n_dop, p = g.shape
    d0, l0 = np.unravel_index(np.argmax(g), g.shape)

    def parabola(ym, y0, yp):
        den = ym - 2.0 * y0 + yp
        return 0.0 if den >= 0 else 0.5 * (ym - yp) / den

    dd = 0.0
    if 0 < d0 < n_dop - 1:
        dd = parabola(g[d0 - 1, l0], g[d0, l0], g[d0 + 1, l0])
    dl = parabola(g[d0, (l0 - 1) % p], g[d0, l0], g[d0, (l0 + 1) % p])
    step = float(dops_hz[1] - dops_hz[0]) if n_dop > 1 else 0.0
    # degenerate (all-zero) grid row -> SNR 0, not a 0/0 warning
    tot = float(g[d0].sum()) / p
    snr = float(g[d0, l0] / tot) if tot > 0.0 else 0.0
    return dict(doppler_hz=float(dops_hz[d0]) + dd * step,
                ca_shift=(l0 + dl) % p, snr=snr)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class FoldedSearcher:
    """Folded acquisition engine on one device.

    Args:
      cfg: receiver configuration (fs, max_fo, threshold, prns).
      n_coherent: code periods per coherent fold.
      The Doppler grid step is the reference bin ``cfg.dop_bin_hz``
      capped at ``1000/n_coherent`` Hz (see
      tpu_gnss.acquire.folded.FoldedSearcher for the scalloping bound).
      device: where the search runs (explicit; nothing is inferred).
    """

    def __init__(self, cfg: ReceiverConfig, n_coherent: int = 4, *,
                 device):
        full_precision_matmul()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_coherent = n_coherent
        self.period = int(cfg.fs / 1000)
        self.block_len = self.period * n_coherent
        self.nf = fft_len_for_period(self.period)
        self.dops_hz = torch.from_numpy(doppler_grid_hz(
            cfg, min(cfg.dop_bin_hz, 1000.0 / n_coherent))).to(self.device)
        self._dops_pad = None     # (shards, padded grid) of the mesh search

    @property
    def code_ffts_p(self) -> torch.Tensor:
        """``[n_sv, NF]`` complex64 replica spectra on the device
        (:func:`replica_spectra`, the process's; read only)."""
        return replica_spectra(self.device, self.cfg.fs,
                               tuple(self.cfg.prns), self.nf)

    def mxu_code_planes(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Wrapped code-spectrum planes ``[n_sv*n2, n1]`` for the kernel
        (:func:`code_planes`, the process's; read only)."""
        return code_planes(self.device, self.cfg.fs, tuple(self.cfg.prns),
                           self.nf, self.period)

    def _prep(self, bits, iq, n_noncoherent: int):
        """Validate input length; return (samples on device, from_bits)."""
        need = n_noncoherent * self.block_len
        if bits is not None:
            samples = torch.from_numpy(
                np.ascontiguousarray(bits, dtype=np.uint8)).to(self.device)
            from_bits = True
        elif isinstance(iq, np.ndarray):
            samples = torch.from_numpy(
                np.ascontiguousarray(iq, dtype=np.complex64)).to(self.device)
            from_bits = False
        else:
            samples, from_bits = iq, False
        if samples.shape[-1] < need:
            raise ValueError(
                f"need {need} samples ({n_noncoherent} x {self.n_coherent} "
                f"periods of {self.period}), got {samples.shape[-1]}")
        return samples, from_bits

    def detections_refined_fast(self, bits=None, iq=None,
                                n_noncoherent: int = 1,
                                skip_prns=()) -> list[dict]:
        """Kernel detection + exact narrow-window refinement; one small
        ``[3, n_sv]`` host fetch.  ``n_noncoherent > 1`` sums that many
        consecutive coherent blocks' powers; ``skip_prns`` are filtered
        out of the result (already tracked)."""
        samples, from_bits = self._prep(bits, iq, n_noncoherent)
        cw_r, cw_i = self.mxu_code_planes()
        stacked = acquire_refined_mxu(
            samples, cw_r, cw_i, self.code_ffts_p, self.dops_hz,
            fs=self.cfg.fs, lo_rate=self.cfg.lo_rate,
            n_coherent=self.n_coherent, n_noncoherent=n_noncoherent,
            from_bits=from_bits, period=self.period, nf=self.nf)
        with METRICS.stage("acquire.fetch"):
            stacked = stacked.cpu().numpy()
        return self._dets_from_stack(stacked, skip_prns, n_noncoherent)

    def detections_refined_sharded(self, bits=None, iq=None,
                                   n_noncoherent: int = 1, skip_prns=(),
                                   *, mesh) -> list[dict]:
        """Mesh-sharded cold search, the decisions of
        :meth:`detections_refined_fast` (tpu_gnss/acquire/folded.py:
        831-863): the kernel grid reduce is Doppler-sharded over
        ``mesh.shape["dop"]`` and the refinement is the single-device
        arithmetic (:func:`tpu_gnss_torch.dist.shard.
        acquire_refined_sharded`).  The grid is padded to equal shards
        (the kernel engine walks no Doppler chunks), once per mesh
        shape."""
        from ..dist.shard import acquire_refined_sharded, pad_dops
        samples, from_bits = self._prep(bits, iq, n_noncoherent)
        cw_r, cw_i = self.mxu_code_planes()
        n_shards = mesh.shape["dop"]
        if self._dops_pad is None or self._dops_pad[0] != n_shards:
            padded = pad_dops(self.dops_hz.cpu().numpy(), n_shards, 1)
            self._dops_pad = (n_shards,
                              torch.from_numpy(padded).to(self.device))
        stacked = acquire_refined_sharded(
            samples, cw_r, cw_i, self.code_ffts_p, self._dops_pad[1],
            mesh=mesh, fs=self.cfg.fs, lo_rate=self.cfg.lo_rate,
            n_coherent=self.n_coherent, n_noncoherent=n_noncoherent,
            period=self.period, nf=self.nf, from_bits=from_bits)
        with METRICS.stage("acquire.fetch"):
            stacked = stacked.cpu().numpy()
        return self._dets_from_stack(stacked, skip_prns, n_noncoherent)

    def mxu_supported(self) -> bool:
        """True when the transform length factors for the kernel engine."""
        try:
            split_nf(self.nf)
            return True
        except ValueError:
            return False

    def power_grid(self, bits=None, iq=None,
                   n_noncoherent: int = 1) -> torch.Tensor:
        """``[n_sv, n_dop, P]`` power grid of one coherent block on the
        device; ``n_noncoherent > 1`` sums that many consecutive blocks'
        grids (weak-signal accumulation)."""
        samples, from_bits = self._prep(bits, iq, n_noncoherent)
        return _power_grid_sum(samples, self.code_ffts_p, self.dops_hz,
                               fs=self.cfg.fs, lo_rate=self.cfg.lo_rate,
                               n_coherent=self.n_coherent,
                               n_noncoherent=n_noncoherent,
                               from_bits=from_bits, period=self.period)

    def acquire(self, bits=None, iq=None, n_noncoherent: int = 1,
                engine: str = "xla") -> FoldedResult:
        """Search one capture segment; ``[n_sv]`` fields on the device.

        ``n_noncoherent > 1`` sums consecutive coherent blocks' powers
        before the peak search.  ``engine="xla"`` runs the FFT grid
        engine; ``engine="mxu"`` the fused correlate-reduce kernel
        (:func:`acquire_folded_batch_mxu` with ``accumulate=True``), which
        mixes each block with its LO phase starting at 0, as the
        reference's does.
        """
        samples, from_bits = self._prep(bits, iq, n_noncoherent)
        if engine == "mxu":
            cw_r, cw_i = self.mxu_code_planes()
            blocks = samples[: n_noncoherent * self.block_len].reshape(
                n_noncoherent, self.block_len)
            return acquire_folded_batch_mxu(
                blocks, cw_r, cw_i, self.dops_hz, fs=self.cfg.fs,
                lo_rate=self.cfg.lo_rate, n_coherent=self.n_coherent,
                from_bits=from_bits, period=self.period, nf=self.nf,
                accumulate=True)
        if engine != "xla":
            raise ValueError(f"engine must be 'xla' or 'mxu', got {engine!r}")
        return acquire_folded(samples, self.code_ffts_p, self.dops_hz,
                              fs=self.cfg.fs, lo_rate=self.cfg.lo_rate,
                              n_coherent=self.n_coherent,
                              n_noncoherent=n_noncoherent,
                              from_bits=from_bits, period=self.period)

    def acquire_packed(self, bits, n_noncoherent: int = 1) -> FoldedResult:
        """Grid-engine search of 1-D host {0,1} bits, packed here into
        LSB-first words (1/8 of the uint8 upload) and unpacked + mixed on
        the device by :func:`tpu_gnss_torch.ops.onebit.mix_packed`.

        The reference also took ``[n_rows, 128]`` bit-plane words, a
        layout made for the TPU's 128 lanes; the port does not take it,
        and a 2-D array raises ``ValueError``.
        """
        x = np.asarray(bits)
        if x.ndim != 1:
            raise ValueError("acquire_packed takes 1-D {0,1} bits; the TPU "
                             "bit-plane word layout is not supported")
        need = n_noncoherent * self.block_len
        if len(x) < need:
            raise ValueError(f"need {need} samples, got {len(x)}")
        words = words_to_tensor(pack_bits_to_words(x[:need]), self.device)
        return acquire_folded_packed(
            words, self.code_ffts_p, self.dops_hz, n_bits=need,
            fs=self.cfg.fs, lo_rate=self.cfg.lo_rate,
            n_coherent=self.n_coherent, n_noncoherent=n_noncoherent,
            period=self.period)

    def detections_refined(self, pwr,
                           n_noncoherent: int = 1) -> list[dict]:
        """Threshold + sub-bin refine straight from a ``[n_sv, n_dop, P]``
        power grid (tpu_gnss/acquire/folded.py:892-918), with the
        false-alarm-equalized threshold for ``n_noncoherent`` blocks."""
        thr = noncoherent_threshold(self.cfg.snr_threshold, n_noncoherent)
        pwr = _host(pwr)
        dops = _host(self.dops_hz)
        refs = [refine_peak(pwr, dops, i)
                for i in range(len(self.cfg.prns))]
        smax = max((r["snr"] for r in refs), default=0.0)
        out = []
        for prn, ref in zip(self.cfg.prns, refs):
            if ref["snr"] < thr:
                continue
            if not _near_far_ok(ref["snr"], smax, n_noncoherent):
                continue
            out.append(dict(prn=prn, sv=prn - 1, snr=ref["snr"],
                            doppler_hz=ref["doppler_hz"],
                            ca_shift=ref["ca_shift"],
                            lo_shift=int(round(ref["doppler_hz"]
                                               / self.cfg.dop_bin_hz))))
        return out

    def detections(self, res: FoldedResult,
                   n_noncoherent: int = 1) -> list[dict]:
        """Threshold a :class:`FoldedResult` (tpu_gnss/acquire/folded.py:
        920-936): integer ``ca_shift``, the same NaN-safe inclusion and
        near-far guard as :meth:`_dets_from_stack`."""
        dets = self._dets_from_stack(
            np.stack([_host(a).astype(np.float64) for a in res]),
            n_noncoherent=n_noncoherent)
        for d in dets:
            d["ca_shift"] = int(d["ca_shift"])
        return dets

    def _dets_from_stack(self, stacked: np.ndarray, skip_prns=(),
                         n_noncoherent: int = 1) -> list[dict]:
        """Threshold a ``[3, n_sv]`` (snr, dop, ca) stack
        (tpu_gnss/acquire/folded.py:865-890).  NaN SNRs (an all-zero
        head) never pass the threshold."""
        thr = noncoherent_threshold(self.cfg.snr_threshold, n_noncoherent)
        snr, dop, ca = stacked
        finite = snr[np.isfinite(snr)]
        smax = float(finite.max()) if finite.size else 0.0
        out = []
        for i, prn in enumerate(self.cfg.prns):
            if prn in skip_prns or not (snr[i] >= thr):
                continue
            if not _near_far_ok(float(snr[i]), smax, n_noncoherent):
                continue
            out.append(dict(prn=prn, sv=prn - 1, snr=float(snr[i]),
                            doppler_hz=float(dop[i]),
                            ca_shift=float(ca[i]),
                            lo_shift=int(round(float(dop[i])
                                               / self.cfg.dop_bin_hz))))
        return out
