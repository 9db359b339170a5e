"""Folded acquisition through the fused correlate-reduce kernel.

Counterpart of the fused-kernel engine of :mod:`tpu_gnss.acquire.folded`
(``_fold_maker``, ``_corr_reduce_grid_mxu``, ``acquire_refined_mxu``,
``_refine_from_centers`` and ``FoldedSearcher.detections_refined_fast``).

1. Exact Doppler wipe-off + coherent fold onto one code period, as one
   small complex matmul per block (phase is additive over periods).
2. :func:`tpu_gnss_torch.ops.mxu_corr.fold_corr_reduce` reduces the
   (Doppler x SV) grid to peak / first-max lag / total per cell, with
   non-coherent accumulation over blocks inside the kernel.
3. A ±2-bin window around every SV's best Doppler is re-correlated with
   ``torch.fft`` and parabola-refined (sub-bin Doppler, sub-sample code
   phase), ending in one ``[3, n_sv]`` host fetch.

SNR = peak / mean power over the P lags of one code period, the
reference's detector statistic.  The XLA grid engine (``power_grid``,
``reduce_grid``, ``refine_peak``) is not ported yet.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from tpu_gnss.config import ReceiverConfig
from tpu_gnss.signal import cacode

from ..device import full_precision_matmul, resolve_device
from ..ops.mxu_corr import (fold_code_planes_T, fold_corr_reduce,
                            four_step_np, split_nf)
from .search import mix_baseband


@functools.lru_cache(maxsize=8)
def period_replicas_np(fs: float, prns: tuple[int, ...]) -> np.ndarray:
    """``[n_sv, P]`` one-period bipolar replicas, P = fs/1000
    (tpu_gnss/acquire/folded.py:48-53)."""
    p = int(fs / 1000)
    chips = cacode.code_table()[np.array(prns) - 1]
    return cacode.resample(chips, fs, p)


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


def _corr_reduce_grid_mxu(iq_blocks: torch.Tensor, cw_r: torch.Tensor,
                          cw_i: torch.Tensor, dops_hz: torch.Tensor, *,
                          fs: float, n_coherent: int, period: int,
                          nf: int):
    """Wipe/fold + fused correlate-reduce over ALL Doppler rows in one
    launch, the B blocks summed non-coherently in the kernel.

    Returns ``(peak, lag, tot)`` each ``[n_sv, n_dop]``.  The reference
    walked Doppler chunks with ``lax.map`` to bound TPU memory
    (tpu_gnss/acquire/folded.py:289-339); the results are the same.
    """
    n1, _ = split_nf(nf)
    u_rows = four_step_np(nf, period)["u_rows"]
    b = iq_blocks.shape[0]
    n_dop = dops_hz.shape[0]
    x = _fold_maker(iq_blocks, fs=fs, n_coherent=n_coherent,
                    period=period)(dops_hz)                     # [B, d, P]
    x = torch.nn.functional.pad(torch.view_as_real(x),
                                (0, 0, 0, u_rows * n1 - period))
    x = x.transpose(0, 1).reshape(n_dop, b, u_rows, n1, 2)
    pk, lg, tt = fold_corr_reduce(
        x[..., 0].contiguous(), x[..., 1].contiguous(), cw_r, cw_i,
        period=period, nf=nf)
    return pk.T, lg.T, tt.T


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
    iq = (mix_baseband(samples, lo_rate) if from_bits
          else samples.to(torch.complex64))
    block = n_coherent * period
    blocks = iq[: n_noncoherent * block].reshape(n_noncoherent, block)
    pk, _, tt = _corr_reduce_grid_mxu(blocks, cw_r, cw_i, dops_hz, fs=fs,
                                      n_coherent=n_coherent, period=period,
                                      nf=nf)
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
    lin = torch.fft.ifft(code_ffts_p[None, :, None, :] * f.conj(), dim=-1)
    corr = (lin[..., :period] if nf == period
            else lin[..., :period] + lin[..., nf - period:])
    pwr = (corr.real ** 2 + corr.imag ** 2).sum(0)             # [sv, 5, P]

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
        self._code_ffts = None
        self._cw_planes = None

    def _spectra_np(self) -> np.ndarray:
        reps = period_replicas_np(self.cfg.fs, tuple(self.cfg.prns))
        return np.fft.fft(reps.astype(np.float64), n=self.nf, axis=-1)

    @property
    def code_ffts_p(self) -> torch.Tensor:
        """``[n_sv, NF]`` complex64 replica spectra on the device (built
        in float64 on the host, once per searcher)."""
        if self._code_ffts is None:
            self._code_ffts = torch.from_numpy(
                self._spectra_np().astype(np.complex64)).to(self.device)
        return self._code_ffts

    def mxu_code_planes(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Wrapped code-spectrum planes ``[n_sv*n2, n1]`` for the kernel."""
        if self._cw_planes is None:
            split_nf(self.nf)   # raises a clear error for an unfactorable NF
            cr, ci = fold_code_planes_T(self._spectra_np(), self.period)
            self._cw_planes = (torch.from_numpy(cr).to(self.device),
                               torch.from_numpy(ci).to(self.device))
        return self._cw_planes

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
        return self._dets_from_stack(stacked.cpu().numpy(), skip_prns,
                                     n_noncoherent)

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
