"""Batched FFT acquisition (PCPS) with the reference's exact semantics.

Counterpart of :mod:`tpu_gnss.acquire.search` (tpu_gnss/acquire/search.py:
41-346) on ``torch.fft``; the JAX version is plain XLA, not Pallas, so the
port is plain tensor ops too.  The (PRN x Doppler) grid is

  pwr[s, d, n] = | IFFT_k( roll(conj(D), -d)[k] * C[s][k] ) [n] |^2

one gather of the data spectrum per Doppler bin (index ``(k + d) mod N``)
broadcast against the static ``[n_sv, N]`` code-spectrum table.  Doppler
is processed in chunks by a Python loop (the reference's ``lax.scan``)
with a running per-SV best carried across chunks.

Detection semantics match the reference exactly: power over the first
``floor(fs/1000)`` lags, SNR = peak/average power, padded bins masked to
-inf, the running best updated on ``>`` only, and the first maximum wins
in both Doppler scan order (-dop_max upward) and lag order
(reference: c/search_offline.cpp:176-201).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import ReceiverConfig
from ..device import resolve_device
from ..io.loaders import LO_TABLES
from ..signal import cacode


class AcqResult(NamedTuple):
    """Per-SV best over the Doppler grid.  Tensors are ``[n_sv]``."""
    snr: torch.Tensor       # peak/avg power at best Doppler
    lo_shift: torch.Tensor  # Doppler, FFT bins (Hz = lo_shift * fs / fft_len)
    ca_shift: torch.Tensor  # code phase, samples within one code period


# ---------------------------------------------------------------------------
# Replica table (copied from tpu_gnss/acquire/search.py:52-68)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def code_replicas_np(fs: float, fft_len: int,
                     prns: tuple[int, ...]) -> np.ndarray:
    """``[len(prns), fft_len]`` float32 bipolar C/A replicas sampled at fs.

    Replica construction matches the reference's SearchInit
    (reference: c/search_offline.cpp:74-110): bipolar chips resampled to fs
    with fractional-boundary interpolation.
    """
    chips = cacode.code_table()[np.array(prns) - 1]
    return cacode.resample(chips, fs, fft_len)


def code_fft_table_np(fs: float, fft_len: int,
                      prns: tuple[int, ...]) -> np.ndarray:
    """Host-side complex64 replica spectra (tests / CPU paths)."""
    return np.fft.fft(code_replicas_np(fs, fft_len, prns), axis=-1).astype(np.complex64)


def code_fft_table(cfg: ReceiverConfig, device) -> torch.Tensor:
    """``[n_sv, fft_len]`` complex64 replica spectra on ``device``.

    The FFT runs on the device from the float32 replicas: complex arrays
    never cross the host/device boundary (see tpu_gnss_torch.utils.xfer).
    """
    replicas = torch.from_numpy(
        code_replicas_np(cfg.fs, cfg.fft_len, cfg.prns)).to(device)
    return torch.fft.fft(replicas.to(torch.complex64), dim=-1)


# ---------------------------------------------------------------------------
# Device-side 1-bit mixing (fused front end)
# ---------------------------------------------------------------------------

def mix_baseband(bits: torch.Tensor, lo_rate: float,
                 variant: str = "offline",
                 phase0_quarters: float = 0.0) -> torch.Tensor:
    """Quadrature square-wave downconversion of {0,1} samples on device.

    Same math as :func:`tpu_gnss_torch.io.loaders.mix_1bit_block`
    (reference: c/search_offline.cpp:121-165) with the ``variant`` LO
    table ("offline" or "live").  ``bits`` may be ``[..., n]``.
    ``phase0_quarters``: LO phase of the first sample in quarter cycles,
    computed by callers on the host as ``(sample0 * lo_rate) % 4.0`` in
    float64 (exact for any capture length).
    """
    i_tbl, q_tbl = LO_TABLES[variant]
    dev = bits.device
    n = bits.shape[-1]
    i_lo = torch.arange(n, dtype=torch.int32, device=dev)
    phase = (_phase_mod4(i_lo, lo_rate)
             + torch.tensor(phase0_quarters, dtype=torch.float32)) % 4.0
    p = phase.to(torch.int64)
    s = (1 - 2 * bits.to(torch.int32)).to(torch.float32)
    itab = torch.from_numpy(1.0 - 2.0 * np.asarray(i_tbl, np.float32)).to(dev)
    qtab = torch.from_numpy(1.0 - 2.0 * np.asarray(q_tbl, np.float32)).to(dev)
    return torch.complex(s * itab[p], s * qtab[p])


PHASE_SPLIT = 4096   # K of _phase_mod4; csrc/mix_packed.cu uses the same


def _phase_mod4(i: torch.Tensor, lo_rate: float) -> torch.Tensor:
    """((i * lo_rate) mod 4) with float32-safe range reduction.

    Splits i = q*K + r (K = 4096) so each product stays small enough that
    float32 keeps the fractional phase accurate over multi-second blocks.
    """
    K = PHASE_SPLIT
    q, r = i // K, i % K
    part1 = (q.to(torch.float32)
             * torch.tensor((K * lo_rate) % 4.0, dtype=torch.float32)) % 4.0
    part2 = (r.to(torch.float32)
             * torch.tensor(lo_rate, dtype=torch.float32)) % 4.0
    return (part1 + part2) % 4.0


# ---------------------------------------------------------------------------
# Core grid search
# ---------------------------------------------------------------------------

def _doppler_bins(cfg: ReceiverConfig) -> np.ndarray:
    m = cfg.dop_max_bin
    return np.arange(-m, m + 1, dtype=np.int32)


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the FIRST maximum along the last axis (``jnp.argmax``'s
    tie-break), stated explicitly rather than left to the backend."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    # a NaN counts as the maximum, as in numpy and jnp.argmax
    hit = (x == x.amax(-1, keepdim=True)) | torch.isnan(x)
    return torch.where(hit, idx, n).amin(-1)


def _rolled(conj_d: torch.Tensor, dop_c: torch.Tensor) -> torch.Tensor:
    """``[..., chunk, N]``: ``roll(conj_d, -d)`` for each ``d`` of the
    chunk, one gather with index ``(k + d) mod N``."""
    n = conj_d.shape[-1]
    k = torch.arange(n, device=conj_d.device)
    idx = (k[None, :] + dop_c.to(torch.int64)[:, None]) % n   # [chunk, N]
    return conj_d[..., idx]


def _best_over_grid(prod_fn, n_rows: int, dops: torch.Tensor, *, lags: int,
                    dop_chunk: int) -> AcqResult:
    """Shared Doppler-grid scan: running best (SNR, dop, lag) per row.

    ``prod_fn(dop_c) -> [n_rows, chunk, N]`` builds the conjugated
    spectrum products for one chunk of Doppler bins; everything after —
    inverse FFT, the peak/avg SNR statistic over ``lags``, the
    first-max-wins tie-break and the ``>``-compare running best
    (reference: c/search_offline.cpp:169-201) — is identical for the
    full-grid and the paired engines and lives only here.
    """
    dev = dops.device
    n_dop = dops.shape[0]
    pad = (-n_dop) % dop_chunk
    # Padded bins replay the last real bin; their results are masked off.
    dops_p = torch.cat([dops, dops[-1:].expand(pad)])
    valid = torch.cat([torch.ones(n_dop, dtype=torch.bool, device=dev),
                       torch.zeros(pad, dtype=torch.bool, device=dev)])
    best_snr = torch.full((n_rows,), -torch.inf, dtype=torch.float32,
                          device=dev)
    best_dop = torch.zeros(n_rows, dtype=torch.int32, device=dev)
    best_lag = torch.zeros(n_rows, dtype=torch.int32, device=dev)
    rows = torch.arange(n_rows, device=dev)
    for c0 in range(0, n_dop + pad, dop_chunk):
        dop_c = dops_p[c0: c0 + dop_chunk]
        valid_c = valid[c0: c0 + dop_chunk]
        prod = prod_fn(dop_c)                       # [n_rows, chunk, N]
        corr = torch.fft.ifft(prod, dim=-1)[..., :lags]
        pwr = corr.real ** 2 + corr.imag ** 2       # [n_rows, chunk, lags]
        max_pwr = pwr.amax(-1)
        max_lag = _first_argmax(pwr).to(torch.int32)
        avg_pwr = pwr.sum(-1) / lags
        snr = torch.where(valid_c[None, :], max_pwr / avg_pwr, -torch.inf)
        # best within chunk (first max wins, matching scan order)
        c_arg = _first_argmax(snr)
        c_snr = snr[rows, c_arg]
        c_dop = dop_c[c_arg]
        c_lag = max_lag[rows, c_arg]
        upd = c_snr > best_snr
        best_snr = torch.where(upd, c_snr, best_snr)
        best_dop = torch.where(upd, c_dop, best_dop)
        best_lag = torch.where(upd, c_lag, best_lag)
    return AcqResult(best_snr, best_dop, best_lag)


def acquire_from_fft(data_fft: torch.Tensor, code_ffts: torch.Tensor,
                     dops: torch.Tensor, *, lags: int,
                     dop_chunk: int = 16) -> AcqResult:
    """Search the full (SV x Doppler) grid for one data block.

    Args:
      data_fft: ``[fft_len]`` complex64 forward FFT of the mixed block.
      code_ffts: ``[n_sv, fft_len]`` complex64 replica spectra.
      dops: ``[n_dop]`` int32 Doppler bin shifts, scanned in order
        (ties keep the earliest, matching the reference's ``>`` compare).
      lags: code-phase lags scored = floor(fs/1000).
      dop_chunk: Doppler bins per scan step (memory knob).
    """
    conj_d = data_fft.conj()
    return _best_over_grid(
        lambda dop_c: code_ffts[:, None, :] * _rolled(conj_d, dop_c)[None],
        code_ffts.shape[0], dops, lags=lags, dop_chunk=dop_chunk)


def acquire_bits_block(bits: torch.Tensor, code_ffts: torch.Tensor,
                       dops: torch.Tensor, *, lo_rate: float, lags: int,
                       dop_chunk: int = 16) -> AcqResult:
    """Fused front end: {0,1} IF bits -> mix -> FFT -> grid search."""
    data_fft = torch.fft.fft(mix_baseband(bits, lo_rate))
    return acquire_from_fft(data_fft, code_ffts, dops,
                            lags=lags, dop_chunk=dop_chunk)


def acquire_paired(data_ffts: torch.Tensor, code_ffts: torch.Tensor,
                   dops: torch.Tensor, *, lags: int,
                   dop_chunk: int = 16) -> AcqResult:
    """Diagonal variant: pair i searches data block i against code i.

    Reproduces the reference CLI's block consumption pattern, where the
    PRN sweep reads a fresh 40000-sample block per SV
    (reference: c/search_offline.cpp:239-246): batch the 32 per-run blocks
    and correlate block i with SV i only.

    Args: ``data_ffts``/``code_ffts`` are ``[B, fft_len]`` complex64.
    """
    conj_d = data_ffts.conj()                          # [B, N]
    return _best_over_grid(
        lambda dop_c: code_ffts[:, None, :] * _rolled(conj_d, dop_c),
        data_ffts.shape[0], dops, lags=lags, dop_chunk=dop_chunk)


def acquire_grid_pwr(data_fft: torch.Tensor, code_fft: torch.Tensor,
                     dops: torch.Tensor, *, lags: int) -> torch.Tensor:
    """Full ``[n_dop, lags]`` power map for one SV (diagnostics/tests)."""
    prod = _rolled(data_fft.conj(), dops) * code_fft[None, :]
    corr = torch.fft.ifft(prod, dim=-1)[:, :lags]
    return corr.real ** 2 + corr.imag ** 2


def _mix_fft_blocks(bits_blocks: torch.Tensor, lo_rate: float
                    ) -> torch.Tensor:
    """[B, N] {0,1} bits -> mixed -> per-block forward FFT (phase resets)."""
    return torch.fft.fft(mix_baseband(bits_blocks, lo_rate), dim=-1)


# ---------------------------------------------------------------------------
# High-level engine
# ---------------------------------------------------------------------------

class Searcher:
    """Acquisition engine bound to one capture configuration and device.

    Holds the device-resident replica spectrum table and Doppler grid and
    exposes block-level search.  The equivalent of the reference's
    SearchInit + SearchTask pair (reference: c/search_offline.cpp:74-110,
    219-292).  ``device`` is explicit: nothing is inferred, and a CUDA
    device without a card raises.
    """

    def __init__(self, cfg: ReceiverConfig, dop_chunk: Optional[int] = None,
                 *, device):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.code_ffts = code_fft_table(cfg, self.device)
        self.dops = torch.from_numpy(_doppler_bins(cfg)).to(self.device)
        if dop_chunk is None:
            # ~256 MB of complex64 per chunk buffer, clamped to the grid.
            budget = max(1, (256 << 20) // (len(cfg.prns) * cfg.fft_len * 8))
            dop_chunk = int(min(max(budget, 1), cfg.num_dop_bins))
        self.dop_chunk = dop_chunk

    # -- block level -------------------------------------------------------

    def _check_len(self, n: int) -> None:
        if n != self.cfg.fft_len:
            raise ValueError(
                f"block must have exactly fft_len={self.cfg.fft_len} samples, "
                f"got {n}; pad or re-block the capture")

    def _bits(self, bits) -> torch.Tensor:
        if isinstance(bits, torch.Tensor):
            return bits.to(self.device, torch.uint8)
        return torch.from_numpy(
            np.ascontiguousarray(bits, np.uint8)).to(self.device)

    def acquire_bits(self, bits) -> AcqResult:
        """Search one fft_len block of {0,1} IF samples (all PRNs)."""
        bits = self._bits(bits)
        self._check_len(bits.shape[-1])
        return acquire_bits_block(
            bits, self.code_ffts, self.dops, lo_rate=self.cfg.lo_rate,
            lags=self.cfg.lags, dop_chunk=self.dop_chunk)

    def acquire_iq(self, iq) -> AcqResult:
        """Search one fft_len block of complex baseband samples.

        ``iq`` may be a host numpy complex array (uploaded as float32
        planes — complex never crosses the host/device boundary) or a
        complex tensor on the device.
        """
        self._check_len(np.shape(iq)[-1])
        if isinstance(iq, np.ndarray):
            from ..utils.xfer import to_device_complex
            iq = to_device_complex(iq, self.device)
        data_fft = torch.fft.fft(iq.to(torch.complex64))
        return acquire_from_fft(data_fft, self.code_ffts, self.dops,
                                lags=self.cfg.lags, dop_chunk=self.dop_chunk)

    def acquire_bits_paired(self, bits_blocks) -> AcqResult:
        """Compat path: block i is searched against PRN ``prns[i]`` only.

        ``bits_blocks``: ``[n_sv, fft_len]`` {0,1} samples; the LO phase
        restarts at each block start (each reference Sample() call does,
        reference: c/search_offline.cpp:131).
        """
        bits_blocks = self._bits(bits_blocks)
        assert tuple(bits_blocks.shape) == (len(self.cfg.prns),
                                            self.cfg.fft_len)
        data_ffts = _mix_fft_blocks(bits_blocks, self.cfg.lo_rate)
        return acquire_paired(data_ffts, self.code_ffts, self.dops,
                              lags=self.cfg.lags, dop_chunk=self.dop_chunk)

    def detections(self, res: AcqResult) -> list[dict]:
        """Threshold an AcqResult into detection records (host-side)."""
        snr, lo, ca = (a.cpu().numpy() for a in res)
        out = []
        for i, prn in enumerate(self.cfg.prns):
            if snr[i] >= self.cfg.snr_threshold:
                out.append(dict(prn=prn, sv=prn - 1, snr=float(snr[i]),
                                lo_shift=int(lo[i]), ca_shift=int(ca[i]),
                                doppler_hz=float(lo[i]) * self.cfg.dop_bin_hz))
        return out
