"""Fused tracking correlator: wipe + DFT + E/P/L taps (kernel 2).

Counterpart of :mod:`tpu_gnss.ops.mxu_track`.  For every (1 ms epoch,
channel) pair: carrier wipe-off, forward four-step DFT of the
zero-padded epoch, product with the channel's conjugated wrap-folded code
spectrum (:func:`tpu_gnss_torch.track.channel.code_spectra_np`), then the
FFT-dot correlators

    corr(τ) = (1/NF) Σ_k W[k]·spec[k]·e^{-j2π k_eff τ/NF}

at the prompt lag τ, and at τ ± d through fixed tap vectors (the
``t(d ∓ P)`` pair applies where the early/late lag wraps around the code
period).  Reference semantics: 1 ms integrate-and-dump E/P/L
correlators of the FPGA channel design.

* On a CUDA tensor :func:`track_corr` launches ``csrc/track_corr.cu``,
  which runs the forward DFT on the tensor cores with TF32 operands and
  float32 accumulation, from the forward tables of
  :func:`tpu_gnss_torch.ops.mxu_corr.mma_tables` (the TPU kernel: bf16
  operands).
* On a CPU tensor it runs :func:`track_corr_plain`, the FFT-dot einsum
  formulation in float32 over the same float64 tables cast down.

Channels are taken as they are: no padding to kernel groups.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import cache, kernels
from .mxu_corr import four_step_np, mma_tables, split_nf, stage_smem


@functools.lru_cache(maxsize=8)
def dense_taps(nf: int, period: int, dsamp: float) -> np.ndarray:
    """``[4, n2, n1]`` complex128 early/late tap grids in the ``[k2, k1]``
    layout, ``t(d)[k2, k1] = e^{-j2π k_eff d/NF}`` for d = +d, +d-P, -d,
    -d+P (tpu_gnss/ops/mxu_track.py:82-93)."""
    keff = four_step_np(nf, period)["keff"]
    return np.stack([np.exp(-2j * np.pi * keff * (d / nf))
                     for d in (dsamp, dsamp - period, -dsamp,
                               -dsamp + period)])


@cache.built_once(bound=16)
def track_tables(nf: int, period: int, dsamp: float, device: str) -> tuple:
    """``(u_rows, f2, wt, f1, taps, keff)`` on ``device``: the forward
    four-step factors and tap grids as complex64, ``keff`` as int64, all
    derived from :func:`four_step_np` (tpu_gnss/ops/mxu_track.py:60-79)."""
    t = four_step_np(nf, period)
    dev = torch.device(device)
    c64 = lambda a: torch.from_numpy(
        np.ascontiguousarray(a, np.complex64)).to(dev)
    return (t["u_rows"], c64(t["f2"]), c64(t["wt"]), c64(t["f1"]),
            c64(dense_taps(nf, period, dsamp)),
            torch.from_numpy(t["keff"].astype(np.int64)).to(dev))


@cache.built_once(bound=16)
def tap_factors(nf: int, period: int, dsamp: float, device: str
                ) -> torch.Tensor:
    """``[4, n1 + n2 + 1]`` complex64 factors of the tap grids of
    :func:`dense_taps` (d = +d, +d-P, -d, -d+P) on ``device``, built in
    float64: ``e^{-j2π k1 d/n1}`` for every k1, ``e^{-j2π k2 d/NF}`` for
    every k2, then ``e^{+j2π d}``, so that ``t(d)[k2, k1]`` is the product
    of the k1 and k2 entries, times the last one where ``k1*n2 + k2 >=
    NF//2`` (keff = k - NF there).  ``csrc/track_corr.cu`` multiplies them
    into the ramp's own factors."""
    n1, n2 = split_nf(nf)
    k1, k2 = np.arange(n1), np.arange(n2)
    rows = [np.concatenate([np.exp(-2j * np.pi * k1 * (d / n1)),
                            np.exp(-2j * np.pi * k2 * (d / nf)),
                            [np.exp(2j * np.pi * d)]])
            for d in (dsamp, dsamp - period, -dsamp, -dsamp + period)]
    return torch.from_numpy(np.stack(rows).astype(np.complex64)).to(device)


def spec_planes(code_ffts: torch.Tensor, nf: int) -> tuple:
    """Per-channel spectra ``[n_chan, NF]`` -> ``[n_chan*n2, n1]`` float32
    planes (row ``c*n2 + k2``, column ``k1`` = bin ``k1*n2 + k2``)."""
    n1, n2 = split_nf(nf)
    n_chan = code_ffts.shape[0]
    st = code_ffts.reshape(n_chan, n1, n2).transpose(1, 2).reshape(
        n_chan * n2, n1)
    return st.real.contiguous(), st.imag.contiguous()


def frac_ramp(tau: torch.Tensor, keff: torch.Tensor, nf: int
              ) -> torch.Tensor:
    """``e^{-j2π k_eff τ/NF}`` for every τ (any shape) and bin.

    The phase is range-reduced exactly: with τ = τi + τf, the integer part
    ``(k_eff·τi mod NF)/NF`` is integer arithmetic and ``k_eff·τf/NF`` is
    under half a cycle, so float32 holds it to ~1e-7 cycles at any NF.
    """
    ti = torch.floor(tau)
    tf = (tau - ti)[..., None, None]
    m = (keff * ti.to(torch.int64)[..., None, None]) % nf
    ph = (m.to(torch.float32) / nf
          + keff.to(torch.float32) * tf / nf) % 1.0
    ang = (-2.0 * np.pi) * ph
    return torch.complex(torch.cos(ang), torch.sin(ang))


def _check(blk_r, params, cw_r, period: int, nf: int):
    n1, n2 = split_nf(nf)
    u_rows = four_step_np(nf, period)["u_rows"]
    if blk_r.ndim != 3 or tuple(blk_r.shape[1:]) != (u_rows, n1):
        raise ValueError(f"epoch planes must be [e_sub, {u_rows}, {n1}], "
                         f"got {tuple(blk_r.shape)}")
    e_sub = blk_r.shape[0]
    if params.ndim != 3 or params.shape[0] != e_sub or params.shape[2] != 5:
        raise ValueError(f"params must be [{e_sub}, n_chan, 5], "
                         f"got {tuple(params.shape)}")
    n_chan = params.shape[1]
    if tuple(cw_r.shape) != (n_chan * n2, n1):
        raise ValueError(f"code planes must be [{n_chan * n2}, {n1}], "
                         f"got {tuple(cw_r.shape)}")
    return e_sub, n_chan, n1, n2, u_rows


@functools.lru_cache(maxsize=16)
def track_smem(nf: int, period: int) -> int:
    """Dynamic shared memory of one ``csrc/track_corr.cu`` block: the
    forward stage pair's (:func:`stage_smem`, one item, up to 8 warps),
    the LO phasor tables ``lo_u [16*ceil(u_rows/16)]`` and ``lo_v
    [32*ceil(n1/32)]``, three lags' ramp factors ``[n1 + n2 + 1]`` and
    each thread's ``4*nq`` parked outputs (all complex64; nq out n-tiles
    a warp, as ``make_plan`` picks them)."""
    t = four_step_np(nf, period)
    n1, n2, u_rows = t["n1"], t["n2"], t["u_rows"]
    cdiv = lambda a, b: -(-a // b)
    nt = cdiv(n1, 8)
    runs = cdiv(nt, 8)
    nq = 2 * cdiv(cdiv(nt, runs), 2)
    tasks = cdiv(n2, 16) * runs
    threads = 32 * cdiv(tasks, cdiv(tasks, 8))
    return (stage_smem(n2, u_rows, n1, n1, planes=2)
            + 8 * (16 * cdiv(u_rows, 16) + 32 * cdiv(n1, 32)
                   + 3 * (n1 + n2 + 1) + 4 * nq * threads))


def track_corr_plain(blk_r: torch.Tensor, blk_i: torch.Tensor,
                     params: torch.Tensor, cw_r: torch.Tensor,
                     cw_i: torch.Tensor, *, period: int, nf: int,
                     dsamp: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`track_corr` (float32)."""
    e_sub, n_chan, n1, n2, u_rows = _check(blk_r, params, cw_r, period, nf)
    dev = blk_r.device
    _, f2, wt, f1, taps, keff = track_tables(nf, period, dsamp, str(dev))
    phase0, delta, tau = params[..., 0], params[..., 1], params[..., 2]
    two_pi = 2.0 * np.pi
    uu = torch.arange(u_rows, dtype=torch.float32, device=dev) * n1
    vv = torch.arange(n1, dtype=torch.float32, device=dev)
    au = -two_pi * ((phase0[..., None] + delta[..., None] * uu) % 1.0)
    av = -two_pi * ((delta[..., None] * vv) % 1.0)
    lo = (torch.complex(torch.cos(au), torch.sin(au))[..., :, None]
          * torch.complex(torch.cos(av), torch.sin(av))[..., None, :])
    y = torch.complex(blk_r, blk_i)[:, None] * lo      # [e, c, u, v]
    g = ((f2 @ y) * wt) @ f1                           # [e, c, k2, k1]
    w = (torch.complex(cw_r, cw_i).reshape(n_chan, n2, n1) * g
         * frac_ramp(tau, keff, nf))
    wrap_e = (params[..., 3] > 0.5)[..., None, None]
    wrap_l = (params[..., 4] > 0.5)[..., None, None]
    cp = w.sum((-2, -1)) / nf
    ce = (w * torch.where(wrap_e, taps[1], taps[0])).sum((-2, -1)) / nf
    cl = (w * torch.where(wrap_l, taps[3], taps[2])).sum((-2, -1)) / nf
    return torch.stack([cp.real, cp.imag, ce.real, ce.imag,
                        cl.real, cl.imag], dim=-1)


def track_corr(blk_r: torch.Tensor, blk_i: torch.Tensor,
               params: torch.Tensor, cw_r: torch.Tensor, cw_i: torch.Tensor,
               *, period: int, nf: int, dsamp: float = 0.0) -> torch.Tensor:
    """E/P/L correlators for every (epoch, channel).

    Args:
      blk_r/blk_i: ``[e_sub, u_rows, n1]`` float32 planes of the step's
        1 ms epochs, zero-padded P -> u_rows*n1 and reshaped row major.
      params: ``[e_sub, n_chan, 5]`` float32: phase0 (cycles), delta
        (cycles/sample), tau (samples, prompt lag in [0, P)), wrap_e,
        wrap_l.
      cw_r/cw_i: ``[n_chan*n2, n1]`` planes from :func:`spec_planes`.
      dsamp: early/late tap offset in samples.

    Returns ``[e_sub, n_chan, 6]`` float32: (prompt, early, late) as
    re/im pairs, scaled by 1/NF.  A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel or raises.
    """
    dev = blk_r.device
    if dev.type == "cpu":
        return track_corr_plain(blk_r, blk_i, params, cw_r, cw_i,
                                period=period, nf=nf, dsamp=dsamp)
    if dev.type != "cuda":
        raise ValueError(f"track_corr: unsupported device {dev}")
    e_sub, n_chan, n1, n2, u_rows = _check(blk_r, params, cw_r, period, nf)
    for name, a in (("blk_r", blk_r), ("blk_i", blk_i), ("params", params),
                    ("cw_r", cw_r), ("cw_i", cw_i)):
        if a.device != dev or a.dtype != torch.float32 \
                or not a.is_contiguous():
            raise ValueError(f"track_corr: {name} must be a contiguous "
                             f"float32 tensor on {dev}")
    if blk_i.shape != blk_r.shape or cw_i.shape != cw_r.shape:
        raise ValueError("track_corr: real/imag plane shapes differ")
    if n2 * nf >= 2 ** 31:
        raise ValueError(f"track_corr: NF={nf} is too long for the "
                         "kernel's int32 ramp reduction (n2*NF < 2^31)")
    if track_smem(nf, period) > kernels.SMEM_LIMIT:
        raise ValueError(f"track_corr: NF={nf} needs more shared memory "
                         "than a Hopper block has")
    fwd = mma_tables(nf, period, str(dev))[0]
    tapf = tap_factors(nf, period, dsamp, str(dev))
    out = torch.empty(e_sub, n_chan, 6, dtype=torch.float32, device=dev)
    ptrs = [a.data_ptr() for a in (blk_r, blk_i, params, cw_r, cw_i, *fwd,
                                   tapf, out)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = kernels.lib().track_corr_launch(
            *ptrs, e_sub, n_chan, n1, n2, u_rows, nf, stream)
    kernels.check("track_corr", err)
    kernels.launched("track_corr")
    return out
