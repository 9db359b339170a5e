"""Fused DFT-correlate-reduce for folded acquisition (kernel 1).

Counterpart of :mod:`tpu_gnss.ops.mxu_corr`.  ``NF = n1*n2`` is factored
for the four-step DFT

    corr[n1*q + t] = (E1 @ M * tw) @ E2   at cell [t, q]

and :func:`fold_corr_reduce` reduces each (Doppler row, SV) pair to the
three numbers acquisition needs — peak power, first-max lag and total
power over the P valid lags — without materializing the power grid.

* On a CUDA tensor it launches the hand-written kernel in
  ``csrc/fold_corr_reduce.cu``.
* On a CPU tensor it runs :func:`fold_corr_reduce_plain`, the same
  arithmetic as float32 PyTorch matmuls over the same tables.

Unlike the TPU kernel's bf16 planes, the port keeps the code planes and
all products in float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels


def split_nf(nf: int) -> tuple[int, int]:
    """Factor NF = n1 * n2 (copied from tpu_gnss/ops/mxu_corr.py:59-73).

    Prefers n2 = 128, else a near-square factorization; raises if NF has
    no usable factorization (every preset's NF factors).
    """
    if nf % 128 == 0:
        return nf // 128, 128
    r = int(np.sqrt(nf))
    while r > 1:
        if nf % r == 0:
            return nf // r, r
        r -= 1
    raise ValueError(f"NF={nf} has no usable factorization")


def wrap_spectrum(c: np.ndarray, period: int) -> np.ndarray:
    """Fold the circular wrap of the padded linear correlation into a
    spectrum: ``C[k] * (1 + e^{-j2πkP/NF})`` (no-op when NF == P).
    Copied from tpu_gnss/ops/mxu_corr.py:93-102."""
    nf = c.shape[-1]
    if nf != period:
        k = np.arange(nf)
        c = c * (1.0 + np.exp(-2j * np.pi * k * (period / nf)))
    return c


@functools.lru_cache(maxsize=8)
def four_step_np(nf: int, period: int) -> dict:
    """Float64 four-step DFT factor tables, the single source of the index
    maps (copied from tpu_gnss/ops/mxu_corr.py:185-217).

    Spectrum index ``k = k1*n2 + k2``; time index ``n = n1*u + v``; lag
    ``lag = n1*q + t``.  Only ``u < u_rows`` input rows are nonzero and
    only ``q < q_cols`` output columns hold lags inside one code period.
    ``keff`` is the signed-frequency grid in ``[k2, k1]`` layout.
    """
    n1, n2 = split_nf(nf)
    u_rows = min(n2, -(-period // n1))
    q_cols = min(n2, -(-period // n1))
    k1 = np.arange(n1)
    k2 = np.arange(n2)
    v = np.arange(n1)
    u = np.arange(u_rows)
    q = np.arange(q_cols)
    t = np.arange(n1)
    k_grid = k1[None, :] * n2 + k2[:, None]                # [k2, k1]
    return dict(
        n1=n1, n2=n2, u_rows=u_rows, q_cols=q_cols,
        f2=np.exp(-2j * np.pi * np.outer(k2, u) / n2),     # [n2, u_rows]
        wt=np.exp(-2j * np.pi * np.outer(k2, v) / nf),     # [n2, n1]
        f1=np.exp(-2j * np.pi * np.outer(v, k1) / n1),     # [n1, n1]
        e1=np.exp(2j * np.pi * np.outer(k1, t) / n1),      # [n1, n1]
        tw=np.exp(2j * np.pi * np.outer(k2, t) / nf),      # [n2, n1]
        e2=np.exp(2j * np.pi * np.outer(k2, q) / n2),      # [n2, q_cols]
        keff=np.where(k_grid >= nf // 2, k_grid - nf, k_grid))


@functools.lru_cache(maxsize=16)
def fused_tables(nf: int, period: int, device: str) -> tuple:
    """``(u_rows, q_cols, f2, wt, f1, e1, tw, e2)`` with the tables as
    contiguous complex64 tensors on ``device`` (cast from float64)."""
    t = four_step_np(nf, period)
    dev = torch.device(device)
    c64 = lambda a: torch.from_numpy(a.astype(np.complex64)).to(dev)
    return (t["u_rows"], t["q_cols"]) + tuple(
        c64(t[k]) for k in ("f2", "wt", "f1", "e1", "tw", "e2"))


def fold_code_planes_T(code_ffts_p: np.ndarray, period: int
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Wrapped code spectra as ``[n_sv*n2, n1]`` float32 planes: row
    ``sv*n2 + k2``, column ``k1`` holds bin ``k1*n2 + k2``
    (tpu_gnss/ops/mxu_corr.py:231-240, kept in float32 here)."""
    c = wrap_spectrum(np.asarray(code_ffts_p), period)
    n_sv, nf = c.shape
    n1, n2 = split_nf(nf)
    cT = c.reshape(n_sv, n1, n2).transpose(0, 2, 1).reshape(n_sv * n2, n1)
    return (np.ascontiguousarray(cT.real, np.float32),
            np.ascontiguousarray(cT.imag, np.float32))


def _shapes(x_r, cwT_r, period: int, nf: int):
    if x_r.ndim != 4:
        raise ValueError("x planes must be [rows, n_acc, u_rows, n1]")
    rows, n_acc, u_in, n1_in = x_r.shape
    n1, n2 = split_nf(nf)
    u_rows = four_step_np(nf, period)["u_rows"]
    if (u_in, n1_in) != (u_rows, n1):
        raise ValueError(f"x planes must be [rows, n_acc, {u_rows}, {n1}], "
                         f"got {tuple(x_r.shape)}")
    if cwT_r.ndim != 2 or cwT_r.shape[1] != n1 or cwT_r.shape[0] % n2:
        raise ValueError(f"code planes must be [n_sv*{n2}, {n1}], "
                         f"got {tuple(cwT_r.shape)}")
    return rows, n_acc, cwT_r.shape[0] // n2, n1, n2


def fold_corr_reduce_plain(x_r: torch.Tensor, x_i: torch.Tensor,
                           cwT_r: torch.Tensor, cwT_i: torch.Tensor, *,
                           period: int, nf: int):
    """Plain PyTorch version of :func:`fold_corr_reduce` (float32)."""
    rows, n_acc, n_sv, n1, n2 = _shapes(x_r, cwT_r, period, nf)
    _, q_cols, f2, wt, f1, e1, tw, e2 = fused_tables(nf, period,
                                                     str(x_r.device))
    cw = torch.complex(cwT_r, cwT_i).reshape(n_sv, n2, n1)
    z = (f2 @ torch.complex(x_r, x_i)) * wt           # [rows, acc, n2, n1]
    g = z @ f1
    g = torch.complex(g.real, -g.imag)                # conj: correlation
    pwr = torch.zeros(rows, n_sv, n1, q_cols, dtype=torch.float32,
                      device=x_r.device)
    for b in range(n_acc):
        m = cw[None] * g[:, b, None]                  # [rows, sv, k2, k1]
        a = (m @ e1) * tw                             # [rows, sv, k2, t]
        r = a.transpose(-1, -2) @ e2                  # [rows, sv, t, q]
        pwr = pwr + r.real * r.real + r.imag * r.imag
    t = torch.arange(n1, device=x_r.device)[:, None]
    q = torch.arange(q_cols, device=x_r.device)[None, :]
    lag_mat = (n1 * q + t).reshape(-1)
    valid = lag_mat < period
    pm = torch.where(valid, pwr.reshape(rows, n_sv, -1), 0.0)
    pk = pm.amax(-1)
    big = torch.iinfo(torch.int64).max
    lag = torch.where(pm >= pk[..., None], lag_mat, big).amin(-1)
    return pk, lag.to(torch.int32), pm.sum(-1)


def fold_corr_reduce(x_r: torch.Tensor, x_i: torch.Tensor,
                     cwT_r: torch.Tensor, cwT_i: torch.Tensor, *,
                     period: int, nf: int):
    """Forward DFT + spectrum product + inverse DFT + peak/SNR reduce.

    Args:
      x_r/x_i: ``[rows, n_acc, u_rows, n1]`` float32 planes of the
        wiped+folded blocks, zero-padded to ``u_rows*n1`` and reshaped row
        major; the ``n_acc`` blocks of a row sum non-coherently.
      cwT_r/cwT_i: ``[n_sv*n2, n1]`` float32 planes from
        :func:`fold_code_planes_T`.
      period: P = fs/1000 valid lags; nf: the transform length.

    Returns ``(peak [rows, n_sv] f32, lag [rows, n_sv] i32, tot [rows,
    n_sv] f32)``, scaled by NF² relative to a unitary inverse FFT.
    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel or raises.
    """
    dev = x_r.device
    if dev.type == "cpu":
        return fold_corr_reduce_plain(x_r, x_i, cwT_r, cwT_i,
                                      period=period, nf=nf)
    if dev.type != "cuda":
        raise ValueError(f"fold_corr_reduce: unsupported device {dev}")
    rows, n_acc, n_sv, n1, n2 = _shapes(x_r, cwT_r, period, nf)
    for name, a in (("x_r", x_r), ("x_i", x_i), ("cwT_r", cwT_r),
                    ("cwT_i", cwT_i)):
        if a.device != dev or a.dtype != torch.float32 \
                or not a.is_contiguous():
            raise ValueError(f"fold_corr_reduce: {name} must be a "
                             f"contiguous float32 tensor on {dev}")
    if x_i.shape != x_r.shape or cwT_i.shape != cwT_r.shape:
        raise ValueError("fold_corr_reduce: real/imag plane shapes differ")
    u_rows, q_cols, f2, wt, f1, e1, tw, e2 = fused_tables(nf, period,
                                                          str(dev))
    stage = max(1, min(n2, 2048 // n1))     # as in the launcher
    if max(8 * (u_rows * n1 + nf),
           8 * (nf + stage * n1) + 4 * n1 * q_cols) > kernels.SMEM_LIMIT:
        raise ValueError(f"fold_corr_reduce: NF={nf} needs more shared "
                         "memory than a Hopper block has")
    scratch = torch.empty(rows, n_acc, nf, dtype=torch.complex64, device=dev)
    peak = torch.empty(rows, n_sv, dtype=torch.float32, device=dev)
    lag = torch.empty(rows, n_sv, dtype=torch.int32, device=dev)
    tot = torch.empty(rows, n_sv, dtype=torch.float32, device=dev)
    ptrs = [a.data_ptr() for a in (x_r, x_i, cwT_r, cwT_i, f2, wt, f1, e1,
                                   tw, e2, scratch, peak, lag, tot)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = kernels.lib().fold_corr_reduce_launch(
            *ptrs, rows, n_acc, n_sv, n1, n2, u_rows, q_cols, period,
            stream)
    kernels.check("fold_corr_reduce", err)
    kernels.LAUNCHES.add("fold_corr_reduce")
    return peak, lag, tot
