"""DFT-correlate-reduce for folded acquisition (kernels 1 and 4).

Counterpart of :mod:`tpu_gnss.ops.mxu_corr`.  ``NF = n1*n2`` is factored
for the four-step DFT

    corr[n1*q + t] = (E1 @ M * tw) @ E2   at cell [t, q]

and each (Doppler row, SV) pair is reduced to the three numbers
acquisition needs — peak power, first-max lag and total power over the P
valid lags — without materializing the power grid.

* :func:`fold_corr_reduce` (kernel 1) takes the wiped+folded time blocks
  and runs the forward DFT too; ``csrc/fold_corr_reduce.cu``.
* :func:`corr_reduce` (kernel 4, the reference's "v1") takes precomputed
  conjugated data spectra; ``csrc/corr_reduce.cu``.

On a CUDA tensor each launches its hand-written kernel; on a CPU tensor
it runs its ``*_plain`` version, the same arithmetic as float32 PyTorch
matmuls over the same tables.  The kernels run every DFT stage on the
tensor cores with TF32 operands and float32 accumulation (the TPU kernels:
bf16 operands), from the fragment-ordered tables of :func:`mma_tables`;
the plain versions keep all products in float32.
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


@functools.lru_cache(maxsize=16)
def idft_tables(nf: int, device: str) -> tuple:
    """``(e1 [n1, n1], tw [n1, n2], e2 [n2, n2])`` inverse four-step DFT
    tables as contiguous complex64 tensors on ``device``, built in float64
    (tpu_gnss/ops/mxu_corr.py:76-90, kept in float32 here)."""
    n1, n2 = split_nf(nf)
    t = np.arange(n1)
    s = np.arange(n2)
    dev = torch.device(device)
    c64 = lambda a: torch.from_numpy(a.astype(np.complex64)).to(dev)
    return (c64(np.exp(2j * np.pi * np.outer(t, t) / n1)),
            c64(np.exp(2j * np.pi * np.outer(t, s) / nf)),
            c64(np.exp(2j * np.pi * np.outer(s, s) / n2)))


def wrap_code_planes(code_ffts_p: np.ndarray, period: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Code spectra -> ``[n_sv, n1, n2]`` float32 (real, imag) planes with
    the circular wrap folded in (tpu_gnss/ops/mxu_corr.py:105-114, kept in
    float32 here)."""
    c = wrap_spectrum(np.asarray(code_ffts_p), period)
    n_sv, nf = c.shape
    n1, n2 = split_nf(nf)
    c = c.reshape(n_sv, n1, n2)
    return (np.ascontiguousarray(c.real, np.float32),
            np.ascontiguousarray(c.imag, np.float32))


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


def tf32_round(a: np.ndarray) -> np.ndarray:
    """Round float32 values to TF32 (10 mantissa bits kept) to nearest,
    ties away from zero, as ``cvt.rna.tf32.f32`` does."""
    b = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _padded(a: np.ndarray, r: int, c: int) -> np.ndarray:
    """``a`` zero-padded to multiples of ``r`` rows and ``c`` columns."""
    m, n = a.shape
    p = np.zeros((-(-m // r) * r, -(-n // c) * c), a.dtype)
    p[:m, :n] = a
    return p


_LANE = np.arange(32)
_GQ, _TQ = _LANE // 4, _LANE % 4     # the lane's row group and column


def a_fragments(a: np.ndarray) -> np.ndarray:
    """``[m, k]`` complex -> the A operands of ``mma.m16n8k8`` (tf32) as a
    float32 ``[ceil(m/16), 2*ceil(k/16), 32, 8]`` table: per 16x8 tile and
    lane, the real then the imaginary parts of a0..a3, which are the tile's
    (g, t), (g+8, t), (g, t+4), (g+8, t+4) with g = lane // 4, t = lane % 4.
    Zero-padded (k to whole pairs of k-steps) and TF32-rounded."""
    p = _padded(a, 16, 16)
    tiles = p.reshape(p.shape[0] // 16, 16, p.shape[1] // 8, 8).swapaxes(1, 2)
    rows = np.stack([_GQ, _GQ + 8, _GQ, _GQ + 8], -1)
    cols = np.stack([_TQ, _TQ, _TQ + 4, _TQ + 4], -1)
    f = tiles[:, :, rows, cols]                       # [mt, ks, 32, 4]
    return tf32_round(np.concatenate([f.real, f.imag], -1))


def b_fragments(b: np.ndarray) -> np.ndarray:
    """``[j, n]`` complex -> the B operands of the second stage of
    ``csrc/four_step_mma.cuh`` as a float32 ``[4*ceil(j/32), 8*ceil(n/64),
    32, 4]`` table: per 8x8 tile and lane (re b0, re b1, im b0, im b1), b0
    and b1 the tile's rows 2t and 2t+1 in column g (the k order in which the
    first stage's accumulators serve as A operands).  Zero-padded (j to
    whole chunks of 32, n to whole runs of 8 tiles) and TF32-rounded."""
    p = _padded(b, 32, 64)
    tiles = p.reshape(p.shape[0] // 8, 8, p.shape[1] // 8, 8).swapaxes(1, 2)
    f0, f1 = tiles[:, :, 2 * _TQ, _GQ], tiles[:, :, 2 * _TQ + 1, _GQ]
    return tf32_round(np.stack([f0.real, f1.real, f0.imag, f1.imag], -1))


@functools.lru_cache(maxsize=16)
def mma_tables(nf: int, period: int, device: str) -> tuple:
    """``(forward, inverse)`` tables of the tensor-core kernels, each
    ``(a1, tw, b2)`` on ``device``: ``a1`` from :func:`a_fragments`, ``tw``
    the float32 twiddles zero-padded to ``[16*ceil(m/16), 32*ceil(j/32)]``
    (complex64), ``b2`` from :func:`b_fragments`.  Forward (pass A of
    ``fold_corr_reduce``): A1 = f2, tw = wt, B2 = f1.  Inverse (both
    kernels): A1 = e1^T (rows t), tw = tw^T ([t, k2]), B2 = e2.  All from
    :func:`four_step_np`'s float64 tables."""
    t = four_step_np(nf, period)
    dev = torch.device(device)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    tw = lambda a: up(_padded(a, 16, 32).astype(np.complex64))
    return ((up(a_fragments(t["f2"])), tw(t["wt"]), up(b_fragments(t["f1"]))),
            (up(a_fragments(t["e1"].T)), tw(t["tw"].T),
             up(b_fragments(t["e2"]))))


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
    return _reduce_lags(pwr, period)


def _reduce_lags(pwr: torch.Tensor, period: int):
    """``[rows, n_sv, t, q]`` powers (lag n1*q + t) -> peak, smallest lag
    among the peak cells, and total over the lags < period."""
    rows, n_sv, n1, q_cols = pwr.shape
    t = torch.arange(n1, device=pwr.device)[:, None]
    q = torch.arange(q_cols, device=pwr.device)[None, :]
    lag_mat = (n1 * q + t).reshape(-1)
    valid = lag_mat < period
    pm = torch.where(valid, pwr.reshape(rows, n_sv, -1), 0.0)
    pk = pm.amax(-1)
    big = torch.iinfo(torch.int64).max
    lag = torch.where(pm >= pk[..., None], lag_mat, big).amin(-1)
    return pk, lag.to(torch.int32), pm.sum(-1)


def _check_planes(name: str, dev, **planes) -> None:
    for key, a in planes.items():
        if a.device != dev or a.dtype != torch.float32 \
                or not a.is_contiguous():
            raise ValueError(f"{name}: {key} must be a contiguous float32 "
                             f"tensor on {dev}")


def stage_smem(m: int, k: int, j: int, n: int, *, planes: int,
               items: int = 1, max_warps: int = 8, n_acc: int = 1) -> int:
    """Dynamic shared memory of one launch of ``csrc/four_step_mma.cuh``'s
    stage pair, its ``make_plan`` and ``reduce_bytes``: two TF32 tiles of a
    ``[min(128, K), 32]`` chunk per item (K = 16*ceil(k/16)), each thread's
    raw input slots (``planes`` floats per element), two B2 chunks of
    ``8*ceil(n/64)`` n-tiles, and for ``n_acc`` > 1 each warp's |Out|²
    sums.  ``items`` SVs share a block when one item's tasks (16-row m
    tiles x runs of at most 8 n-tiles) fill fewer than ``max_warps``."""
    cdiv = lambda a, b: -(-a // b)
    nt = cdiv(n, 8)
    runs = cdiv(nt, 8)
    nq = 2 * cdiv(cdiv(nt, runs), 2)
    tasks = cdiv(m, 16) * runs
    rounds = cdiv(tasks, max_warps)
    wpi = cdiv(tasks, rounds)
    gi = max(1, min(max_warps // wpi, items)) if rounds == 1 else 1
    kspc = min(2 * cdiv(k, 16), 16)
    tile = kspc * 4 * 32 * 16
    b2 = 4 * 8 * cdiv(nt, 8) * 32 * 16
    raw = kspc * 4 * 2 * planes * 32 * 4
    sums = gi * wpi * nq * 4 * 32 * 4 if n_acc > 1 else 0
    return 2 * gi * tile + 2 * b2 + gi * raw + sums


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
    _check_planes("fold_corr_reduce", dev, x_r=x_r, x_i=x_i, cwT_r=cwT_r,
                  cwT_i=cwT_i)
    if x_i.shape != x_r.shape or cwT_i.shape != cwT_r.shape:
        raise ValueError("fold_corr_reduce: real/imag plane shapes differ")
    t = four_step_np(nf, period)
    u_rows, q_cols = t["u_rows"], t["q_cols"]
    if max(stage_smem(n2, u_rows, n1, n1, planes=2, max_warps=4),
           stage_smem(n1, n1, n2, q_cols, planes=4, items=n_sv, n_acc=n_acc)
           ) > kernels.SMEM_LIMIT:
        raise ValueError(f"fold_corr_reduce: NF={nf} needs more shared "
                         "memory than a Hopper block has")
    fwd, inv = mma_tables(nf, period, str(dev))
    scratch = torch.empty(rows, n_acc, nf, dtype=torch.complex64, device=dev)
    peak = torch.empty(rows, n_sv, dtype=torch.float32, device=dev)
    lag = torch.empty(rows, n_sv, dtype=torch.int32, device=dev)
    tot = torch.empty(rows, n_sv, dtype=torch.float32, device=dev)
    ptrs = [a.data_ptr() for a in (x_r, x_i, cwT_r, cwT_i, *fwd, *inv,
                                   scratch, peak, lag, tot)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = kernels.lib().fold_corr_reduce_launch(
            *ptrs, rows, n_acc, n_sv, n1, n2, u_rows, q_cols, period,
            stream)
    kernels.check("fold_corr_reduce", err)
    kernels.launched("fold_corr_reduce")
    return peak, lag, tot


def _spectra_shapes(g_r, cw_r, period: int):
    """Validate ``[rows, (n_acc,) n1, n2]`` spectra and ``[n_sv, n1, n2]``
    code planes; return the 4-D view and the sizes."""
    if g_r.ndim == 3:
        g_r = g_r[:, None]
    if g_r.ndim != 4:
        raise ValueError("spectra must be [rows, (n_acc,) n1, n2]")
    rows, n_acc, n1, n2 = g_r.shape
    if split_nf(n1 * n2) != (n1, n2):
        raise ValueError(f"spectra [.., {n1}, {n2}] are not the split "
                         f"{split_nf(n1 * n2)} of NF={n1 * n2}")
    if cw_r.ndim != 3 or tuple(cw_r.shape[1:]) != (n1, n2):
        raise ValueError(f"code planes must be [n_sv, {n1}, {n2}], "
                         f"got {tuple(cw_r.shape)}")
    if not 0 < period <= n1 * n2:
        raise ValueError(f"period {period} outside (0, NF={n1 * n2}]")
    return rows, n_acc, cw_r.shape[0], n1, n2, min(n2, -(-period // n1))


def corr_reduce_plain(g_r: torch.Tensor, g_i: torch.Tensor,
                      cw_r: torch.Tensor, cw_i: torch.Tensor, *,
                      period: int):
    """Plain PyTorch version of :func:`corr_reduce` (float32)."""
    rows, n_acc, n_sv, n1, n2, q_cols = _spectra_shapes(g_r, cw_r, period)
    e1, tw, e2 = idft_tables(n1 * n2, str(g_r.device))
    g = torch.complex(g_r, g_i).reshape(rows, n_acc, n1, n2)
    cw = torch.complex(cw_r, cw_i)
    e2q = e2[:, :q_cols]
    pwr = torch.zeros(rows, n_sv, n1, q_cols, dtype=torch.float32,
                      device=g_r.device)
    for b in range(n_acc):
        m = cw[None] * g[:, b, None]                  # [rows, sv, k1, k2]
        r = ((e1 @ m) * tw) @ e2q                     # [rows, sv, t, q]
        pwr = pwr + r.real * r.real + r.imag * r.imag
    return _reduce_lags(pwr, period)


def corr_reduce(g_r: torch.Tensor, g_i: torch.Tensor, cw_r: torch.Tensor,
                cw_i: torch.Tensor, *, period: int):
    """Reduced circular correlation for every (row, SV) pair.

    Args:
      g_r/g_i: ``[rows, n1, n2]`` (or ``[rows, n_acc, n1, n2]``: that
        row's spectra from n_acc successive blocks, whose |corr|² sum
        before the peak search) float32 planes of the CONJUGATED
        wiped+folded data spectra, reshaped row-major from length-NF
        spectra (index ``k1*n2 + k2``).
      cw_r/cw_i: ``[n_sv, n1, n2]`` float32 planes from
        :func:`wrap_code_planes`.
      period: P = fs/1000 valid lags.

    Returns ``(peak [rows, n_sv] f32, lag [rows, n_sv] i32, tot [rows,
    n_sv] f32)``, scaled by NF² relative to a unitary inverse FFT (SNR =
    peak/(tot/P) is scale-free).  A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel or raises.
    """
    dev = g_r.device
    if dev.type == "cpu":
        return corr_reduce_plain(g_r, g_i, cw_r, cw_i, period=period)
    if dev.type != "cuda":
        raise ValueError(f"corr_reduce: unsupported device {dev}")
    rows, n_acc, n_sv, n1, n2, q_cols = _spectra_shapes(g_r, cw_r, period)
    _check_planes("corr_reduce", dev, g_r=g_r, g_i=g_i, cw_r=cw_r,
                  cw_i=cw_i)
    if g_i.shape != g_r.shape or cw_i.shape != cw_r.shape:
        raise ValueError("corr_reduce: real/imag plane shapes differ")
    if stage_smem(n1, n1, n2, q_cols, planes=4, items=n_sv,
                  n_acc=n_acc) > kernels.SMEM_LIMIT:
        raise ValueError(f"corr_reduce: NF={n1 * n2} needs more shared "
                         "memory than a Hopper block has")
    _, inv = mma_tables(n1 * n2, period, str(dev))
    peak = torch.empty(rows, n_sv, dtype=torch.float32, device=dev)
    lag = torch.empty(rows, n_sv, dtype=torch.int32, device=dev)
    tot = torch.empty(rows, n_sv, dtype=torch.float32, device=dev)
    ptrs = [a.data_ptr() for a in (g_r, g_i, cw_r, cw_i, *inv, peak, lag,
                                   tot)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = kernels.lib().corr_reduce_launch(
            *ptrs, rows, n_acc, n_sv, n1, n2, q_cols, period, stream)
    kernels.check("corr_reduce", err)
    kernels.launched("corr_reduce")
    return peak, lag, tot
