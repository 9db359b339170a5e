# Copied from tpu_gnss/signal/resample.py:1-149 (the whole module).
"""Streaming FIR filtering and polyphase rational resampling.

The reference handles rate conversion with MATLAB experiments: block
convolution with tail carry (the overlap-add identity proven in
temp_test.m:10-27), FIR interp/decim chains in the commented resamplers
(gps_bin1bit_log2bin.m:42-159, gps_8bit_proc.m:31-106), and per-rail DC
removal (gps_8bit_proc.m:23-26).  Here those become first-class, tested
device ops:

* :func:`fir_stream` — block FIR with carried tail state, bit-exact with
  one-shot convolution over the concatenated stream.
* :class:`PolyphaseResampler` — rational L/M resampling as a polyphase
  matmul (taps reshaped to [L, n_taps/L] so the inner product lands on
  the MXU for wide blocks), with streaming state.
* :func:`design_lowpass` — windowed-sinc design (MATLAB fir1 analog).
* :func:`remove_dc` — per-rail DC offset removal.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def design_lowpass(n_taps: int, cutoff: float, fs: float = 1.0,
                   window: str = "hamming") -> np.ndarray:
    """Windowed-sinc lowpass FIR (MATLAB ``fir1(n, wn)`` analog).

    ``cutoff`` is the -6 dB edge in the same units as ``fs``.
    """
    if n_taps % 2 == 0:
        n_taps += 1
    m = np.arange(n_taps) - (n_taps - 1) / 2.0
    h = 2.0 * cutoff / fs * np.sinc(2.0 * cutoff / fs * m)
    if window == "hamming":
        w = np.hamming(n_taps)
    elif window == "blackman":
        w = np.blackman(n_taps)
    else:
        w = np.ones(n_taps)
    h *= w
    return (h / h.sum()).astype(np.float64)


def fir_stream(blocks, taps: np.ndarray):
    """Filter a sequence of blocks with carried tail state (overlap-add).

    Yields filtered blocks whose concatenation equals
    ``np.convolve(concat(blocks), taps)[: total_len]`` — the temp_test.m
    identity.  Works for real or complex blocks of any lengths.
    """
    taps = np.asarray(taps)
    ncar = len(taps) - 1
    carry = None
    for blk in blocks:
        blk = np.asarray(blk)
        full = np.convolve(blk, taps)       # len(blk) + ncar
        if carry is None:
            carry = np.zeros(ncar, dtype=full.dtype)
        full[:ncar] += carry
        yield full[: len(blk)]
        carry = full[len(blk):]


class PolyphaseResampler:
    """Rational L/M resampler with streaming state.

    Output stream = lowpass(upsample_by_L(x)) downsampled by M, computed
    without materializing the upsampled signal: output k is the dot
    product of the (k*M mod L)-th polyphase branch with the input history
    at index k*M//L.  The kernel is applied as a batched gather+dot so
    wide blocks vectorize; taps default to a windowed sinc at the tighter
    of the two Nyquist edges.
    """

    def __init__(self, up: int, down: int, taps_per_branch: int = 12,
                 taps: Optional[np.ndarray] = None):
        from math import gcd
        g = gcd(up, down)
        self.up = up // g
        self.down = down // g
        if taps is None:
            n = taps_per_branch * self.up
            if n % 2 == 0:
                n += 1
            cutoff = 0.5 / max(self.up, self.down)
            taps = design_lowpass(n, cutoff, 1.0) * self.up
        taps = np.asarray(taps, dtype=np.float64)
        # pad to a multiple of up and reshape into branches:
        # branch p holds taps[p], taps[p+L], ...
        pad = (-len(taps)) % self.up
        taps = np.concatenate([taps, np.zeros(pad)])
        self.n_taps = len(taps)
        self.branches = taps.reshape(-1, self.up).T[:, ::-1].copy()
        self.hist_len = self.branches.shape[1]
        self._hist = None
        self._phase = 0  # position of next output in upsampled grid

    def reset(self) -> None:
        self._hist = None
        self._phase = 0

    def process(self, x: np.ndarray) -> np.ndarray:
        """Resample one block; carries filter history across calls.

        Vectorized: all output windows are gathered at once and contracted
        against their polyphase branches with one batched dot.
        """
        x = np.asarray(x)
        dtype = np.result_type(x.dtype, np.float64)
        if self._hist is None:
            self._hist = np.zeros(self.hist_len - 1, dtype=dtype)
        buf = np.concatenate([self._hist.astype(dtype), x.astype(dtype)])
        n_in = len(buf)
        phase = self._phase
        # output k reads buf[i_k : i_k + hist_len], i_k = (phase+k*down)//up;
        # emit while the window is fully available
        k_max = (self.up * (n_in - self.hist_len + 1) - 1 - phase) // self.down
        n_out = max(0, k_max + 1)
        if n_out == 0:
            out = np.zeros(0, dtype=dtype)
        else:
            ph = phase + np.arange(n_out) * self.down
            i_in = ph // self.up
            br = ph % self.up
            idx = i_in[:, None] + np.arange(self.hist_len)[None, :]
            out = np.einsum("ij,ij->i", buf[idx], self.branches[br])
            phase = int(ph[-1]) + self.down
        keep = min(self.hist_len - 1, len(buf))
        self._hist = buf[len(buf) - keep:]
        # re-anchor phase to the new buffer origin
        self._phase = phase - (len(buf) - keep) * self.up
        return out.astype(dtype)


def resample_rational(x: np.ndarray, up: int, down: int,
                      taps_per_branch: int = 12) -> np.ndarray:
    """One-shot rational resample (streaming kernel under the hood)."""
    r = PolyphaseResampler(up, down, taps_per_branch)
    return r.process(x)


def remove_dc(iq: np.ndarray) -> np.ndarray:
    """Per-rail DC removal (gps_8bit_proc.m:23-26 semantics)."""
    iq = np.asarray(iq)
    if np.iscomplexobj(iq):
        return iq - (iq.real.mean() + 1j * iq.imag.mean())
    return iq - iq.mean()
