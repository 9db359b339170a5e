# Copied from tpu_gnss/io/loaders.py:1-292 (the whole module); the
# port's unpack_1bit keeps the numpy path only (the reference's prefers
# its native helper, :40-44; both give the same bits), and the converters
# call the port's own io/native.
"""Capture-file loaders and format converters.

Host-side ingest of the capture formats the reference toolkit handles:

* bit-packed 1-bit real IF files, LSB-first within each byte
  (reference: c/search_offline.cpp:121-157)
* interleaved int8 I/Q (HackRF: proc_hackrf_bin_for_gps.m:7-12)
* interleaved uint8 I/Q (rtl-sdr: proc_rtl_bin_for_gps.m:11-18)
* WAV captures (gps_wav_log2bin.m:28,52-58)

plus converters reproducing the behavior of the MATLAB/C conversion tools
(gps_bin1bit_log2bin.m, proc_rtl_bin_for_gps.m, proc_hackrf_bin_for_gps.m,
c/conv_1bit_bin_to_hackrf_bin.cpp).  The converters stream file-to-file
through :mod:`tpu_gnss_torch.io.native` where a C++ toolchain exists and
fall back to numpy where none does.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..config import ReceiverConfig


# ---------------------------------------------------------------------------
# 1-bit files
# ---------------------------------------------------------------------------

def unpack_1bit(raw: bytes | np.ndarray, count: Optional[int] = None) -> np.ndarray:
    """Unpack LSB-first bit-packed bytes to a {0,1} uint8 sample array.

    Matches the reference's per-byte ``bit = byte&1; byte >>= 1`` order
    (reference: c/search_offline.cpp:141-146) and MATLAB ``fread(...,'ubit1')``.
    """
    buf = np.frombuffer(raw, dtype=np.uint8) if isinstance(raw, (bytes, bytearray)) else np.asarray(raw, dtype=np.uint8)
    bits = np.unpackbits(buf, bitorder="little")
    return bits[:count] if count is not None else bits


def pack_1bit(bits: np.ndarray) -> bytes:
    """Pack {0,1} samples into LSB-first bytes (MATLAB 'ubit1' writer)."""
    return np.packbits(np.asarray(bits, dtype=np.uint8), bitorder="little").tobytes()


def load_1bit(path: str, count: Optional[int] = None,
              offset_samples: int = 0) -> np.ndarray:
    """Read a 1-bit capture file into a {0,1} uint8 array.

    ``offset_samples`` must be a multiple of 8 (byte-aligned streaming, as
    the reference's 512-byte packet reads are).
    """
    assert offset_samples % 8 == 0, "1-bit stream offsets must be byte aligned"
    nbytes = None if count is None else (count + 7) // 8
    with open(path, "rb") as f:
        f.seek(offset_samples // 8)
        raw = f.read(-1 if nbytes is None else nbytes)
    return unpack_1bit(raw, count)


def num_samples_1bit(path: str) -> int:
    return os.path.getsize(path) * 8


# ---------------------------------------------------------------------------
# Quadrature square-wave mixing (the reference's 1-bit front end)
# ---------------------------------------------------------------------------

# 4-phase LO tables.  The offline and live front ends use different tables /
# I-Q assignments (reference: c/search_offline.cpp:124-125,152-153 vs
# c/search.cpp; conv_1bit_bin_to_hackrf_bin.cpp:31-32,68-72).
LO_TABLES = {
    # variant: (i_table, q_table)
    "offline": ((0, 1, 1, 0), (1, 1, 0, 0)),   # I=lo_cos, Q=lo_sin
    "live":    ((1, 1, 0, 0), (1, 0, 0, 1)),   # I=lo_sin, Q=lo_cos
}


def lo_phase_index(n_samples: int, lo_rate: float,
                   sample0: int = 0) -> np.ndarray:
    """Quarter-cycle phase index per sample: ``floor((i*lo_rate) mod 4)``.

    Exact-arithmetic equivalent of the reference's accumulate-and-wrap float
    NCO (reference: c/search_offline.cpp:127,155-156).  Phase starts at
    absolute sample ``sample0``: 0 per *block* (each reference ``Sample()``
    call restarts the LO) or a running offset for phase-continuous streams.
    """
    i = np.arange(sample0, sample0 + n_samples, dtype=np.float64)
    return np.floor((i * lo_rate) % 4.0).astype(np.int64)


def mix_1bit_block(bits: np.ndarray, cfg: ReceiverConfig,
                   variant: str = "offline", sample0: int = 0) -> np.ndarray:
    """Downconvert a block of {0,1} IF samples to complex baseband.

    XOR mixing with quadrature square-wave LOs, bipolar mapping bit 1 -> −1:
    ``I = ±1 * (−1)^lo_i[p]``, ``Q = ±1 * (−1)^lo_q[p]``
    (reference: c/search_offline.cpp:150-156).  ``sample0`` as in
    :func:`lo_phase_index`.

    Returns complex64 ``[len(bits)]``.
    """
    i_tbl, q_tbl = LO_TABLES[variant]
    p = lo_phase_index(len(bits), cfg.lo_rate, sample0)
    s = 1.0 - 2.0 * np.asarray(bits, dtype=np.float32)
    i_sign = 1.0 - 2.0 * np.asarray(i_tbl, dtype=np.float32)[p]
    q_sign = 1.0 - 2.0 * np.asarray(q_tbl, dtype=np.float32)[p]
    return (s * i_sign + 1j * (s * q_sign)).astype(np.complex64)


# ---------------------------------------------------------------------------
# 8-bit I/Q formats
# ---------------------------------------------------------------------------

def load_int8_iq(path: str, count: Optional[int] = None,
                 remove_dc: bool = True) -> np.ndarray:
    """Interleaved signed int8 I/Q (HackRF captures).

    Mean removal per proc_hackrf_bin_for_gps.m:11-13.
    """
    n = None if count is None else 2 * count
    raw = np.fromfile(path, dtype=np.int8, count=-1 if n is None else n)
    y = raw[0::2].astype(np.float32) + 1j * raw[1::2].astype(np.float32)
    if remove_dc:
        y = y - y.mean()
    return y.astype(np.complex64)


def load_uint8_iq(path: str, count: Optional[int] = None,
                  remove_dc: bool = True) -> np.ndarray:
    """Interleaved unsigned uint8 I/Q (rtl-sdr captures).

    Centering: subtract 128, then remove residual complex mean
    (proc_rtl_bin_for_gps.m:15-18).
    """
    n = None if count is None else 2 * count
    raw = np.fromfile(path, dtype=np.uint8, count=-1 if n is None else n)
    y = (raw[0::2].astype(np.float32) - 128.0) + 1j * (raw[1::2].astype(np.float32) - 128.0)
    if remove_dc:
        y = y - y.mean()
    return y.astype(np.complex64)


def iq8_to_complex(raw: np.ndarray, signed: bool,
                   remove_dc: bool = True) -> np.ndarray:
    """Interleaved 8-bit I/Q array (native dtype) -> complex64 baseband.

    Host-side mirror of the device conversion
    (tpu_gnss_torch.utils.xfer._deinterleave_iq8); same centering
    semantics as :func:`load_int8_iq` / :func:`load_uint8_iq`.
    """
    a = np.asarray(raw).astype(np.float32)
    if not signed:
        a = a - 128.0
    y = a[0::2] + 1j * a[1::2]
    if remove_dc:
        y = y - y.mean()
    return y.astype(np.complex64)


def load_wav_iq(path: str, count: Optional[int] = None) -> tuple[np.ndarray, float]:
    """Stereo WAV capture (HDSDR) -> interleaved real sample stream + rate.

    Follows gps_wav_log2bin.m:52-55: channels interleaved into one real
    stream (frame-major), mean removed.  Returns (float32 samples, fs).
    """
    from scipy.io import wavfile
    fs, data = wavfile.read(path)
    y = data.astype(np.float32).reshape(-1)[: None if count is None else count]
    return y - y.mean(), float(fs)


# ---------------------------------------------------------------------------
# Converters (tooling parity with the reference's scripts)
# ---------------------------------------------------------------------------

def real_to_1bit(y: np.ndarray) -> np.ndarray:
    """Hard-limit a real signal to the reference's 1-bit convention.

    ``bit = (1 - sign(y)) / 2`` — negative sample -> bit 1
    (gps_sig_gen.m:37, proc_rtl_bin_for_gps.m:22).  sign(0) -> bit 0 to
    within the same convention (MATLAB sign(0)=0 -> 0.5; files never hit
    exact zero in practice; we round down).
    """
    return (np.asarray(y) < 0).astype(np.uint8)


def iq_to_real_1bit(y: np.ndarray, fc: float, fs: float) -> np.ndarray:
    """Complex baseband -> sign of digitally up-mixed real IF, bit-packed ready.

    ``real(y * exp(+j 2π fc t))`` then hard limit
    (proc_rtl_bin_for_gps.m:40-44, proc_hackrf_bin_for_gps.m:15-16).
    """
    n = np.arange(len(y), dtype=np.float64)
    z = np.real(np.asarray(y) * np.exp(2j * np.pi * fc * n / fs))
    return real_to_1bit(z)


def convert_rtlsdr_to_1bit(in_path: str, out_path: str, fc: float = 0.62e6,
                           fs: float = 2.8e6, mix: bool = True) -> None:
    """rtl-sdr uint8 I/Q capture -> 1-bit IF file (proc_rtl_bin_for_gps.m).

    ``mix=False`` reproduces the 1574.8 MHz-tuned branch (take real part
    directly, the 620 kHz offset already present from tuning offset).
    Streams file-to-file through the native converter when the toolchain
    is available (bounded memory for arbitrarily long captures).
    """
    try:
        from . import native
        native.convert_iq_to_1bit(in_path, out_path, is_signed=False,
                                  mix=mix, fc_over_fs=fc / fs)
        return
    except OSError:
        raise
    except Exception:
        pass  # no toolchain: numpy fallback below
    y = load_uint8_iq(in_path)
    bits = iq_to_real_1bit(y, fc, fs) if mix else real_to_1bit(np.real(y))
    with open(out_path, "wb") as f:
        f.write(pack_1bit(bits))


def convert_hackrf_to_1bit(in_path: str, out_path: str, fc: float = 2.6e6,
                           fs: float = 10e6) -> None:
    """HackRF int8 I/Q capture -> 1-bit IF file (proc_hackrf_bin_for_gps.m).

    Streams file-to-file through the native converter when available.
    """
    try:
        from . import native
        native.convert_iq_to_1bit(in_path, out_path, is_signed=True,
                                  mix=True, fc_over_fs=fc / fs)
        return
    except OSError:
        raise
    except Exception:
        pass  # no toolchain: numpy fallback below
    y = load_int8_iq(in_path)
    bits = iq_to_real_1bit(y, fc, fs)
    with open(out_path, "wb") as f:
        f.write(pack_1bit(bits))


def convert_wav_to_1bit(in_path: str, out_path: str) -> float:
    """HDSDR WAV -> 1-bit file (gps_wav_log2bin.m:52-58). Returns fs."""
    y, fs = load_wav_iq(in_path)
    with open(out_path, "wb") as f:
        f.write(pack_1bit(real_to_1bit(y)))
    return fs


def convert_1bit_to_iq8(in_path: str, out_path: str, fs: float = 5.456e6,
                        gain: int = 100, block: int = 1 << 22) -> None:
    """1-bit IF capture -> int8 interleaved baseband I/Q for playback.

    Exact fs/4 quadrature mix with LO patterns [1,0,−1,0] / [0,1,0,−1]
    (gps_bin1bit_log2bin.m:21-33): valid when IF aliases to ±fs/4, as the
    Nottingham capture's 4.092 MHz IF does at fs=5.456 MHz.  Streamed in
    blocks (multiple of 4 samples) so arbitrarily long captures convert in
    bounded memory.
    """
    assert block % 4 == 0
    try:
        from . import native
        if gain <= 127:
            native.convert_1bit_to_iq8(in_path, out_path, gain)
            return
    except OSError:
        raise
    except Exception:
        pass  # no toolchain: numpy fallback below
    lo_i = np.tile(np.array([1, 0, -1, 0], np.int32), block // 4)
    lo_q = np.tile(np.array([0, 1, 0, -1], np.int32), block // 4)
    with open(in_path, "rb") as fin, open(out_path, "wb") as fout:
        while True:
            raw = fin.read(block // 8)
            if not raw:
                break
            bits = unpack_1bit(raw)
            s = 1 - 2 * bits.astype(np.int32)
            m = len(s)
            out = np.empty(2 * m, dtype=np.int8)
            out[0::2] = np.clip(s * lo_i[:m] * gain, -127, 127)
            out[1::2] = np.clip(s * lo_q[:m] * gain, -127, 127)
            out.tofile(fout)
