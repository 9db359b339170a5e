# Copied from tpu_gnss/io/native.py:1-148, with the build moved: the
# library is compiled by g++ from the port's own copy of sdrio.cpp into
# build/tpu_gnss_torch/ (never into the reference's native/ folder).
"""ctypes binding for the native sample-ingest library.

Builds ``build/tpu_gnss_torch/libsdrio_<hash>.so`` from
``tpu_gnss_torch/native/sdrio.cpp`` on first use (g++, the reference's
flags), keyed on a hash of the source, the flags and the host CPU's
features, so an edited source or another machine rebuilds.  Raises if no
toolchain is available: the converters in
:mod:`tpu_gnss_torch.io.loaders` then fall back to numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "sdrio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpu_gnss_torch"
# tpu_gnss/native/Makefile's CXXFLAGS
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]
_lock = threading.Lock()
_lib = None


def _cpu_flags() -> bytes:
    """The host CPU's feature flags: ``-march=native`` builds for them, so
    a checkout copied to another machine builds its own library."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((ln for ln in f if ln.startswith(b"flags")), b"")
    except OSError:
        return b""


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_cpu_flags())
    return BUILD_DIR / f"libsdrio_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless the hashed file already exists."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native helpers cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        so = os.path.join(tmp, "lib.so")
        subprocess.run([cxx] + CXXFLAGS + [str(SOURCE), "-o", so],
                       check=True, capture_output=True)
        os.replace(so, out)  # atomic: a concurrent loader never sees half
    return out


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        u8 = ctypes.POINTER(ctypes.c_uint8)
        i8 = ctypes.POINTER(ctypes.c_int8)
        f32 = ctypes.POINTER(ctypes.c_float)
        i64 = ctypes.c_int64
        lib.sdrio_unpack_1bit.argtypes = [u8, i64, u8]
        lib.sdrio_unpack_1bit_bipolar.argtypes = [u8, i64, i8]
        lib.sdrio_unpack_mix_1bit.argtypes = [u8, i64, u8, u8, ctypes.c_double, i8, i8]
        lib.sdrio_deinterleave_int8.argtypes = [i8, i64, f32, f32]
        lib.sdrio_deinterleave_uint8.argtypes = [u8, i64, f32, f32]
        lib.sdrio_pack_1bit.argtypes = [u8, i64, u8]
        _lib = lib
        return lib


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))


def _f32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def unpack_1bit(buf: np.ndarray) -> np.ndarray:
    lib = _load()
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    out = np.empty(8 * len(buf), dtype=np.uint8)
    lib.sdrio_unpack_1bit(_u8ptr(buf), len(buf), _u8ptr(out))
    return out


def unpack_1bit_bipolar(buf: np.ndarray) -> np.ndarray:
    lib = _load()
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    out = np.empty(8 * len(buf), dtype=np.int8)
    lib.sdrio_unpack_1bit_bipolar(_u8ptr(buf), len(buf), _i8ptr(out))
    return out


def unpack_mix_1bit(buf: np.ndarray, lo_i, lo_q, lo_rate: float):
    """Fused unpack + square-wave mix -> planar int8 (I, Q)."""
    lib = _load()
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    lo_i = np.ascontiguousarray(lo_i, dtype=np.uint8)
    lo_q = np.ascontiguousarray(lo_q, dtype=np.uint8)
    out_i = np.empty(8 * len(buf), dtype=np.int8)
    out_q = np.empty(8 * len(buf), dtype=np.int8)
    lib.sdrio_unpack_mix_1bit(_u8ptr(buf), len(buf), _u8ptr(lo_i), _u8ptr(lo_q),
                              float(lo_rate), _i8ptr(out_i), _i8ptr(out_q))
    return out_i, out_q


def deinterleave_int8(raw: np.ndarray):
    lib = _load()
    raw = np.ascontiguousarray(raw, dtype=np.int8)
    n = len(raw) // 2
    out_i = np.empty(n, dtype=np.float32)
    out_q = np.empty(n, dtype=np.float32)
    lib.sdrio_deinterleave_int8(_i8ptr(raw), n, _f32ptr(out_i), _f32ptr(out_q))
    return out_i, out_q


def deinterleave_uint8(raw: np.ndarray):
    lib = _load()
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    n = len(raw) // 2
    out_i = np.empty(n, dtype=np.float32)
    out_q = np.empty(n, dtype=np.float32)
    lib.sdrio_deinterleave_uint8(_u8ptr(raw), n, _f32ptr(out_i), _f32ptr(out_q))
    return out_i, out_q


def pack_1bit(bits: np.ndarray) -> np.ndarray:
    lib = _load()
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    out = np.empty((len(bits) + 7) // 8, dtype=np.uint8)
    lib.sdrio_pack_1bit(_u8ptr(bits), len(bits), _u8ptr(out))
    return out


def convert_1bit_to_iq8(in_path: str, out_path: str, gain: int = 100) -> int:
    """Native streamed 1-bit -> int8 I/Q conversion; returns sample count."""
    lib = _load()
    lib.sdrio_convert_1bit_to_iq8.argtypes = [ctypes.c_char_p,
                                              ctypes.c_char_p, ctypes.c_int]
    lib.sdrio_convert_1bit_to_iq8.restype = ctypes.c_int64
    n = lib.sdrio_convert_1bit_to_iq8(in_path.encode(), out_path.encode(),
                                      gain)
    if n < 0:
        raise OSError(f"conversion failed: {in_path} -> {out_path}")
    return int(n)


def convert_iq_to_1bit(in_path: str, out_path: str, *, is_signed: bool,
                       remove_dc: bool = True, mix: bool = True,
                       fc_over_fs: float = 0.0) -> int:
    """Native streamed interleaved-I/Q -> 1-bit IF capture conversion.

    Two file passes (DC estimate + convert) in bounded memory; returns
    sample count.  ``is_signed``: int8 pairs (HackRF) vs uint8-128
    (rtl-sdr).
    """
    lib = _load()
    lib.sdrio_convert_iq_to_1bit.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_double]
    lib.sdrio_convert_iq_to_1bit.restype = ctypes.c_int64
    n = lib.sdrio_convert_iq_to_1bit(
        in_path.encode(), out_path.encode(), int(is_signed),
        int(remove_dc), int(mix), float(fc_over_fs))
    if n < 0:
        raise OSError(f"conversion failed: {in_path} -> {out_path}")
    return int(n)
