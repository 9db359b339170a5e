# Copied from tpu_gnss/io/loaders.py:1-115 (the 1-bit part without
# load_1bit: the numpy unpack path, without the native helper).
"""Capture-file loaders: bit-packed 1-bit real IF files.

Host-side ingest of the reference toolkit's 1-bit format, LSB-first
within each byte (reference: c/search_offline.cpp:121-157), and the
quadrature square-wave mix of its 1-bit front end.
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
