# Copied from tpu_gnss/signal/cacode.py:1-168.
"""GPS C/A (Gold) code generation — vectorized over all PRNs.

The reference generates codes one chip at a time with a two-LFSR state
machine (reference: c/cacode.h:9-35) and, for acquisition, resamples them to
the capture rate with fractional-boundary linear interpolation while running
a float NCO (reference: c/search_offline.cpp:74-110).  Here everything is a
precomputed table: the G1/G2 m-sequences are simulated once in numpy and all
32 PRNs fall out of the tap table at once; resampling is a closed-form
exact-arithmetic ramp (no accumulated float drift) that reproduces the same
chip decisions and boundary interpolation.

Tap-pair table: PRN -> G2 output-phase taps, the standard IS-GPS-200
assignment (same data as reference: c/search_offline.cpp:20-53 and
cacode.m:65-101).
"""

from __future__ import annotations

import functools

import numpy as np

from ..constants import CODE_LEN_CHIPS, NUM_SATS

# PRN -> (navstar, T1, T2).  IS-GPS-200 Table 3-I phase-select assignments.
SATELLITES = {
    1: (63, 2, 6), 2: (56, 3, 7), 3: (37, 4, 8), 4: (35, 5, 9),
    5: (64, 1, 9), 6: (36, 2, 10), 7: (62, 1, 8), 8: (44, 2, 9),
    9: (33, 3, 10), 10: (38, 2, 3), 11: (46, 3, 4), 12: (59, 5, 6),
    13: (43, 6, 7), 14: (49, 7, 8), 15: (60, 8, 9), 16: (51, 9, 10),
    17: (57, 1, 4), 18: (50, 2, 5), 19: (54, 3, 6), 20: (47, 4, 7),
    21: (52, 5, 8), 22: (53, 6, 9), 23: (55, 1, 3), 24: (23, 4, 6),
    25: (24, 5, 7), 26: (26, 6, 8), 27: (27, 7, 9), 28: (48, 8, 10),
    29: (61, 1, 6), 30: (39, 2, 7), 31: (58, 3, 8), 32: (22, 4, 9),
}


def taps(prn: int) -> tuple[int, int]:
    """G2 phase-select tap pair for a PRN (1-based register positions)."""
    _, t1, t2 = SATELLITES[prn]
    return t1, t2


def taps_word(prn: int) -> int:
    """Tap pair packed as the live rig's CmdSetSV parameter analog."""
    t1, t2 = taps(prn)
    return t1 | (t2 << 8)


@functools.lru_cache(maxsize=1)
def _lfsr_sequences() -> tuple[np.ndarray, np.ndarray]:
    """Simulate the G1 / G2 registers for one full period.

    Returns ``(g1_out, g2_state)``:
      * ``g1_out[k]``    — G1 output (register position 10) at chip k
      * ``g2_state[k,t]`` — G2 register position t (1..10 at index t-1) at chip k

    Registers start all-ones; G1 feedback taps {3,10}; G2 feedback taps
    {2,3,6,8,9,10} (IS-GPS-200 polynomials; same recurrences as
    reference: c/cacode.h:23-28).
    """
    n = CODE_LEN_CHIPS
    g1 = np.ones(10, dtype=np.uint8)
    g2 = np.ones(10, dtype=np.uint8)
    g1_out = np.empty(n, dtype=np.uint8)
    g2_state = np.empty((n, 10), dtype=np.uint8)
    for k in range(n):
        g1_out[k] = g1[9]
        g2_state[k] = g2
        fb1 = g1[2] ^ g1[9]
        fb2 = g2[1] ^ g2[2] ^ g2[5] ^ g2[7] ^ g2[8] ^ g2[9]
        g1 = np.concatenate(([fb1], g1[:9]))
        g2 = np.concatenate(([fb2], g2[:9]))
    return g1_out, g2_state


@functools.lru_cache(maxsize=1)
def code_table() -> np.ndarray:
    """All 32 C/A codes as a ``[NUM_SATS, 1023]`` uint8 {0,1} chip table.

    Row i is PRN i+1.  Chip value convention matches the reference:
    chip = G1out ^ G2[t1] ^ G2[t2] (reference: c/cacode.h:19-21); a chip of
    1 maps to bipolar −1 (reference: c/search_offline.cpp:68-70).
    """
    g1_out, g2_state = _lfsr_sequences()
    out = np.empty((NUM_SATS, CODE_LEN_CHIPS), dtype=np.uint8)
    for prn in range(1, NUM_SATS + 1):
        t1, t2 = taps(prn)
        out[prn - 1] = g1_out ^ g2_state[:, t1 - 1] ^ g2_state[:, t2 - 1]
    return out


def bipolar(chips: np.ndarray) -> np.ndarray:
    """Map {0,1} chips to {+1,−1} floats (bit 1 -> −1)."""
    return 1.0 - 2.0 * np.asarray(chips, dtype=np.float32)


@functools.lru_cache(maxsize=1)
def g1_state_table() -> np.ndarray:
    """``table[k]`` = 10-bit G1 register word at chip index k.

    Word layout is MSB = register position 10 (oldest bit), matching the
    FPGA readout the reference inverts by brute force in SearchCode
    (reference: c/cacode.h:30-34, c/search_offline.cpp:205-209).  G1 is
    PRN-independent, so one table serves all satellites.
    """
    g1_out, _ = _lfsr_sequences()
    n = CODE_LEN_CHIPS
    idx = (np.arange(n)[:, None] + np.arange(10)[None, :]) % n
    weights = (1 << (9 - np.arange(10))).astype(np.int64)
    return (g1_out[idx].astype(np.int64) * weights).sum(axis=1).astype(np.int32)


@functools.lru_cache(maxsize=1)
def _g1_inverse_table() -> np.ndarray:
    """1024-entry inverse of :func:`g1_state_table` (0 where unreachable)."""
    inv = np.zeros(1024, dtype=np.int32)
    tbl = g1_state_table()
    inv[tbl] = np.arange(CODE_LEN_CHIPS, dtype=np.int32)
    return inv


def chips_from_g1_state(g1_word: int) -> int:
    """Invert a G1 register snapshot to a chip count 0..1022.

    O(1) table lookup replacing the reference's O(n) LFSR replay
    (reference: c/search_offline.cpp:205-209).  Used by the PVT solver to
    turn FPGA-style code-generator snapshots into chips of transmit time.
    """
    return int(_g1_inverse_table()[g1_word & 0x3FF])


def resample(chips: np.ndarray, fs: float, n_samples: int,
             chip_rate: float = 1.023e6) -> np.ndarray:
    """Sample a {0,1} chip sequence at ``fs`` with boundary interpolation.

    Reproduces the acquisition replica construction semantics
    (reference: c/search_offline.cpp:86-103): each output sample holds the
    bipolar chip at the start of the sample period, except when a chip
    boundary falls inside the period, in which case the sample is the
    linear blend ``(1-frac)*prev + frac*next`` with ``frac`` the NCO phase
    past the boundary.  Computed with an exact integer/float64 ramp instead
    of an accumulated float32 NCO.

    Args:
      chips: ``[L]`` or ``[B, L]`` chip array ({0,1}).
      fs: sampling rate, Hz.
      n_samples: output length.
      chip_rate: chips per second.

    Returns:
      float32 bipolar replica, shape ``chips.shape[:-1] + (n_samples,)``.
    """
    chips = np.asarray(chips)
    period = chips.shape[-1]
    ca_rate = chip_rate / fs  # chips per sample
    i = np.arange(n_samples, dtype=np.float64)
    # Chip counter before sample i = boundary crossings during samples 0..i-1.
    phase_end = (i + 1.0) * ca_rate
    c_start = np.floor(i * ca_rate).astype(np.int64)
    c_end = np.floor(phase_end).astype(np.int64)
    crossed = c_end > c_start
    frac = (phase_end - c_end).astype(np.float32)

    cur = bipolar(np.take(chips, c_start % period, axis=-1))
    nxt = bipolar(np.take(chips, (c_start + 1) % period, axis=-1))
    w = np.where(crossed, frac, 0.0).astype(np.float32)
    return cur * (1.0 - w) + nxt * w
