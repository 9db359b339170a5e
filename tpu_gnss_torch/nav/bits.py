# Copied from tpu_gnss/nav/bits.py:1-261.
"""NAV bit-stream processing: bit sync, preamble framing, parity.

Host-side numpy (the data rate is 50 bps — this layer's cost is nil; the
reference runs it on the Pi CPU the same way: c/channel.cpp:211-353).

Parity is the IS-GPS-200 (32,26) Hamming code over 30-bit words with the
two carry bits D29*/D30* from the previous word; the XOR index sets below
are ICD Table 20-XIV (the same sets appear in reference: c/channel.cpp:78-88).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..constants import CODES_PER_BIT, PREAMBLE, SUBFRAME_BITS, WORD_BITS

# Data-bit index sets (1-based d1..d24) feeding each parity bit D25..D30.
_PARITY_SETS = (
    (1, 2, 3, 5, 6, 10, 11, 12, 13, 14, 17, 18, 20, 23),
    (2, 3, 4, 6, 7, 11, 12, 13, 14, 15, 18, 19, 21, 24),
    (1, 3, 4, 5, 7, 8, 12, 13, 14, 15, 16, 19, 20, 22),
    (2, 4, 5, 6, 8, 9, 13, 14, 15, 16, 17, 20, 21, 23),
    (1, 3, 5, 6, 7, 9, 10, 14, 15, 16, 17, 18, 21, 22, 24),
    (3, 5, 6, 8, 9, 10, 11, 13, 15, 19, 22, 23, 24),
)
# D29*/D30* participation per parity bit: D25<-D29*, D26<-D30*, D27<-D29*,
# D28<-D30*, D29<-D30*, D30<-D29*
_CARRY = (0, 1, 0, 1, 1, 0)  # 0 -> D29*, 1 -> D30*


def word_parity(source_data: np.ndarray, d29: int, d30: int) -> np.ndarray:
    """D25..D30 for 24 SOURCE data bits (pre-inversion) and carries."""
    d = np.asarray(source_data, dtype=np.uint8)
    out = np.empty(6, dtype=np.uint8)
    carries = (d29, d30)
    for i, idxs in enumerate(_PARITY_SETS):
        out[i] = (carries[_CARRY[i]] + sum(int(d[j - 1]) for j in idxs)) & 1
    return out


def encode_word(source_data: np.ndarray, d29: int, d30: int) -> np.ndarray:
    """Transmitted 30-bit word: data XOR D30*, then computed parity."""
    d = np.asarray(source_data, dtype=np.uint8)
    tx = (d ^ d30).astype(np.uint8)
    return np.concatenate([tx, word_parity(d, d29, d30)])


def decode_word(rx_word: np.ndarray, d29: int, d30: int
                ) -> tuple[Optional[np.ndarray], int, int]:
    """Recover source data from a received 30-bit word; None if parity fails.

    Returns (source_data_24 | None, new_D29, new_D30).
    """
    rx = np.asarray(rx_word, dtype=np.uint8)
    src = (rx[:24] ^ d30).astype(np.uint8)
    want = word_parity(src, d29, d30)
    if not np.array_equal(want, rx[24:30]):
        return None, int(rx[28]), int(rx[29])
    return src, int(rx[28]), int(rx[29])


def check_subframe(bits300: np.ndarray, d29: int, d30: int
                   ) -> Optional[np.ndarray]:
    """Parity-check ten words; return 240 source data bits or None.

    ``d29``/``d30`` seed the first word's carries — from the previous
    subframe when streaming, or from the preamble polarity on cold frame
    sync (0,0 upright / 1,1 inverted, exactly the reference's seeding,
    reference: c/channel.cpp:333-334).
    """
    out = np.empty(240, dtype=np.uint8)
    for w in range(10):
        src, d29, d30 = decode_word(bits300[w * 30:(w + 1) * 30], d29, d30)
        if src is None:
            return None
        out[w * 24:(w + 1) * 24] = src
    return out


def frame_sync(bits: np.ndarray) -> list[dict]:
    """Find parity-valid subframes in a {0,1} NAV bit stream.

    Scans for upright/inverted preambles and validates all ten words,
    mirroring the reference's framing loop (reference: c/channel.cpp:329-353
    ParityCheck) but over a whole buffer at once.  Returns records with
    ``start`` (bit index), ``inverted``, and ``data`` (240 source bits).
    """
    bits = np.asarray(bits, dtype=np.uint8)
    pre = np.asarray(PREAMBLE, dtype=np.uint8)
    n = len(bits)
    out = []
    i = 0
    while i + SUBFRAME_BITS <= n:
        win = bits[i:i + 8]
        inverted = None
        if np.array_equal(win, pre):
            inverted = False
        elif np.array_equal(win, 1 - pre):
            inverted = True
        if inverted is None:
            i += 1
            continue
        seed = 1 if inverted else 0
        data = check_subframe(bits[i:i + SUBFRAME_BITS], seed, seed)
        if data is None:
            i += 1
            continue
        out.append(dict(start=i, inverted=inverted, data=data))
        i += SUBFRAME_BITS
    return out


# ---------------------------------------------------------------------------
# Bit synchronization (1 ms prompt stream -> 20 ms NAV bits)
# ---------------------------------------------------------------------------

def bit_sync(prompt_ip: np.ndarray) -> int:
    """Estimate the ms-offset of NAV bit boundaries in a prompt-I stream.

    Histogram of sign-transition positions mod 20 — the software analog of
    the embedded CPU's transition counting.  Returns offset in [0, 20):
    epochs ``offset + 20k`` begin new bits.
    """
    ip = np.asarray(prompt_ip)
    s = np.sign(ip)
    flips = np.nonzero(s[1:] * s[:-1] < 0)[0] + 1
    if len(flips) == 0:
        return 0
    hist = np.bincount(flips % CODES_PER_BIT, minlength=CODES_PER_BIT)
    return int(hist.argmax())


def bits_from_prompt(prompt_ip: np.ndarray, offset: int) -> np.ndarray:
    """Integrate 20 prompt-I epochs per NAV bit -> {0,1} bit array.

    Convention: a POSITIVE integrated prompt maps to bit 0 (polarity is
    resolved downstream by the preamble/parity framing, as in the
    reference).
    """
    ip = np.asarray(prompt_ip)[offset:]
    n_bits = len(ip) // CODES_PER_BIT
    acc = ip[: n_bits * CODES_PER_BIT].reshape(n_bits, CODES_PER_BIT).sum(1)
    return (acc < 0).astype(np.uint8)


# ---------------------------------------------------------------------------
# Code-period-indexed bit grid (drift-immune, for transmit-time anchors)
# ---------------------------------------------------------------------------

def bit_sync_periods(prompt_ip: np.ndarray, periods: np.ndarray) -> int:
    """Bit-grid phase on the CODE-PERIOD grid: r in [0, 20).

    ``periods[e] = round(chips[e]/1023)`` — the tracked code-period
    index each 1 ms epoch samples.  Binning sign transitions by
    ``periods mod 20`` instead of ``epoch mod 20`` ties the NAV bit grid
    to the transmitted signal's own period clock: code creep (Doppler)
    slides the epoch grid through the period grid by a full ms over
    minutes, which silently shifts an epoch-based offset by one — a
    whole-code-period (±300 km) transmit-time error — while the
    period-based phase is invariant.  Bit edges sit at periods
    ``r + 20k`` exactly.
    """
    ip = np.asarray(prompt_ip)
    s = np.sign(ip)
    flips = np.nonzero(s[1:] * s[:-1] < 0)[0] + 1
    if len(flips) == 0:
        return 0
    hist = np.bincount(np.asarray(periods)[flips] % CODES_PER_BIT,
                       minlength=CODES_PER_BIT)
    return int(hist.argmax())


def bits_from_prompt_periods(prompt_ip: np.ndarray, periods: np.ndarray,
                             r: int):
    """Per-bit integration on the period grid.

    Returns ``(bits, b_raw0)``: ``bits[i]`` is the {0,1} NAV bit whose
    FIRST code period has absolute period index
    ``r + 20*(b_raw0 + i)`` — i.e., whose first chip is
    ``(r + 20*(b_raw0 + i)) * 1023`` on the channel's chip-integral
    scale (the unambiguous transmit-time anchor).  The leading partial
    bit is dropped.
    """
    ip = np.asarray(prompt_ip)
    b_raw = (np.asarray(periods, dtype=np.int64) - r) // CODES_PER_BIT
    b0 = int(b_raw[0])
    # drop the leading bit iff the stream does not start on a bit edge
    first_full = (b0 + 1 if (periods[0] - r) % CODES_PER_BIT != 0
                  else b0)
    n_bits = int(b_raw[-1]) - first_full  # last bit may be partial: drop
    if n_bits <= 0:
        return np.zeros(0, np.uint8), first_full
    acc = np.zeros(n_bits, np.float64)
    idx = b_raw - first_full
    ok = (idx >= 0) & (idx < n_bits)
    np.add.at(acc, idx[ok], ip[ok])
    return (acc < 0).astype(np.uint8), first_full


def partial_anchors(bits: np.ndarray) -> list[dict]:
    """TOW anchors from a preamble + parity-valid TLM/HOW pair at the
    stream TAIL, before the full 300-bit subframe has arrived.

    A warm/hot-started receiver (valid ephemerides from a checkpoint)
    only needs one TOW to anchor transmit time; waiting for the whole
    subframe costs ~4.8 extra seconds of live time-to-first-fix.  Real
    receivers anchor on the HOW exactly like this.  Only positions where
    the full subframe does NOT fit in ``bits`` are considered — complete
    subframes are :func:`frame_sync`'s job (and carry ephemeris data).

    False-anchor safety: 8-bit preamble + two parity-valid words is 20
    checked bits (~1e-6 per position); downstream the anchor still has
    to win the receiver's 1 ms transmit-time cluster vote against the
    channel's full-subframe anchors.

    Returns [{start, tow, inverted}] with ``tow`` = the HOW TOW count
    (time of NEXT subframe start / 6 s — the same convention as
    :func:`tpu_gnss.nav.ephemeris.tow_count`).
    """
    bits = np.asarray(bits, dtype=np.uint8)
    pre = np.asarray(PREAMBLE, dtype=np.uint8)
    n = len(bits)
    out = []
    i = max(0, n - SUBFRAME_BITS + 1)
    while i + 2 * WORD_BITS <= n:
        win = bits[i:i + 8]
        inverted = None
        if np.array_equal(win, pre):
            inverted = False
        elif np.array_equal(win, 1 - pre):
            inverted = True
        if inverted is None:
            i += 1
            continue
        seed = 1 if inverted else 0
        src1, d29, d30 = decode_word(bits[i:i + WORD_BITS], seed, seed)
        if src1 is None:
            i += 1
            continue
        src2, _, _ = decode_word(bits[i + WORD_BITS:i + 2 * WORD_BITS],
                                 d29, d30)
        if src2 is None:
            i += 1
            continue
        tow = 0
        for b in src2[:17]:          # HOW word source bits 1..17, MSB first
            tow = (tow << 1) | int(b)
        # ICD range gate: TOW counts run 0..100799 (604800 s / 6 s); a
        # noise-induced preamble+parity coincidence (only ~20 checked
        # bits here vs the full subframe's ten-word parity) must not
        # plant an out-of-week anchor.  0 is also rejected: it can only
        # name the week-rollover subframe and is the most likely
        # all-zero junk value.
        if not (0 < tow <= 100799):
            i += 1
            continue
        out.append(dict(start=i, tow=tow, inverted=inverted))
        i += 2 * WORD_BITS
    return out
