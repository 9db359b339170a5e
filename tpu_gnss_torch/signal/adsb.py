# Copied from tpu_gnss/signal/adsb.py:1-247 (the whole module).
"""ADS-B (Mode S 1090ES) waveform synthesis and decode.

The reference repo carries an ADS-B replay side experiment: a GNU Radio
flowgraph (``adsb/adsb_out.grc``) that plays a pre-made waveform file
``adsb_for_hackrf.bin`` (interleaved int8 I/Q) through a HackRF at
2 Msps / 1176.45 MHz (``adsb/adsb_out.grc:97`` file, ``:313`` samp_rate,
``:317`` freq0).  The waveform file itself is a missing large blob — the
reference never shows how it was made.

This module closes that gap from first principles: it *generates* such a
file (Mode S extended-squitter frames — DF17 aircraft identification and
CPR-encoded airborne position — pulse-position-modulated at the Mode S
1 µs bit clock), and provides the inverse (preamble detection, PPM
demodulation, CRC-24 verification, field decode) so the waveform can be
verified in software without a radio, mirroring how the GPS side's
playback loop is closed by ``cli/playback.py loopback``.

Everything here is host-side tooling (numpy), like the other format
converters: ADS-B is a side profile, not part of the GPS compute path.

Format notes (public ICD data, ICAO Annex 10 vol IV / DO-260B):

* Frame: 112 bits = DF(5) CA(3) ICAO(24) ME(56) PI(24).
* PI = CRC-24 over the first 88 bits, generator
  0x1FFF409 (x^24+x^23+...+x^10+x^3+1); a valid frame's remainder over
  all 112 bits is zero.
* PPM: 8 µs preamble (pulses at 0, 1.0, 3.5, 4.5 µs, each 0.5 µs), then
  112 bits at 1 µs/bit — '1' = pulse in the first half, '0' in the
  second.  At 2 Msps each half-bit is exactly one sample.
"""

from __future__ import annotations

import numpy as np

# Mode S parity generator (25-bit), MSB-first.
_CRC_POLY = 0x1FFF409
# 6-bit character set for the identification ME field (index -> char).
_CHARSET = ("#ABCDEFGHIJKLMNOPQRSTUVWXYZ#####"
            " ###############0123456789######")

FS_ADSB = 2e6          # the flowgraph's sample rate (adsb_out.grc:313)
FREQ_ADSB = 1176.45e6  # its HackRF center frequency (adsb_out.grc:317)


def crc24(bits: np.ndarray) -> int:
    """Mode S CRC-24 remainder of an MSB-first bit vector."""
    reg = 0
    for b in np.asarray(bits, dtype=np.uint8):
        reg = (reg << 1) | int(b)
        if reg & (1 << 24):
            reg ^= _CRC_POLY
    # flush 24 zero bits (polynomial division remainder)
    for _ in range(24):
        reg <<= 1
        if reg & (1 << 24):
            reg ^= _CRC_POLY
    return reg & 0xFFFFFF


def _to_bits(value: int, width: int) -> list[int]:
    return [(value >> (width - 1 - i)) & 1 for i in range(width)]


def _frame(icao: int, me_bits: list[int]) -> np.ndarray:
    """Assemble DF17/CA5 + ICAO + ME and append the CRC parity field."""
    assert len(me_bits) == 56
    head = _to_bits(17, 5) + _to_bits(5, 3) + _to_bits(icao & 0xFFFFFF, 24)
    body = np.array(head + me_bits, dtype=np.uint8)
    pi = crc24(body)
    return np.concatenate([body, np.array(_to_bits(pi, 24), np.uint8)])


def frame_identification(icao: int, callsign: str,
                         category: int = 0) -> np.ndarray:
    """DF17 TC=4 aircraft-identification frame (112 bits).

    ``callsign``: up to 8 characters from the Mode S 6-bit set
    (A-Z, 0-9, space); anything else is rejected rather than silently
    encoded as the invalid-character placeholder.
    """
    cs = callsign.upper().ljust(8)[:8]
    bad = sorted({ch for ch in cs
                  if ch not in _CHARSET or ch == "#"})
    if bad or len(callsign) > 8:
        raise ValueError(
            f"callsign {callsign!r}: must be <= 8 chars of A-Z, 0-9, "
            f"space" + (f" (invalid: {''.join(bad)})" if bad else ""))
    me = _to_bits(4, 5) + _to_bits(category, 3)
    for ch in cs:
        me += _to_bits(_CHARSET.index(ch), 6)
    return _frame(icao, me)


def cpr_nl(lat: float) -> int:
    """Longitude-zone count NL(lat) for airborne CPR (NZ=15)."""
    if lat == 0:
        return 59
    a = abs(lat)
    if a >= 87:
        return 2 if a == 87 else 1
    nz = 15
    num = 1 - np.cos(np.pi / (2 * nz))
    den = np.cos(np.pi / 180.0 * a) ** 2
    return int(np.floor(2 * np.pi / np.arccos(1 - num / den)))


def frame_airborne_position(icao: int, lat: float, lon: float,
                            alt_ft: float, odd: bool) -> np.ndarray:
    """DF17 TC=11 airborne-position frame with 17-bit CPR encoding."""
    nb = 1 << 17
    dlat = 360.0 / (59 if odd else 60)
    yz = int(np.floor(nb * (lat % dlat) / dlat + 0.5)) % nb
    nl = max(cpr_nl(lat) - (1 if odd else 0), 1)
    dlon = 360.0 / nl
    xz = int(np.floor(nb * (lon % dlon) / dlon + 0.5)) % nb
    # 12-bit altitude with Q=1 (25 ft LSB): N = (alt + 1000) / 25.
    # The Q=1 encoding spans [-1000, 50175] ft; out-of-range values
    # would silently wrap to a wrong altitude, so reject them (the
    # Q=0 100-ft Gillham encoding above that is out of scope here).
    if not -1000.0 <= alt_ft <= 50175.0:
        raise ValueError(f"alt_ft={alt_ft:g} outside the Q=1 25-ft "
                         "encoding range [-1000, 50175]")
    n = int(round((alt_ft + 1000) / 25.0)) & 0x7FF
    alt12 = _to_bits(n >> 4, 7) + [1] + _to_bits(n & 0xF, 4)
    me = (_to_bits(11, 5) + [0, 0]      # TC=11, surveillance status 0
          + [0] + alt12 + [0]           # single-antenna 0, alt, time 0
          + [1 if odd else 0]
          + _to_bits(yz, 17) + _to_bits(xz, 17))
    return _frame(icao, me)


def cpr_decode_global(even_yz_xz: tuple[int, int],
                      odd_yz_xz: tuple[int, int],
                      use_odd: bool = False) -> tuple[float, float] | None:
    """Globally-unambiguous airborne CPR decode from an even/odd pair.

    Returns (lat, lon) in degrees, or None if the pair straddles a
    latitude-zone boundary (NL mismatch).
    """
    nb = float(1 << 17)
    ye, xe = even_yz_xz
    yo, xo = odd_yz_xz
    cle, clo = ye / nb, yo / nb
    j = int(np.floor(59 * cle - 60 * clo + 0.5))
    lat_e = (360.0 / 60) * ((j % 60) + cle)
    lat_o = (360.0 / 59) * ((j % 59) + clo)
    if lat_e >= 270:
        lat_e -= 360
    if lat_o >= 270:
        lat_o -= 360
    if cpr_nl(lat_e) != cpr_nl(lat_o):
        return None
    lat = lat_o if use_odd else lat_e
    nl = cpr_nl(lat)
    m = int(np.floor((xe / nb) * (nl - 1) - (xo / nb) * nl + 0.5))
    ni = max(nl - (1 if use_odd else 0), 1)
    cl = (xo if use_odd else xe) / nb
    lon = (360.0 / ni) * ((m % ni) + cl)
    if lon >= 180:
        lon -= 360
    return float(lat), float(lon)


def decode_frame(bits: np.ndarray) -> dict:
    """Field decode of a CRC-valid 112-bit DF17 frame."""
    b = np.asarray(bits, dtype=np.uint8)

    def val(lo, hi):  # bit positions, 0-based inclusive/exclusive
        out = 0
        for x in b[lo:hi]:
            out = (out << 1) | int(x)
        return out

    out = {"df": val(0, 5), "icao": val(8, 32), "tc": val(32, 37)}
    if out["tc"] == 4:
        cs = "".join(_CHARSET[val(40 + 6 * i, 46 + 6 * i)] for i in range(8))
        out["callsign"] = cs.strip()
    elif 9 <= out["tc"] <= 18:
        alt12 = val(40, 52)
        if (alt12 >> 4) & 1:  # Q=1: 25 ft LSB
            n = ((alt12 >> 5) << 4) | (alt12 & 0xF)
            out["alt_ft"] = 25 * n - 1000
        out["odd"] = bool(b[53])
        out["cpr"] = (val(54, 71), val(71, 88))
    return out


def modulate(frames: list[np.ndarray], fs: float = FS_ADSB,
             gap_us: float = 100.0, amp: int = 100) -> np.ndarray:
    """PPM-modulate frames into interleaved int8 I/Q at ``fs``.

    Output matches the ``adsb_for_hackrf.bin`` format the reference
    flowgraph streams (interleaved signed bytes, I then Q;
    ``adsb/adsb_out.grc`` file_source -> deinterleave chain).
    """
    spb = fs / 1e6  # samples per microsecond
    if abs(spb - round(spb)) > 1e-9 or int(round(spb)) % 2:
        raise ValueError(f"fs={fs:g}: need an even integer number of "
                         "samples per microsecond for Mode S PPM")
    spb = int(round(spb))
    half = spb // 2
    gap = np.zeros(int(round(gap_us * spb)), np.int8)
    pre = np.zeros(8 * spb, np.int8)
    for t in (0.0, 1.0, 3.5, 4.5):  # preamble pulse starts, µs
        k = int(t * spb)
        pre[k:k + half] = amp
    chunks = [gap]
    for fr in frames:
        data = np.zeros(112 * spb, np.int8)
        for i, bit in enumerate(np.asarray(fr, np.uint8)):
            k = i * spb + (0 if bit else half)
            data[k:k + half] = amp
        chunks += [pre, data, gap]
    i_rail = np.concatenate(chunks)
    iq = np.zeros(2 * len(i_rail), np.int8)
    iq[0::2] = i_rail
    return iq


def demodulate(iq: np.ndarray, fs: float = FS_ADSB) -> list[np.ndarray]:
    """Recover CRC-valid 112-bit frames from an int8 I/Q sample stream."""
    spb = int(round(fs / 1e6))
    half = spb // 2
    mag = np.abs(iq[0::2].astype(np.float32)) + np.abs(
        iq[1::2].astype(np.float32))
    thr = 0.5 * float(mag.max(initial=0.0))
    if thr <= 0:
        return []
    frames = []
    high = [int(t * spb) for t in (0.0, 1.0, 3.5, 4.5)]
    low = [int(t * spb) for t in (0.5, 1.5, 2.0, 2.5, 3.0, 4.0, 5.5, 6.5)]
    n_need = 8 * spb + 112 * spb
    k = 0
    while k <= len(mag) - n_need:
        if (all(mag[k + h] > thr for h in high)
                and all(mag[k + l] < thr for l in low)):
            d = k + 8 * spb
            first = mag[d:d + 112 * spb:spb]
            second = mag[d + half:d + 112 * spb:spb]
            bits = (first > second).astype(np.uint8)
            if crc24(bits) == 0:
                frames.append(bits)
                k += n_need
                continue
        k += 1
    return frames
