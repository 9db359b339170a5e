# Copied from tpu_gnss/cli/nmea.py:1-367 (the whole module).
"""NMEA-0183 ingest, monitoring, and fix comparison.

The reference ships 18 near-identical curses scripts that parse NMEA from
serial receivers to validate replayed signals (reference: python/
plot_nmea*.py; e.g. plot_nmea8-ttyACM0-GPS.py — GSV block assembly
:195-209, GGA/GSA/GST/VTG/RMC parsing :84-159, PRN->constellation mapping
:32-50).  This module is the single equivalent utility: a sentence parser,
a stream monitor (file, pipe, or serial port), and a comparator between an
NMEA track and this framework's PVT solutions.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from typing import Iterator, Optional

import numpy as np


def checksum_ok(sentence: str) -> bool:
    """Validate the *hh NMEA checksum (sentences without one pass)."""
    s = sentence.strip()
    if not s.startswith("$"):
        return False
    if "*" not in s:
        return True
    body, _, want = s[1:].partition("*")
    c = 0
    for ch in body:
        c ^= ord(ch)
    try:
        return c == int(want[:2], 16)
    except ValueError:
        return False


def prn_constellation(prn: int, talker: str = "GP") -> str:
    """PRN/talker -> constellation name.

    Same mapping as the reference's monitors
    (plot_nmea8-ttyACM0-GPS.py:32-50).
    """
    if talker == "GL" or 65 <= prn <= 96:
        return "GLONASS"
    if talker == "GA":
        return "Galileo"
    if talker in ("GB", "BD"):
        return "BeiDou"
    if talker == "GQ":
        return "QZSS"
    if 1 <= prn <= 32:
        return "GPS"
    if 33 <= prn <= 64:
        return "SBAS"
    if 193 <= prn <= 202:
        return "QZSS"
    return "?"


def _f(x: str) -> Optional[float]:
    try:
        return float(x)
    except (TypeError, ValueError):
        return None


def _latlon(val: str, hemi: str) -> Optional[float]:
    """ddmm.mmmm / dddmm.mmmm -> signed degrees."""
    v = _f(val)
    if v is None:
        return None
    deg = int(v // 100)
    minutes = v - deg * 100
    out = deg + minutes / 60.0
    if hemi in ("S", "W"):
        out = -out
    return out


@dataclasses.dataclass
class NmeaState:
    """Accumulated receiver state from a sentence stream."""
    lat: Optional[float] = None
    lon: Optional[float] = None
    alt: Optional[float] = None
    time_utc: Optional[str] = None
    date: Optional[str] = None
    fix_quality: int = 0
    n_sats_used: int = 0
    hdop: Optional[float] = None
    pdop: Optional[float] = None
    vdop: Optional[float] = None
    speed_kmh: Optional[float] = None
    course_deg: Optional[float] = None
    lat_err_m: Optional[float] = None
    lon_err_m: Optional[float] = None
    alt_err_m: Optional[float] = None
    used_prns: list = dataclasses.field(default_factory=list)
    sats_in_view: dict = dataclasses.field(default_factory=dict)
    _gsv_partial: dict = dataclasses.field(default_factory=dict)
    fixes: list = dataclasses.field(default_factory=list)

    # ------------------------------------------------------------------
    def feed(self, sentence: str) -> bool:
        """Ingest one sentence; returns True if it updated state."""
        s = sentence.strip()
        if not checksum_ok(s):
            return False
        body = s[1:].split("*")[0]
        parts = body.split(",")
        tag = parts[0]
        talker, typ = tag[:2], tag[2:]
        if typ == "GGA":
            return self._gga(parts)
        if typ == "GSA":
            return self._gsa(parts)
        if typ == "GSV":
            return self._gsv(talker, parts)
        if typ == "RMC":
            return self._rmc(parts)
        if typ == "VTG":
            return self._vtg(parts)
        if typ == "GST":
            return self._gst(parts)
        return False

    def _gga(self, p) -> bool:
        if len(p) < 10:
            return False
        self.time_utc = p[1] or self.time_utc
        lat = _latlon(p[2], p[3])
        lon = _latlon(p[4], p[5])
        self.fix_quality = int(p[6] or 0)
        self.n_sats_used = int(p[7] or 0)
        self.hdop = _f(p[8])
        if lat is not None and lon is not None:
            # a no-fix GGA (empty position fields) keeps the last known
            # position, like the reference monitors do
            self.lat, self.lon = lat, lon
            self.alt = _f(p[9])
            self.fixes.append((self.time_utc, self.lat, self.lon, self.alt))
        return True

    def _gsa(self, p) -> bool:
        if len(p) < 18:
            return False
        self.used_prns = [int(x) for x in p[3:15] if x]
        self.pdop, self.hdop, self.vdop = _f(p[15]), _f(p[16]), _f(p[17])
        return True

    def _gsv(self, talker, p) -> bool:
        # multi-sentence group assembly (plot_nmea8:195-209 analog)
        if len(p) < 4:
            return False
        total, idx = int(p[1] or 0), int(p[2] or 0)
        key = talker
        if idx == 1:
            self._gsv_partial[key] = {}
        store = self._gsv_partial.setdefault(key, {})
        for i in range(4, min(len(p) - 3, 16) + 1, 4):
            if i + 3 >= len(p) + 1:
                break
            fields = p[i:i + 4]
            if len(fields) < 4 or not fields[0]:
                continue
            prn = int(fields[0])
            store[prn] = dict(
                elev=_f(fields[1]), az=_f(fields[2]), snr=_f(fields[3]),
                constellation=prn_constellation(prn, talker))
        if idx == total:
            self.sats_in_view[key] = dict(store)
        return True

    def _rmc(self, p) -> bool:
        if len(p) < 10:
            return False
        self.time_utc = p[1] or self.time_utc
        if p[2] == "A":
            self.lat = _latlon(p[3], p[4])
            self.lon = _latlon(p[5], p[6])
        sp = _f(p[7])
        if sp is not None:
            self.speed_kmh = sp * 1.852
        c = _f(p[8])
        if c is not None:
            self.course_deg = c
        self.date = p[9] or self.date
        return True

    def _vtg(self, p) -> bool:
        if len(p) < 8:
            return False
        c = _f(p[1])
        if c is not None:   # 0.0 (due north) is a valid course
            self.course_deg = c
        k = _f(p[7])
        if k is not None:
            self.speed_kmh = k
        return True

    def _gst(self, p) -> bool:
        if len(p) < 9:
            return False
        self.lat_err_m, self.lon_err_m, self.alt_err_m = (
            _f(p[6]), _f(p[7]), _f(p[8]))
        return True

    # ------------------------------------------------------------------
    def summary(self) -> str:
        lines = [
            f"fix q={self.fix_quality} sats={self.n_sats_used} "
            f"hdop={self.hdop} pdop={self.pdop}",
            f"pos: lat={self.lat} lon={self.lon} alt={self.alt}",
            f"vel: {self.speed_kmh} km/h @ {self.course_deg} deg",
            f"acc: lat±{self.lat_err_m} lon±{self.lon_err_m} "
            f"alt±{self.alt_err_m} m",
            f"used PRNs: {self.used_prns}",
        ]
        for talker, sats in sorted(self.sats_in_view.items()):
            row = ", ".join(
                f"{p}({v['constellation'][:3]}:{v['snr'] or '-'})"
                for p, v in sorted(sats.items()))
            lines.append(f"in view [{talker}]: {row}")
        return "\n".join(lines)


def read_sentences(source) -> Iterator[str]:
    """Yield NMEA sentences from a path, file object, or serial device."""
    if isinstance(source, str):
        if source.startswith("/dev/"):
            try:
                import serial  # pyserial, as the reference monitors use
                with serial.Serial(source, 9600, timeout=1) as port:
                    while True:
                        line = port.readline().decode("ascii", "ignore")
                        if line:
                            yield line
            except ImportError as e:
                raise RuntimeError("pyserial not available") from e
            return
        with open(source, "r", errors="ignore") as f:
            yield from f
    else:
        yield from source


def compare_tracks(nmea_fixes, solutions) -> dict:
    """Compare an NMEA fix track against framework PVT solutions.

    Returns offset statistics in meters (flat-earth at the mean latitude)
    — the quantitative version of the reference's by-eye comparison of a
    commercial receiver against replayed signals.
    """
    if not nmea_fixes or not solutions:
        return dict(n=0)
    nm = np.array([(f[1], f[2]) for f in nmea_fixes])
    sols = np.array([(s.lat_deg, s.lon_deg) for s in solutions])
    lat0 = np.radians(nm[:, 0].mean())
    m_per_deg_lat = 111132.0
    m_per_deg_lon = 111320.0 * np.cos(lat0)
    d_lat = (sols[:, 0].mean() - nm[:, 0].mean()) * m_per_deg_lat
    d_lon = (sols[:, 1].mean() - nm[:, 1].mean()) * m_per_deg_lon
    return dict(n=min(len(nm), len(sols)), d_north_m=float(d_lat),
                d_east_m=float(d_lon),
                d_total_m=float(np.hypot(d_lat, d_lon)))


def live_monitor(source, st: "NmeaState") -> int:
    """Full-screen continuously-redrawing curses dashboard.

    The reference's operator ergonomics: its 18 plot_nmea* scripts are
    curses apps redrawing a satellite table + fix panel on every
    sentence (reference: python/plot_nmea8-ttyACM0-GPS.py:222-283).
    One consolidated monitor here; 'q' quits (when the NMEA stream is a
    file/serial port — with stdin as the source, the keyboard IS the
    stream, so key polling is disabled and Ctrl-C ends the monitor:
    curses must not steal bytes from the sentences it is displaying).
    """
    import curses
    import sys as _sys

    poll_keys = source is not _sys.stdin

    def _run(scr):
        curses.use_default_colors()
        scr.nodelay(True)
        n = 0
        for line in read_sentences(source):
            if not st.feed(line):
                continue
            n += 1
            scr.erase()
            rows, cols = scr.getmaxyx()
            head = (f"-- nmea live monitor -- sentences: {n}  "
                    + ("(q quits)" if poll_keys else "(Ctrl-C quits)"))
            lines = [head, ""] + st.summary().splitlines()
            for i, ln in enumerate(lines[: rows - 1]):
                try:
                    scr.addstr(i, 0, ln[: cols - 1])
                except curses.error:
                    pass
            scr.refresh()
            if poll_keys and scr.getch() in (ord("q"), ord("Q")):
                return
    curses.wrapper(_run)
    print(st.summary())
    return 0


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="nmea_monitor",
        description="NMEA stream monitor / track comparison "
                    "(replaces the reference's plot_nmea* scripts)")
    p.add_argument("source", help="NMEA file, '-' for stdin, or /dev/tty*")
    p.add_argument("--live", action="store_true",
                   help="full-screen curses dashboard redrawn per "
                        "sentence (the reference plot_nmea* style); "
                        "falls back to periodic printing off-terminal")
    p.add_argument("--every", type=int, default=20,
                   help="print a dashboard every N sentences")
    p.add_argument("--compare", metavar="OTHER.nmea", default=None,
                   help="compare SOURCE's fix track against a second "
                        "NMEA file (e.g. a commercial receiver's log vs "
                        "our run_receiver --nmea-out) and print offset "
                        "statistics in meters")
    args = p.parse_args(argv)

    if args.compare:
        tracks = []
        for path in (args.source, args.compare):
            st = NmeaState()
            for line in read_sentences(path):
                st.feed(line)
            tracks.append(st.fixes)

        class _Fix:   # adapt fix tuples to compare_tracks' solution shape
            def __init__(self, f):
                self.lat_deg, self.lon_deg = f[1], f[2]

        cmp = compare_tracks(tracks[0], [_Fix(f) for f in tracks[1]])
        print(json.dumps(cmp))
        return 0 if cmp.get("n") else 1

    st = NmeaState()
    src = sys.stdin if args.source == "-" else args.source
    if args.live:
        try:
            return live_monitor(src, st)
        except Exception as e:   # no terminal (CI, pipe): periodic mode
            print(f"# live mode unavailable ({e}); periodic fallback",
                  file=sys.stderr)
    n = 0
    for line in read_sentences(src):
        if st.feed(line):
            n += 1
            if n % args.every == 0:
                print("\n" + st.summary())
    print("\n" + st.summary())
    return 0


if __name__ == "__main__":
    sys.exit(main())
