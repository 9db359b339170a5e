"""The port's ADS-B waveform synthesis and decode against the reference's.

The golden vectors and CRC of tests/test_playback.py:134, the waveform
round trip and the input validation run on ``tpu_gnss_torch.signal.adsb``,
and its frames, waveform, demodulated frames, field decode and global CPR
decode equal ``tpu_gnss.signal.adsb``'s on the same inputs.
"""

import numpy as np
import pytest

from tpu_gnss.signal import adsb as ref
from tpu_gnss_torch.signal import adsb


def _hexbits(h):
    v = int(h, 16)
    n = len(h) * 4
    return np.array([(v >> (n - 1 - i)) & 1 for i in range(n)], np.uint8)


GOLDEN = ["8D4840D6202CC371C32CE0576098", "8D40621D58C382D690C8AC2863A7",
          "8D40621D58C386435CC412692AD6"]


def test_crc_and_decode_golden_vectors():
    """Mode S CRC-24 and field decode of published example messages."""
    ident, even, odd = (_hexbits(h) for h in GOLDEN)
    for fr in (ident, even, odd):
        assert adsb.crc24(fr) == 0
        assert adsb.decode_frame(fr) == ref.decode_frame(fr)
    d = adsb.decode_frame(ident)
    assert d["df"] == 17 and d["icao"] == 0x4840D6
    assert d["callsign"] == "KLM1023"
    de, do = adsb.decode_frame(even), adsb.decode_frame(odd)
    assert de["alt_ft"] == 38000 and not de["odd"] and do["odd"]
    lat, lon = adsb.cpr_decode_global(de["cpr"], do["cpr"])
    assert (lat, lon) == ref.cpr_decode_global(de["cpr"], do["cpr"])
    assert abs(lat - 52.2572) < 1e-3 and abs(lon - 3.91937) < 1e-3


@pytest.mark.parametrize("icao,callsign,lat,lon,alt", [
    (0x3C6444, "TPU9TST", 51.9, -1.25, 12000),
    (0xABCDEF, "TPUGNSS1", 52.2572, 3.9194, 38000),
    (0x000001, "A1", -33.9, 151.2, -1000),
])
def test_frames_waveform_and_decode_equal(icao, callsign, lat, lon, alt):
    frames = [adsb.frame_identification(icao, callsign),
              adsb.frame_airborne_position(icao, lat, lon, alt, odd=False),
              adsb.frame_airborne_position(icao, lat, lon, alt, odd=True)]
    want = [ref.frame_identification(icao, callsign),
            ref.frame_airborne_position(icao, lat, lon, alt, odd=False),
            ref.frame_airborne_position(icao, lat, lon, alt, odd=True)]
    for a, b in zip(frames, want):
        np.testing.assert_array_equal(a, b)
        assert adsb.crc24(a) == ref.crc24(b) == 0
    iq = adsb.modulate(frames * 2, gap_us=50.0)
    np.testing.assert_array_equal(iq, ref.modulate(want * 2, gap_us=50.0))
    got = adsb.demodulate(iq)
    assert len(got) == 6
    for a, b in zip(got, ref.demodulate(iq)):
        np.testing.assert_array_equal(a, b)
    dec = [adsb.decode_frame(fr) for fr in got[:3]]
    assert dec == [ref.decode_frame(fr) for fr in got[:3]]
    assert dec[0]["callsign"] == callsign and dec[1]["alt_ft"] == alt
    pos = adsb.cpr_decode_global(dec[1]["cpr"], dec[2]["cpr"])
    assert pos == ref.cpr_decode_global(dec[1]["cpr"], dec[2]["cpr"])
    assert abs(pos[0] - lat) < 1e-3 and abs(pos[1] - lon) < 1e-3
    assert adsb.cpr_nl(lat) == ref.cpr_nl(lat)


def test_input_validation():
    """tests/test_playback.py:195 on the port's module."""
    with pytest.raises(ValueError, match="50175"):
        adsb.frame_airborne_position(0xABCDEF, 52.0, 4.0, 60000, odd=False)
    with pytest.raises(ValueError, match="AIR-25"):
        adsb.frame_identification(0xABCDEF, "AIR-25")
    with pytest.raises(ValueError, match="callsign"):
        adsb.frame_identification(0xABCDEF, "AB#")
