# Copied from tpu_gnss/constants.py:1-37.
"""GPS L1 C/A and WGS-84 constants.

Values match the reference parameter headers (reference: c/gps.h:15-43,
c/gps_offline.h:15-44) and IS-GPS-200.  These are physical / ICD constants,
not tunables — tunables live in :mod:`tpu_gnss.config`.
"""

# --- Signal structure ------------------------------------------------------
L1_HZ = 1575.42e6        # L1 carrier frequency
CHIP_RATE_HZ = 1.023e6   # C/A code chip rate (CPS in the reference)
CODE_LEN_CHIPS = 1023    # chips per C/A code period
CODE_PERIOD_S = 1e-3     # one code period = 1 ms
NAV_BPS = 50.0           # NAV data bit rate
CODES_PER_BIT = 20       # C/A periods per NAV bit
NUM_SATS = 32            # GPS PRNs 1..32
SUBFRAME_BITS = 300      # bits per NAV subframe (10 words x 30 bits)
WORD_BITS = 30
DATA_BITS_PER_WORD = 24

# --- Official GPS / WGS-84 constants (reference: c/gps.h:33-43) -----------
PI_GPS = 3.1415926535898          # ICD value of pi
MU_EARTH = 3.986005e14            # WGS-84 gravitational constant for GPS user
OMEGA_E = 7.2921151467e-5         # WGS-84 earth rotation rate (rad/s)
SPEED_OF_LIGHT = 2.99792458e8
F_REL = -4.442807633e-10          # -2*sqrt(MU)/c^2 (relativistic clock term)

# --- WGS-84 ellipsoid (reference: c/solve.cpp:17-20) ----------------------
WGS84_A = 6378137.0
WGS84_F_INV = 298.257223563
WGS84_B = 6356752.31424518
WGS84_E2 = 0.00669437999014132

# --- NAV framing (reference: c/channel.cpp:75-76) -------------------------
PREAMBLE = (1, 0, 0, 0, 1, 0, 1, 1)   # 8-bit TLM preamble, upright
SECONDS_PER_WEEK = 604800
HALF_WEEK = 302400
SUBFRAME_PERIOD_S = 6.0
