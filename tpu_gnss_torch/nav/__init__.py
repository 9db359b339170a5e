# Copied from tpu_gnss/nav/__init__.py:1-1.
from . import almanac, bits, ephemeris
