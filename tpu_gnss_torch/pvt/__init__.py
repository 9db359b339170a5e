# Copied from tpu_gnss/pvt/__init__.py:1-1.
from . import solve, iono
