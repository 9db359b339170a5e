"""tpu_gnss_torch — the GPS L1 C/A streaming receiver on PyTorch and CUDA.

A port of :mod:`tpu_gnss` (the JAX reference, which stays beside it) to
PyTorch on NVIDIA Hopper GPUs.  The layout mirrors the reference package
(``ops/``, ``acquire/``, ``track/``, ``io/``, ``cli/``, ``receiver.py``),
so every counterpart is found at the same path.  The two hot kernels —
the fused acquisition correlate-reduce and the tracking correlator — are
hand-written CUDA C++ for ``sm_90a`` in ``csrc/``; each has a plain
PyTorch version beside it that the CPU tests run.

The package imports ``torch`` and never ``jax``.  It reuses the jax-free
float64 host layer of ``tpu_gnss`` (constants, config, C/A codes, signal
synthesis, capture loaders, NAV decode, PVT, NMEA output).
"""

from tpu_gnss import constants
from tpu_gnss.config import PRESETS, ReceiverConfig

__version__ = "0.1.0"
__all__ = ["constants", "ReceiverConfig", "PRESETS", "__version__"]
