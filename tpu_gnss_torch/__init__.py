"""tpu_gnss_torch — the GPS L1 C/A streaming receiver on PyTorch and CUDA.

A port of :mod:`tpu_gnss` (the JAX reference, which stays beside it) to
PyTorch on NVIDIA Hopper GPUs.  The layout mirrors the reference package
(``ops/``, ``acquire/``, ``track/``, ``io/``, ``cli/``, ``receiver.py``),
so every counterpart is found at the same path.  The two hot kernels —
the fused acquisition correlate-reduce and the tracking correlator — are
hand-written CUDA C++ for ``sm_90a`` in ``csrc/``; each has a plain
PyTorch version beside it that the CPU tests run.

The package imports ``torch`` and numpy, never ``jax`` and nothing of
``tpu_gnss``: it keeps its own copy of the float64 host layer it needs
(``constants``, ``config``, ``signal/cacode``, ``signal/synth``,
``io/loaders``, ``io/stream``, ``nav/``, ``pvt/``, ``cli/nmea_out``),
each file headed by the reference lines it was copied from.
"""

from . import constants
from .config import PRESETS, ReceiverConfig

__version__ = "0.1.0"
__all__ = ["constants", "ReceiverConfig", "PRESETS", "__version__"]
