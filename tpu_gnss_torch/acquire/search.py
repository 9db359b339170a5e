"""Device-side quadrature mixing of 1-bit samples.

Only the front-end mix of :mod:`tpu_gnss.acquire.search`
(``mix_baseband``, ``_phase_mod4``, tpu_gnss/acquire/search.py:85-127)
is ported so far; the exact-semantics ``Searcher`` is not.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.loaders import LO_TABLES


def mix_baseband(bits: torch.Tensor, lo_rate: float,
                 phase0_quarters: float = 0.0) -> torch.Tensor:
    """Quadrature square-wave downconversion of {0,1} samples on device.

    Same math as :func:`tpu_gnss.io.loaders.mix_1bit_block` with the
    offline LO table, the only one the port's callers use.
    ``phase0_quarters``: LO phase of the first sample in quarter cycles,
    computed by callers on the host as ``(sample0 * lo_rate) % 4.0`` in
    float64 (exact for any capture length).
    """
    i_tbl, q_tbl = LO_TABLES["offline"]
    dev = bits.device
    n = bits.shape[-1]
    i_lo = torch.arange(n, dtype=torch.int32, device=dev)
    phase = (_phase_mod4(i_lo, lo_rate)
             + torch.tensor(phase0_quarters, dtype=torch.float32)) % 4.0
    p = phase.to(torch.int64)
    s = (1 - 2 * bits.to(torch.int32)).to(torch.float32)
    itab = torch.from_numpy(1.0 - 2.0 * np.asarray(i_tbl, np.float32)).to(dev)
    qtab = torch.from_numpy(1.0 - 2.0 * np.asarray(q_tbl, np.float32)).to(dev)
    return torch.complex(s * itab[p], s * qtab[p])


PHASE_SPLIT = 4096   # K of _phase_mod4; csrc/mix_packed.cu uses the same


def _phase_mod4(i: torch.Tensor, lo_rate: float) -> torch.Tensor:
    """((i * lo_rate) mod 4) with float32-safe range reduction.

    Splits i = q*K + r (K = 4096) so each product stays small enough that
    float32 keeps the fractional phase accurate over multi-second blocks.
    """
    K = PHASE_SPLIT
    q, r = i // K, i % K
    part1 = (q.to(torch.float32)
             * torch.tensor((K * lo_rate) % 4.0, dtype=torch.float32)) % 4.0
    part2 = (r.to(torch.float32)
             * torch.tensor(lo_rate, dtype=torch.float32)) % 4.0
    return (part1 + part2) % 4.0
