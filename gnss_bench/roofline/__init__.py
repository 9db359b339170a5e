"""Operation and byte counts of the kernels' operations, one module per
operation, and the bound they set on the card's published peaks."""

from __future__ import annotations

import json
import os

_PEAKS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "peaks.json")


def bound_s(flops: float, nbytes: float, kind: str):
    """The least time the card ``kind`` could take for ``flops`` float32
    operations and ``nbytes`` of memory traffic: the larger of the two
    over their peaks; None for a card the table does not hold."""
    with open(_PEAKS) as f:
        peak = json.load(f).get(kind)
    if peak is None:
        return None
    return max(flops / peak["fp32_flops_per_s"],
               nbytes / peak["hbm_bytes_per_s"])
