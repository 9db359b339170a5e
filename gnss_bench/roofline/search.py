"""The cold search's operation: for every Doppler row, the circular
correlation of one period of the folded block with each PRN's code, its
power and its peak.

Counted at its FFT minimum, whatever implements it: a forward transform
of P points per row and an inverse one per row and PRN at 5 N log2 N
floating-point operations each, the spectrum products (6 per complex
point), the power (3 per lag) and the peak (1 per lag), in float32.
Bytes: the samples read once and the codes' spectra read once, the
per-PRN peaks written once.  P is the period itself, the shortest
transform the correlation needs, so that no implementation that the
correctness check admits can read above 100%.
"""

from __future__ import annotations

import math


def grid(cfg: dict) -> tuple[int, int, int]:
    """``(rows, prns, P)`` of one search of configuration ``cfg``."""
    p = int(cfg["fs"] / 1000)
    step = min(cfg["fs"] / cfg["fft_len"], 1000.0 / cfg["n_coherent"])
    rows = 2 * int(cfg["max_fo"] / step) + 1
    return rows, len(cfg["prns"]), p


def work(cfg: dict) -> tuple[float, float]:
    """``(flops, bytes)`` of one single-block search."""
    rows, prns, p = grid(cfg)
    fft = 5.0 * p * math.log2(p)
    flops = rows * fft + rows * prns * (fft + 6.0 * p + 3.0 * p + p)
    nbytes = 8.0 * cfg["n_coherent"] * p + 8.0 * prns * p + 12.0 * prns
    return flops, nbytes
