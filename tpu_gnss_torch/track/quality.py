"""Tracking-quality estimators: C/N0 and lock detectors.

Copied from tpu_gnss/track/quality.py (its package ``__init__`` imports
the jax tracker).  The reference's quality signals are raw power (AGC
hysteresis, c/channel.cpp:265-288) and parity success; these are the
standard quantitative versions used to gate solver inclusion.
"""

from __future__ import annotations

import numpy as np


def cn0_nwpr(ip: np.ndarray, qp: np.ndarray, t_coh: float = 1e-3,
             m: int = 20) -> float:
    """C/N0 estimate (dB-Hz) via the Narrowband/Wideband Power Ratio.

    Args:
      ip/qp: prompt correlator outputs per coherent interval (1 ms).
      t_coh: coherent integration time per sample of ip/qp.
      m: intervals per NWPR block (20 = one NAV bit, so the narrowband
        sum stays within a bit).
    """
    ip = np.asarray(ip, np.float64)
    qp = np.asarray(qp, np.float64)
    k = len(ip) // m
    if k < 2:
        return float("nan")
    ipb = ip[: k * m].reshape(k, m)
    qpb = qp[: k * m].reshape(k, m)
    nbp = ipb.sum(1) ** 2 + qpb.sum(1) ** 2
    wbp = (ipb ** 2 + qpb ** 2).sum(1)
    mu = float(np.mean(nbp / np.maximum(wbp, 1e-30)))
    if mu <= 1.0 or mu >= m:
        return float("nan")
    cn0_lin = (mu - 1.0) / (m - mu) / t_coh
    return float(10.0 * np.log10(cn0_lin))


def pll_lock_metric(ip: np.ndarray, qp: np.ndarray, window: int = 50
                    ) -> float:
    """Costas lock detector in [-1, 1]: (I²-Q²)/(I²+Q²) averaged.

    Near +1 when phase-locked (energy in I), near 0 unlocked.
    """
    ip = np.asarray(ip[-window:], np.float64)
    qp = np.asarray(qp[-window:], np.float64)
    num = (ip * ip - qp * qp).sum()
    den = (ip * ip + qp * qp).sum()
    return float(num / den) if den > 0 else 0.0


def code_lock_metric(e_mag: np.ndarray, l_mag: np.ndarray,
                     p_mag: np.ndarray, window: int = 50) -> float:
    """Prompt-vs-sides ratio: >1.5 when the code is centered on the peak."""
    e = np.asarray(e_mag[-window:], np.float64).mean()
    l = np.asarray(l_mag[-window:], np.float64).mean()
    p = np.asarray(p_mag[-window:], np.float64).mean()
    side = max(0.5 * (e + l), 1e-30)
    return float(p / side)
