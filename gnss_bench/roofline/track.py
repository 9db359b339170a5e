"""One tracking step's operation: for every channel of the bank and
every 1 ms epoch of the step, the carrier wipe-off of the epoch's
samples and three code taps (early, prompt, late), in the time domain.

Per sample: 6 floating-point operations for the complex wipe and 4 for
each of the three taps (a complex sample times a real chip, accumulated),
in float32.  Bytes: the step's samples read once (complex64) and the
taps written once.  The loop filter's few operations per channel are
left out: the count is a floor on any implementation's work.
"""

from __future__ import annotations


def work(cfg: dict, loop: dict) -> tuple[float, float]:
    """``(flops, bytes)`` of one step of the channel bank."""
    p = round(cfg["fs"] * 1e-3)
    e_sub = loop["epochs_per_step"]
    n_chan = cfg["num_chans"]
    flops = n_chan * e_sub * p * (6.0 + 3 * 4.0)
    nbytes = 8.0 * e_sub * p + 24.0 * n_chan * e_sub
    return flops, nbytes
