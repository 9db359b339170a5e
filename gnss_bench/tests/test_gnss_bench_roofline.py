"""The operation counts of the rooflines at the e2e and hackrf shapes."""

from __future__ import annotations

import math

import pytest

from gnss_bench import roofline
from gnss_bench.roofline import search, track

H100 = "NVIDIA H100 80GB HBM3"
PRNS = list(range(1, 33))
E2E = dict(fs=2.048e6, fft_len=4096, max_fo=5000.0, n_coherent=4,
           prns=PRNS, num_chans=12)
HACKRF = dict(fs=10e6, fft_len=40000, max_fo=100000.0, n_coherent=4,
              prns=PRNS, num_chans=12)
LOOP = dict(epochs_per_step=10)


def test_search_grid_and_count():
    assert search.grid(E2E) == (41, 32, 2048)
    assert search.grid(HACKRF) == (801, 32, 10000)
    flops, nbytes = search.work(E2E)
    fft = 5 * 2048 * 11
    assert flops == 41 * fft + 41 * 32 * (fft + 10 * 2048)
    assert flops == pytest.approx(0.179e9, rel=0.01)
    assert roofline.bound_s(flops, nbytes, H100) == pytest.approx(
        2.68e-6, rel=0.01)
    flops, nbytes = search.work(HACKRF)
    assert flops == pytest.approx(20.1e9, rel=0.01)
    assert roofline.bound_s(flops, nbytes, H100) == pytest.approx(
        0.300e-3, rel=0.01)


def test_search_bound_under_the_four_step_work():
    # the TF32 four-step's matrix products at the same shapes bound any
    # kernel that computes the search that way from below: the FFT count
    # must not ask for more (e2e 6.45 us, hackrf 854.4 us at 495 TFLOP/s)
    for cfg, four_step_s in ((E2E, 6.45e-6), (HACKRF, 854.4e-6)):
        b = roofline.bound_s(*search.work(cfg), H100)
        assert b < four_step_s


def test_track_count():
    flops, nbytes = track.work(dict(fs=5.456e6, num_chans=12), LOOP)
    assert flops == 12 * 10 * 5456 * 18
    assert nbytes == 8 * 10 * 5456 + 24 * 12 * 10
    b = roofline.bound_s(flops, nbytes, H100)
    assert b == pytest.approx(flops / 67e12)
    assert math.isclose(b, 0.1759e-6, rel_tol=1e-3)


def test_unknown_card_has_no_bound():
    assert roofline.bound_s(1.0, 1.0, "some other card") is None
