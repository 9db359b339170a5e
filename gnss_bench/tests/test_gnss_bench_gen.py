"""The generator on the device against the recipe it rewrites,
``tpu_gnss_torch.signal.scene.build_scene``, at a short duration."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gnss_bench.gen import gps, scene

FS = 2.048e6
DUR = 1.0


@pytest.fixture(scope="module")
def both():
    from tpu_gnss_torch.signal import scene as ref
    iq, ephs, rx = ref.build_scene(duration=DUR, fs=FS, noise=0.0)
    p = scene.plan(DUR, FS)
    return iq, ephs, rx, p


def test_same_truth_and_nav_bits(both):
    from tpu_gnss_torch.nav.ephemeris import encode_subframes
    _, ephs, rx, p = both
    assert np.allclose(p.rx, rx, rtol=0, atol=1e-6)
    n_sf = int(np.ceil(DUR / 6.0)) + 2
    sids = tuple(([4, 1, 2, 3] * ((n_sf + 3) // 4))[:n_sf])
    for sv, eph in zip(p.svs, ephs):
        want = np.concatenate(encode_subframes(
            eph, tow_start=int(sv.sf0 / 6.0) + 1, sids=sids))
        assert np.array_equal(sv.stream, want)
        for name in gps.FIELDS:
            assert getattr(sv.eph, name) == getattr(eph, name)


def test_same_code_phases_and_samples(both):
    iq, _, _, p = both
    got = scene.baseband(p, "cpu").numpy()
    assert got.shape == iq.shape
    # six unit-amplitude SVs: complex64 rounding of the per-SV sums
    assert np.max(np.abs(got - iq)) < 1e-5
    from tpu_gnss_torch.signal import cacode
    for sv, c0 in zip(p.svs, p.code_phases_chips()):
        # the code phase at sample 0 is where the SV's chips start
        assert 0.0 <= c0 < 1023.0
        chips = 1.0 - 2.0 * cacode.code_table()[sv.prn - 1].astype(float)
        k = int(np.floor(c0))
        assert chips[k] in (-1.0, 1.0)


def test_onebit_and_iq8_formats(both):
    from tpu_gnss_torch.io import loaders
    from tpu_gnss_torch.signal import synth
    iq, _, _, p = both
    x = torch.from_numpy(iq)
    got = scene.onebit_bytes(x, FS / 4, FS)
    want = np.frombuffer(loaders.pack_1bit(
        synth.baseband_to_1bit_if(iq, FS / 4, FS)), np.uint8)
    bits = np.unpackbits(got ^ want[: len(got)])
    assert bits.mean() < 1e-5          # signs of |y| ~ 0 only
    raw = scene.iq8_bytes(x, FS, 25000.0)
    # the recipe of the card's smoke test: x100 of the larger rail's
    # peak over sqrt(2), rotated, rounded half to even, clipped
    peak = max(np.abs(iq.real).max(), np.abs(iq.imag).max())
    scale = 100.0 / (peak * np.sqrt(2.0))
    n = np.arange(len(iq), dtype=np.float64)
    r = iq * np.exp(2j * np.pi * ((25000.0 * n / FS) % 1.0))
    want8 = np.empty(2 * len(iq), np.int16)
    want8[0::2] = np.clip(np.rint(r.real * scale), -127, 127)
    want8[1::2] = np.clip(np.rint(r.imag * scale), -127, 127)
    assert np.mean(raw != want8.astype(np.int8)) < 1e-4
    assert np.max(np.abs(raw.astype(int) - want8)) <= 1


def test_noise_follows_the_seed():
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    a = scene.noise(1000, 0.7, g1, "cpu")
    b = scene.noise(1000, 0.7, g2, "cpu")
    assert torch.equal(a, b)
    assert abs(float(a.abs().pow(2).mean()) - 0.49) < 0.1


def test_nav_truth_is_the_icd_quantization(both):
    # the reference quantizes each field from its LSB and width alone;
    # the program's encoder and decoder, round trip, agree with it
    from tpu_gnss_torch.nav.bits import decode_word
    from tpu_gnss_torch.nav.ephemeris import Ephemeris, encode_subframes

    from gnss_bench.ref import check
    _, _, _, p = both
    for sv in p.svs:
        want = check.quantized(sv.eph)
        dec = Ephemeris()
        d29 = d30 = 0
        for tx in encode_subframes(sv.eph, tow_start=1, sids=(1, 2, 3)):
            data = []
            for w in range(10):
                src, d29, d30 = decode_word(tx[30 * w: 30 * w + 30], d29,
                                            d30)
                data.append(src)
            dec.ingest(np.concatenate(data))
        assert want == {name: getattr(dec, name) for name in gps.FIELDS}


def test_nav_truth_refuses_a_field_out_of_range(both):
    import dataclasses

    from gnss_bench.ref import check
    eph = dataclasses.replace(both[3].svs[0].eph, e=1.5)
    with pytest.raises(ValueError, match="e = 1.5"):
        check.quantized(eph)
