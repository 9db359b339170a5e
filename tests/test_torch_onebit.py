"""Port's packed 1-bit frontend vs the JAX one, bit for bit.

Mirrors tests/test_onebit.py::test_mix_packed_matches_mix_baseband,
::test_mix_packed_phase_continuity and ::test_mix_packed_pallas_interpret.
Every comparison is exact (``assert_array_equal``): the outputs are ±1
and both packages compute the LO phase index with the same float32
operations.  Against the Pallas kernel (interpret mode) only at lo_rate
3.0 and 1.0, where its own per-level range reduction is exact too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gnss.acquire.search import mix_baseband as j_mix_baseband
from tpu_gnss.config import (LIVE, NOTTINGHAM, RTLSDR_REPLAY, SYNTHETIC,
                             ReceiverConfig)
from tpu_gnss.io import loaders
from tpu_gnss.ops import onebit as jo
from tpu_gnss_torch.acquire.search import mix_baseband
from tpu_gnss_torch.ops import onebit as to
from tests.torch_threads import one_torch_thread  # noqa: F401

E2E = ReceiverConfig(fs=2.048e6, fc=0.512e6)


def test_unpack_matches_file_bits(rng):
    bits = rng.integers(0, 2, 8 * 1000).astype(np.uint8)
    words = to.packed_words_from_file_bytes(loaders.pack_1bit(bits))
    np.testing.assert_array_equal(
        words, jo.packed_words_from_file_bytes(loaders.pack_1bit(bits)))
    got = to.unpack_bits(to.words_to_tensor(words, "cpu"), len(bits))
    np.testing.assert_array_equal(got.numpy(), bits)


@pytest.mark.parametrize("cfg", [NOTTINGHAM, SYNTHETIC, E2E],
                         ids=["nottingham", "synthetic", "e2e"])
def test_mix_packed_matches_jax(cfg, rng):
    n = 40000
    bits = rng.integers(0, 2, n).astype(np.uint8)
    words = jo.pack_bits_to_words(bits)
    want = np.asarray(jo.mix_packed(jnp.asarray(words), n_bits=n,
                                    lo_rate=cfg.lo_rate))
    np.testing.assert_array_equal(
        want, np.asarray(j_mix_baseband(jnp.asarray(bits), cfg.lo_rate)))
    got = to.mix_packed(to.words_to_tensor(words, "cpu"), n_bits=n,
                        lo_rate=cfg.lo_rate).numpy()
    assert got.dtype == np.complex64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        mix_baseband(torch.from_numpy(bits), cfg.lo_rate).numpy(), want)


def test_mix_packed_phase_continuity(rng):
    """Chunked mix with a running host-reduced phase0 == one whole mix,
    and equals the JAX chunked mix bit for bit."""
    cfg = NOTTINGHAM
    n, chunk = 64000, 16000
    bits = rng.integers(0, 2, n).astype(np.uint8)
    whole = np.asarray(j_mix_baseband(jnp.asarray(bits), cfg.lo_rate))
    parts_t, parts_j = [], []
    for i in range(0, n, chunk):
        p0 = (i * float(cfg.lo_rate)) % 4.0
        words = jo.pack_bits_to_words(bits[i:i + chunk])
        parts_t.append(to.mix_packed(
            to.words_to_tensor(words, "cpu"), n_bits=chunk,
            lo_rate=cfg.lo_rate, phase0_quarters=p0).numpy())
        parts_j.append(np.asarray(jo.mix_packed(
            jnp.asarray(words), n_bits=chunk, lo_rate=cfg.lo_rate,
            phase0_quarters=jnp.float32(p0))))
    got = np.concatenate(parts_t)
    np.testing.assert_array_equal(got, np.concatenate(parts_j))
    np.testing.assert_allclose(got, whole, atol=1e-5)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 4096 + 17])
def test_pack_bits_to_words_matches_jax(n, rng):
    bits = rng.integers(0, 2, n).astype(np.uint8)
    got = to.pack_bits_to_words(bits)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, jo.pack_bits_to_words(bits))


@pytest.mark.parametrize("cfg", [NOTTINGHAM, E2E], ids=["nottingham", "e2e"])
def test_mix_packed_matches_pallas(cfg, rng):
    """LSB-first words through the port == the TPU kernel's bit planes
    through mix_packed_pallas, on the same bits."""
    n = 4096 * 16                     # 2 grid blocks of 8 word rows
    bits = rng.integers(0, 2, n).astype(np.uint8)
    want = np.asarray(jo.mix_packed_pallas(
        jnp.asarray(jo.pack_bits_planes(bits)), n_bits=n,
        lo_rate=cfg.lo_rate, interpret=True))
    got = to.mix_packed(to.words_to_tensor(to.pack_bits_to_words(bits),
                                           "cpu"),
                        n_bits=n, lo_rate=cfg.lo_rate).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cfg", [LIVE, RTLSDR_REPLAY], ids=["live", "rtlsdr"])
def test_mix_packed_ragged_with_phase0(cfg, rng):
    """Non-integer LO rates, a phase0 from a sample offset near 1e9, and
    n_bits that is not a multiple of 32: equal to the JAX XLA mix."""
    n = 40000 - 13
    bits = rng.integers(0, 2, n).astype(np.uint8)
    p0 = (1_000_000_007 * float(cfg.lo_rate)) % 4.0
    assert p0 > 0.0
    words = to.pack_bits_to_words(bits)
    want = np.asarray(jo.mix_packed(jnp.asarray(words), n_bits=n,
                                    lo_rate=cfg.lo_rate,
                                    phase0_quarters=jnp.float32(p0)))
    tw = to.words_to_tensor(words, "cpu")
    got = to.mix_packed(tw, n_bits=n, lo_rate=cfg.lo_rate,
                        phase0_quarters=p0).numpy()
    assert got.shape == (n,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        to.mix_packed_plain(tw, n_bits=n, lo_rate=cfg.lo_rate,
                            phase0_quarters=p0).numpy(), want)


_LO_RATES = [E2E.lo_rate, NOTTINGHAM.lo_rate, SYNTHETIC.lo_rate, LIVE.lo_rate,
             RTLSDR_REPLAY.lo_rate, 1.0 / 3.0]


@pytest.mark.parametrize("lo_rate", _LO_RATES)
def test_part2_table_is_the_plain_phase_sequence(lo_rate):
    """The kernel's 4096-entry table equals, bit for bit, the plain
    version's LO phase of the first 4096 samples (part1 is 0 there)."""
    from tpu_gnss_torch.acquire.search import PHASE_SPLIT, _phase_mod4
    want = _phase_mod4(torch.arange(PHASE_SPLIT, dtype=torch.int32),
                       lo_rate).numpy()
    got = to.part2_table(lo_rate, "cpu").numpy()
    assert got.dtype == np.float32 and got.shape == (PHASE_SPLIT,)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("lo_rate", _LO_RATES)
def test_kernel_phase_arithmetic_matches_plain(lo_rate, rng):
    """csrc/mix_packed.cu's phase index, emulated in numpy float32 (part1
    per 4096-sample segment, part2 from the table, both remaining fmods as
    compare-and-subtract), equals the plain version's at samples up to
    2^31 and at phases up to 4.0 after float32 rounding."""
    from tpu_gnss_torch.acquire.search import PHASE_SPLIT, _phase_mod4
    f32 = np.float32
    i = np.concatenate([np.arange(8192), rng.integers(0, 2 ** 31 - 1, 60000),
                        np.arange(2 ** 31 - 4096, 2 ** 31 - 1)])
    c1 = f32((PHASE_SPLIT * lo_rate) % 4.0)
    part1 = np.fmod((i // PHASE_SPLIT).astype(f32) * c1, f32(4))
    table = to.part2_table(lo_rate, "cpu").numpy()
    mod4 = lambda x: np.where(x >= 4, x - f32(4), x).astype(f32)
    for ph0 in (0.0, 1.5, 3.9999999, float(np.nextafter(4.0, 0.0))):
        ph0_32 = f32(ph0)
        got = mod4(mod4(mod4(mod4(part1 + table[i % PHASE_SPLIT])
                             + ph0_32))).astype(np.int64)
        ti = torch.from_numpy(i.astype(np.int32))
        want = ((_phase_mod4(ti, lo_rate)
                 + torch.tensor(ph0, dtype=torch.float32)) % 4.0
                ).to(torch.int64).numpy()
        np.testing.assert_array_equal(got, want)
    assert f32(3.9999999) == 4.0          # the phase that rounds up

