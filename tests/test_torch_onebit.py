"""Port's packed 1-bit frontend vs the JAX one, bit for bit.

Mirrors tests/test_onebit.py::test_mix_packed_matches_mix_baseband and
::test_mix_packed_phase_continuity.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gnss.acquire.search import mix_baseband as j_mix_baseband
from tpu_gnss.config import NOTTINGHAM, SYNTHETIC, ReceiverConfig
from tpu_gnss.io import loaders
from tpu_gnss.ops import onebit as jo
from tpu_gnss_torch.acquire.search import mix_baseband
from tpu_gnss_torch.ops import onebit as to

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
