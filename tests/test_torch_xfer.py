"""The port's host->device links against the JAX reference's.

Every ``to_device_*`` and ``from_device_complex`` of
:mod:`tpu_gnss_torch.utils.xfer` (on the CPU) against
:mod:`tpu_gnss.utils.xfer` on the same seeded numpy input, signed and
unsigned 8-bit captures, with and without DC removal.  Where no mean is
taken the dequantization is the same float32 arithmetic, so the results
are equal; ``jnp.mean`` and ``torch.mean`` reduce in different orders, so
with ``remove_dc`` they agree within 1e-6 x max|x|.
"""

import numpy as np
import pytest
import torch

from tpu_gnss.utils import xfer as jx
from tpu_gnss_torch.utils import xfer as tx
from tests.torch_threads import one_torch_thread  # noqa: F401

N = 6000          # complex samples (even: the 2-bit link packs pairs)


def _complex(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(N) + 1j * rng.standard_normal(N)
            + (0.3 - 0.2j)).astype(np.complex64)


def _raw(seed: int, signed: bool) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if signed:
        return rng.integers(-90, 100, 2 * N).astype(np.int8)
    return rng.integers(20, 250, 2 * N).astype(np.uint8)


def _check(got: torch.Tensor, want, remove_dc: bool) -> None:
    got = got.numpy()
    want = np.asarray(want)
    assert got.dtype == np.complex64 and got.shape == want.shape
    if remove_dc:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_complex_links_match_jax(seed):
    """complex64, int8 planes, nibbles and 2-bit codes of a host complex
    array, at the receiver's scales."""
    x = _complex(seed)
    rms = float(np.sqrt(np.mean(np.abs(x) ** 2)))
    _check(tx.to_device_complex(x, "cpu"), jx.to_device_complex(x), False)
    s8 = 127.0 / (6.0 * rms)
    _check(tx.to_device_complex_i8(x, s8, "cpu"),
           jx.to_device_complex_i8(x, s8), False)
    s4 = 7.0 / (3.0 * rms)
    _check(tx.to_device_complex_i4(x, s4, "cpu"),
           jx.to_device_complex_i4(x, s4), False)
    _check(tx.to_device_complex_i2(x, "cpu"), jx.to_device_complex_i2(x),
           False)


@pytest.mark.parametrize("signed", [True, False], ids=["int8", "uint8"])
@pytest.mark.parametrize("remove_dc", [False, True], ids=["dc", "no-dc"])
@pytest.mark.parametrize("link", ["iq8", "iq4", "iq2"])
def test_capture_byte_links_match_jax(link, signed, remove_dc):
    raw = _raw(3 + signed, signed)
    t_fn = getattr(tx, f"to_device_{link}")
    j_fn = getattr(jx, f"to_device_{link}")
    _check(t_fn(raw, signed=signed, remove_dc=remove_dc, device="cpu"),
           j_fn(raw, signed=signed, remove_dc=remove_dc), remove_dc)


def test_iq8_link_takes_read_only_file_bytes():
    """A capture's bytes straight from ``np.frombuffer`` (read-only) upload
    with the values the file holds."""
    raw = _raw(5, True)
    ro = np.frombuffer(raw.tobytes(), dtype=np.int8)
    assert not ro.flags.writeable
    got = tx.to_device_iq8(ro, signed=True, remove_dc=False, device="cpu")
    np.testing.assert_array_equal(got.real.numpy(), raw[0::2])
    np.testing.assert_array_equal(got.imag.numpy(), raw[1::2])


def test_iq2_link_needs_whole_bytes():
    """2-bit packing holds four components a byte: an odd sample count
    is refused, as in the reference."""
    raw = _raw(6, True)[:2 * 1001]
    with pytest.raises(AssertionError, match="FOUR components"):
        tx.to_device_iq2(raw, signed=True, device="cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_from_device_complex_matches_jax(seed):
    x = _complex(seed)
    got = tx.from_device_complex(torch.from_numpy(x))
    want = jx.from_device_complex(jx.to_device_complex(x))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_link_sizes_are_the_small_dtype():
    """What crosses is the link's own dtype: the int4 and int2 links
    upload one byte per sample and per two samples."""
    uploads = []
    real_upload = tx._upload

    def spy(a, device):
        uploads.append(np.asarray(a).nbytes)
        return real_upload(a, device)

    tx._upload = spy
    try:
        x = _complex(2)
        tx.to_device_complex_i8(x, 10.0, "cpu")
        tx.to_device_complex_i4(x, 1.0, "cpu")
        tx.to_device_complex_i2(x, "cpu")
        tx.to_device_iq8(_raw(2, False), signed=False, device="cpu")
    finally:
        tx._upload = real_upload
    assert uploads == [N, N, N, N // 2, 2 * N]
