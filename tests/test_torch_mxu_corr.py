"""Port's correlate-reduce ops (plain versions) vs JAX and numpy.

The JAX kernels run in Pallas interpret mode (bf16 matmuls); the float64
numpy oracles are those of tests/test_mxu.py:27-79.  Lags must be equal.
Against the oracle the port's float32 peak and total agree to rtol 1e-4
(float32 rounding over NF-point transforms); against the JAX kernels to
rtol 0.03 for fold_corr_reduce and 0.02 for corr_reduce, the JAX
package's own bounds, set by its bf16 planes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gnss.ops import mxu_corr as jm
from tpu_gnss.signal import cacode
from tpu_gnss_torch.ops import mxu_corr as tm


def _case(nf, period, n_sv, rows, n_acc, seed):
    """Blocks holding shifted C/A replicas (a clear peak per SV/row) plus
    noise, and the replicas' spectra."""
    rng = np.random.default_rng(seed)
    fs = period * 1000.0
    prns = np.arange(1, n_sv + 1)
    reps = cacode.resample(cacode.code_table()[prns - 1], fs, period)
    code = np.fft.fft(reps.astype(np.float64), n=nf, axis=-1)
    x = 0.5 * (rng.standard_normal((rows, n_acc, period))
               + 1j * rng.standard_normal((rows, n_acc, period)))
    for r in range(rows):
        sv = r % n_sv
        x[r] += 0.3 * np.roll(reps[sv], int(rng.integers(period)))
    g = np.fft.fft(x, n=nf, axis=-1)
    lin = np.fft.ifft(code[None, None] * np.conj(g)[:, :, None, :], axis=-1)
    circ = (lin[..., :period] + lin[..., nf - period:]
            if nf != period else lin[..., :period])
    pw = (np.abs(circ) ** 2).sum(axis=1)          # [rows, n_sv, P]
    n1, _ = tm.split_nf(nf)
    u_rows = tm.four_step_np(nf, period)["u_rows"]
    xp = np.pad(x, ((0, 0), (0, 0), (0, u_rows * n1 - period)))
    xr = xp.real.astype(np.float32).reshape(rows, n_acc, u_rows, n1)
    xi = xp.imag.astype(np.float32).reshape(rows, n_acc, u_rows, n1)
    return code, xr, xi, pw


@pytest.mark.parametrize("nf,period,n_acc", [
    (2048, 2048, 1), (2048, 2048, 3), (10000, 10000, 1), (10000, 10000, 2),
    (2048, 1023, 2)],
    ids=["nf2048", "nf2048_acc3", "nf10000", "nf10000_acc2", "padded_acc2"])
def test_fold_corr_reduce_plain_matches_jax_and_numpy(nf, period, n_acc):
    n_sv, rows = 3, 4
    code, xr, xi, pw = _case(nf, period, n_sv, rows, n_acc, seed=nf + n_acc)
    cr, ci = tm.fold_code_planes_T(code, period)
    pk, lg, tt = tm.fold_corr_reduce(
        torch.from_numpy(xr), torch.from_numpy(xi), torch.from_numpy(cr),
        torch.from_numpy(ci), period=period, nf=nf)
    pk, lg, tt = pk.numpy(), lg.numpy(), tt.numpy()
    assert lg.dtype == np.int32 and pk.shape == (rows, n_sv)
    # float64 oracle
    np.testing.assert_array_equal(lg, pw.argmax(-1))
    np.testing.assert_allclose(pk / nf ** 2, pw.max(-1), rtol=1e-4)
    np.testing.assert_allclose(tt / nf ** 2, pw.sum(-1), rtol=1e-4)
    # the JAX Pallas kernel (interpret mode)
    jr, ji = jm.fold_code_planes_T(code, period)
    jp, jl, jt = (np.asarray(a) for a in jm.fold_corr_reduce(
        jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(jr), jnp.asarray(ji),
        period=period, nf=nf, interpret=True))
    np.testing.assert_array_equal(lg, jl)
    np.testing.assert_allclose(pk, jp, rtol=0.03)
    np.testing.assert_allclose(tt, jt, rtol=0.03)


def test_fold_corr_reduce_first_max_on_ties():
    """All-zero rows: peak 0, total 0, and the smallest lag (0) wins."""
    nf = period = 2048
    n1, n2 = tm.split_nf(nf)
    u_rows = tm.four_step_np(nf, period)["u_rows"]
    z = torch.zeros(2, 1, u_rows, n1)
    cw = torch.ones(2 * n2, n1)
    pk, lg, tt = tm.fold_corr_reduce(z, z, cw, cw, period=period, nf=nf)
    assert (pk == 0).all() and (tt == 0).all() and (lg == 0).all()


def test_split_and_tables_match_reference():
    for nf in (1024, 2048, 10000, 12500, 16384):
        assert tm.split_nf(nf) == jm.split_nf(nf)
    with pytest.raises(ValueError):
        tm.split_nf(9973)
    for nf, p in ((16384, 5456), (2048, 2048), (10000, 10000)):
        a, b = tm.four_step_np(nf, p), jm.four_step_np(nf, p)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_fold_corr_reduce_rejects_bad_shapes():
    nf = period = 2048
    n1, n2 = tm.split_nf(nf)
    x = torch.zeros(2, 1, 5, n1)
    cw = torch.zeros(n2, n1)
    with pytest.raises(ValueError):
        tm.fold_corr_reduce(x, x, cw, cw, period=period, nf=nf)


def _spectra_case(nf, period, n_sv, rows, n_acc, seed):
    """Conjugated length-NF spectra of blocks that hold every SV's replica
    at its own shift (a clear peak in every cell, so the bf16 reference
    picks the same lags) as [rows, n_acc, n1, n2] float32 planes, row
    major (index k1*n2 + k2); the code spectra; the float64 power oracle."""
    rng = np.random.default_rng(seed)
    prns = np.arange(1, n_sv + 1)
    reps = cacode.resample(cacode.code_table()[prns - 1], period * 1000.0,
                           period)
    code = np.fft.fft(reps.astype(np.float64), n=nf, axis=-1)
    x = 0.5 * (rng.standard_normal((rows, n_acc, period))
               + 1j * rng.standard_normal((rows, n_acc, period)))
    for r in range(rows):
        for sv in range(n_sv):
            x[r] += 0.3 * np.roll(reps[sv], int(rng.integers(period)))
    g = np.conj(np.fft.fft(x, n=nf, axis=-1))
    lin = np.fft.ifft(code[None, None] * g[:, :, None, :], axis=-1)
    circ = (lin[..., :period] + lin[..., nf - period:]
            if nf != period else lin[..., :period])
    pw = (np.abs(circ) ** 2).sum(axis=1)          # [rows, n_sv, P]
    g = g.reshape(rows, n_acc, *tm.split_nf(nf))
    return (code, np.ascontiguousarray(g.real, np.float32),
            np.ascontiguousarray(g.imag, np.float32), pw)


@pytest.mark.parametrize("nf,period,n_acc", [
    (1024, 1000, 1), (1024, 1000, 3), (1024, 1024, 1), (1024, 1024, 3)],
    ids=["wrap", "wrap_acc3", "nf_eq_p", "nf_eq_p_acc3"])
def test_corr_reduce_plain_matches_jax_and_numpy(nf, period, n_acc):
    n_sv, rows = 3, 4
    code, g_r, g_i, pw = _spectra_case(nf, period, n_sv, rows, n_acc,
                                       seed=nf + n_acc)
    if n_acc == 1:                  # the 3-D [rows, n1, n2] form
        g_r, g_i = g_r[:, 0], g_i[:, 0]
    cr, ci = tm.wrap_code_planes(code, period)
    pk, lg, tt = (a.numpy() for a in tm.corr_reduce(
        torch.from_numpy(g_r), torch.from_numpy(g_i), torch.from_numpy(cr),
        torch.from_numpy(ci), period=period))
    assert lg.dtype == np.int32 and pk.shape == (rows, n_sv)
    np.testing.assert_array_equal(lg, pw.argmax(-1))
    np.testing.assert_allclose(pk / nf ** 2, pw.max(-1), rtol=1e-4)
    np.testing.assert_allclose(tt / nf ** 2, pw.sum(-1), rtol=1e-4)
    jr, ji = jm.wrap_code_planes(code, period)
    jp, jl, jt = (np.asarray(a) for a in jm.corr_reduce(
        jnp.asarray(g_r), jnp.asarray(g_i), jnp.asarray(jr), jnp.asarray(ji),
        period=period, interpret=True))
    np.testing.assert_array_equal(lg, jl)
    np.testing.assert_allclose(pk, jp, rtol=0.02)
    np.testing.assert_allclose(tt, jt, rtol=0.02)


def test_corr_reduce_matches_reference_oracle():
    """The random-spectra case of tests/test_mxu.py:27-48, as it is."""
    rng = np.random.default_rng(0)
    nf, period, n_sv, rows = 1024, 1000, 4, 6
    n1, n2 = tm.split_nf(nf)
    g = rng.standard_normal((rows, nf)) + 1j * rng.standard_normal((rows, nf))
    code = (rng.standard_normal((n_sv, nf))
            + 1j * rng.standard_normal((n_sv, nf)))
    lin = np.fft.ifft(code[None, :, :] * g[:, None, :], axis=-1)
    pw = np.abs(lin[..., :period] + lin[..., nf - period:]) ** 2
    cr, ci = tm.wrap_code_planes(code, period)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    pk, lg, tt = tm.corr_reduce(
        t(g.real.reshape(rows, n1, n2)), t(g.imag.reshape(rows, n1, n2)),
        t(cr), t(ci), period=period)
    np.testing.assert_array_equal(lg.numpy(), pw.argmax(-1))
    np.testing.assert_allclose(pk.numpy() / nf ** 2, pw.max(-1), rtol=1e-4)
    np.testing.assert_allclose(tt.numpy() / nf ** 2, pw.sum(-1), rtol=1e-4)


def test_idft_tables_and_wrap_planes_match_reference():
    nf, period = 1024, 1000
    e1, tw, e2 = (a.numpy() for a in tm.idft_tables(nf, "cpu"))
    je1r, je1i, jtwr, jtwi, je2r, je2i = jm.idft_tables(nf)
    np.testing.assert_allclose(tw.real, jtwr, atol=1e-7)
    np.testing.assert_allclose(tw.imag, jtwi, atol=1e-7)
    for mine, (jr, ji) in ((e1, (je1r, je1i)), (e2, (je2r, je2i))):
        np.testing.assert_allclose(mine.real, np.float32(jr), atol=4e-3)
        np.testing.assert_allclose(mine.imag, np.float32(ji), atol=4e-3)
    code = np.random.default_rng(3).standard_normal((2, nf)) + 0j
    cr, ci = tm.wrap_code_planes(code, period)
    jr, ji = jm.wrap_code_planes(code, period)
    assert cr.dtype == np.float32 and cr.shape == (2, *tm.split_nf(nf))
    np.testing.assert_allclose(cr, np.float32(jr), rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(ci, np.float32(ji), rtol=1e-2, atol=1e-2)


def test_corr_reduce_rejects_bad_shapes():
    g = torch.zeros(2, 8, 128)
    with pytest.raises(ValueError):          # code planes of another split
        tm.corr_reduce(g, g, torch.zeros(1, 128, 8), torch.zeros(1, 128, 8),
                       period=1000)
    with pytest.raises(ValueError):          # not [rows, (n_acc,) n1, n2]
        tm.corr_reduce(g[0], g[0], torch.zeros(1, 8, 128),
                       torch.zeros(1, 8, 128), period=1000)
    with pytest.raises(ValueError):          # period beyond NF
        tm.corr_reduce(g, g, torch.zeros(1, 8, 128), torch.zeros(1, 8, 128),
                       period=2000)
