"""Port's fused correlate-reduce (plain version) vs JAX and numpy.

The JAX kernel runs in Pallas interpret mode (bf16 matmuls); the float64
numpy oracle is that of tests/test_mxu.py:51-79.  Lags must be equal;
peak and total agree to rtol 0.03 (the JAX package's own bf16 bound).
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
