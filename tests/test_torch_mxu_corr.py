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
from tests.torch_threads import one_torch_thread  # noqa: F401


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


# --- the tensor-core kernels' arithmetic, emulated in numpy ---------------
#
# csrc/four_step_mma.cuh runs every DFT stage as mma.sync with TF32
# operands and float32 accumulation, from the fragment-ordered, zero-padded
# tables of tm.mma_tables.  The helpers below unpack those tables and
# repeat the kernel's arithmetic: the product formed in float32 and rounded
# to TF32, stage 1 per 32-wide k2 chunk in the kernel's order, the float32
# twiddle, TF32 rounding of the stage-1 result, stage 2 accumulated in
# float32 over the chunks.  Held against the float64 oracles to the
# reference kernel's own bounds (lags equal, rtol 0.03: tests/test_mxu.py).

_F32 = np.float32
_LANE = np.arange(32)
_G, _T = _LANE // 4, _LANE % 4


def _unpack_a(a1):
    """Inverse of tm.a_fragments: ``[mt, ks, 32, 8]`` -> complex
    ``[16*mt, 8*ks]`` (padding included)."""
    mt, ks = a1.shape[:2]
    out = np.zeros((16 * mt, 8 * ks), np.complex64)
    r0 = 16 * np.arange(mt)[:, None, None]
    c0 = 8 * np.arange(ks)[None, :, None]
    for e, (dr, dc) in enumerate(((0, 0), (8, 0), (0, 4), (8, 4))):
        out[r0 + _G + dr, c0 + _T + dc] = a1[..., e] + 1j * a1[..., 4 + e]
    return out


def _unpack_b(b2):
    """Inverse of tm.b_fragments: ``[js, ntp, 32, 4]`` -> complex
    ``[8*js, 8*ntp]`` (padding included)."""
    js, ntp = b2.shape[:2]
    out = np.zeros((8 * js, 8 * ntp), np.complex64)
    r0 = 8 * np.arange(js)[:, None, None]
    c0 = 8 * np.arange(ntp)[None, :, None]
    out[r0 + 2 * _T, c0 + _G] = b2[..., 0] + 1j * b2[..., 2]
    out[r0 + 2 * _T + 1, c0 + _G] = b2[..., 1] + 1j * b2[..., 3]
    return out


def _tf32(a):
    return tm.tf32_round(np.asarray(a, _F32))


def _stage_pair(b1_r, b1_i, tables):
    """Out = ((A1 @ B1) * tw) @ B2 as the kernel computes it, B1 ``[...,
    k, j]`` float32 planes (unrounded, unpadded); returns the padded
    ``[..., 16*mt, 8*ntp]`` float32 planes."""
    a1, tw, b2 = (t.numpy() for t in tables)
    a, b = _unpack_a(a1), _unpack_b(b2)
    ar, ai = a.real, a.imag
    br, bi = b.real, b.imag
    k, j = b1_r.shape[-2:]
    pr = np.zeros(b1_r.shape[:-2] + (a.shape[1], tw.shape[1]), _F32)
    pi = np.zeros_like(pr)
    pr[..., :k, :j], pi[..., :k, :j] = _tf32(b1_r), _tf32(b1_i)
    out_r = np.zeros(b1_r.shape[:-2] + (a.shape[0], b.shape[1]), _F32)
    out_i = np.zeros_like(out_r)
    for j0 in range(0, tw.shape[1], 32):          # the kernel's chunk order
        c = slice(j0, j0 + 32)
        cr = ar @ pr[..., c] - ai @ pi[..., c]
        ci = ar @ pi[..., c] + ai @ pr[..., c]
        w = tw[:, c]
        tr = _tf32(cr * w.real - ci * w.imag)
        ti = _tf32(cr * w.imag + ci * w.real)
        out_r += tr @ br[c] - ti @ bi[c]
        out_i += tr @ bi[c] + ti @ br[c]
    return out_r, out_i


def _reduce(m_r, m_i, inv, n1, q_cols, period):
    """Inverse stage pair of ``[rows, n_acc, n_sv, k1, k2]`` products, |.|²
    summed over n_acc, then peak, first lag at the peak and total."""
    r_r, r_i = _stage_pair(m_r, m_i, inv)
    pw = (r_r * r_r + r_i * r_i).sum(1)[..., :n1, :q_cols]   # [.., t, q]
    pw = np.swapaxes(pw, -1, -2).reshape(*pw.shape[:2], -1)[..., :period]
    return pw.max(-1), pw.argmax(-1), pw.sum(-1)


def _emulate_fold(xr, xi, code, period, nf):
    t = tm.four_step_np(nf, period)
    n1, n2 = t["n1"], t["n2"]
    fwd, inv = tm.mma_tables(nf, period, "cpu")
    g_r, g_i = _stage_pair(xr, xi, fwd)           # G^T [k2, k1], unconjugated
    g_r, g_i = g_r[..., :n2, :n1], -g_i[..., :n2, :n1]
    cr, ci = tm.fold_code_planes_T(code, period)
    cr = cr.reshape(-1, n2, n1)[None, None]
    ci = ci.reshape(-1, n2, n1)[None, None]
    g_r, g_i = g_r[:, :, None], g_i[:, :, None]
    m_r, m_i = cr * g_r - ci * g_i, cr * g_i + ci * g_r       # [k2, k1]
    return _reduce(np.swapaxes(m_r, -1, -2), np.swapaxes(m_i, -1, -2), inv,
                   n1, t["q_cols"], period)


def _emulate_corr(g_r, g_i, code, period):
    n1, n2 = g_r.shape[-2:]
    _, inv = tm.mma_tables(n1 * n2, period, "cpu")
    cr, ci = (a[None, None] for a in tm.wrap_code_planes(code, period))
    g_r, g_i = g_r[:, :, None], g_i[:, :, None]
    return _reduce(cr * g_r - ci * g_i, cr * g_i + ci * g_r, inv, n1,
                   min(n2, -(-period // n1)), period)


@pytest.mark.parametrize("nf,period", [
    (2048, 2048), (2048, 1023), (10000, 10000), (12500, 12500),
    (16384, 5456), (262, 200)])
def test_mma_tables_are_the_tf32_factors(nf, period):
    """The fragment tables unpack to the TF32-rounded four-step factors,
    zero in the padding; the twiddles stay float32."""
    t = tm.four_step_np(nf, period)
    fwd, inv = tm.mma_tables(nf, period, "cpu")
    for (a1, tw, b2), (a, w, b) in (
            (fwd, ("f2", "wt", "f1")), (inv, ("e1", "tw", "e2"))):
        fa, fw, fb = t[a], t[w], t[b]
        if a == "e1":
            fa, fw = fa.T, fw.T
        ua, ub = _unpack_a(a1.numpy()), _unpack_b(b2.numpy())
        tw = tw.numpy().copy()           # the tables are cached: no writes
        assert ua.shape[0] % 16 == 0 and ua.shape[1] % 16 == 0
        assert tw.shape == (ua.shape[0], ub.shape[0])
        assert ub.shape[0] % 32 == 0 and ub.shape[1] % 64 == 0
        for got, want in ((ua, fa), (ub, fb)):
            m, n = want.shape
            np.testing.assert_array_equal(got.real[:m, :n], _tf32(want.real))
            np.testing.assert_array_equal(got.imag[:m, :n], _tf32(want.imag))
            got[:m, :n] = 0
            assert not got.any()
        m, n = fw.shape
        np.testing.assert_array_equal(tw[:m, :n], fw.astype(np.complex64))
        tw[:m, :n] = 0
        assert not tw.any()


def test_tf32_round_is_round_to_nearest():
    x = np.array([1.0, 1 + 2.0 ** -11, 1 + 2.0 ** -10 + 2.0 ** -11,
                  -1 - 2.0 ** -11 - 2.0 ** -13, 3.0e-39], np.float32)
    want = np.array([1.0, 1 + 2.0 ** -10, 1 + 2.0 ** -9,
                     -1 - 2.0 ** -10, 3.0e-39], np.float32)
    r = tm.tf32_round(x)
    np.testing.assert_array_equal(r[:4], want[:4])
    assert (r.view(np.uint32) & 0x1FFF == 0).all()


@pytest.mark.parametrize("nf,period,n_acc", [
    (2048, 2048, 1), (2048, 2048, 3), (10000, 10000, 1), (12500, 12500, 3),
    (2048, 1023, 3)],
    ids=["nf2048", "nf2048_acc3", "nf10000", "nf12500_acc3", "padded_acc3"])
def test_fold_tf32_emulation_matches_oracle(nf, period, n_acc):
    n_sv, rows = 3, 4
    code, xr, xi, pw = _case(nf, period, n_sv, rows, n_acc, seed=nf + n_acc)
    pk, lg, tt = _emulate_fold(xr, xi, code, period, nf)
    np.testing.assert_array_equal(lg, pw.argmax(-1))
    np.testing.assert_allclose(pk / nf ** 2, pw.max(-1), rtol=0.03)
    np.testing.assert_allclose(tt / nf ** 2, pw.sum(-1), rtol=0.03)


@pytest.mark.parametrize("nf,period,n_acc", [
    (2048, 2048, 3), (10000, 10000, 1), (12500, 12500, 1),
    (12500, 12500, 3), (2048, 1023, 1)],
    ids=["nf2048_acc3", "nf10000", "nf12500", "nf12500_acc3", "padded"])
def test_corr_tf32_emulation_matches_oracle(nf, period, n_acc):
    n_sv, rows = 3, 4
    code, g_r, g_i, pw = _spectra_case(nf, period, n_sv, rows, n_acc,
                                       seed=nf + n_acc)
    pk, lg, tt = _emulate_corr(g_r, g_i, code, period)
    np.testing.assert_array_equal(lg, pw.argmax(-1))
    np.testing.assert_allclose(pk / nf ** 2, pw.max(-1), rtol=0.03)
    np.testing.assert_allclose(tt / nf ** 2, pw.sum(-1), rtol=0.03)


@pytest.mark.parametrize("form", ["fold", "corr"])
def test_tf32_emulation_keeps_noise_decisions(form):
    """Noise only, the case of chip_smoke's batched scan: of 16 rows x 8 SVs
    lag decisions and 8 best-row decisions, at least 97% equal float64's."""
    nf = period = 2048
    n_sv, rows = 8, 16
    rng = np.random.default_rng(7)
    reps = cacode.resample(cacode.code_table()[:n_sv], period * 1000.0,
                           period)
    code = np.fft.fft(reps.astype(np.float64), n=nf, axis=-1)
    x = rng.standard_normal((rows, 1, period)) + 1j * rng.standard_normal(
        (rows, 1, period))
    g = np.fft.fft(x, n=nf, axis=-1)
    pw = (np.abs(np.fft.ifft(code[None, None] * np.conj(g)[:, :, None],
                             axis=-1)) ** 2).sum(1)              # [rows, sv, P]
    if form == "fold":
        n1 = tm.split_nf(nf)[0]
        xs = x.reshape(rows, 1, -1, n1)
        pk, lg, _ = _emulate_fold(xs.real.astype(_F32), xs.imag.astype(_F32),
                                  code, period, nf)
    else:
        gc = np.conj(g).reshape(rows, 1, *tm.split_nf(nf))
        pk, lg, _ = _emulate_corr(gc.real.astype(_F32), gc.imag.astype(_F32),
                                  code, period)
    same = int((lg == pw.argmax(-1)).sum())
    same += int((pk.argmax(0) == pw.max(-1).argmax(0)).sum())
    total = rows * n_sv + n_sv
    assert total >= 64 and same >= 0.97 * total, (same, total)


@pytest.mark.parametrize("nf,period", [
    (2048, 2048), (8192, 8184), (10000, 10000), (12500, 12500),
    (16384, 5456), (16384, 8184), (262, 200)])
def test_stage_smem_fits_the_shapes_that_run(nf, period):
    """Every geometry of the presets (and an odd tiny NF with n1 > 128)
    stays under the Hopper limit, at n_acc 1 and 8 and 32 SVs."""
    t = tm.four_step_np(nf, period)
    n1, n2, q = t["n1"], t["n2"], t["q_cols"]
    assert tm.stage_smem(n2, t["u_rows"], n1, n1, planes=2,
                         max_warps=4) <= tm.kernels.SMEM_LIMIT
    for n_acc in (1, 8):
        assert tm.stage_smem(n1, n1, n2, q, planes=4, items=32,
                             n_acc=n_acc) <= tm.kernels.SMEM_LIMIT
