"""Port's tracking correlator vs the JAX Pallas kernel.

The JAX kernel runs in Pallas interpret mode on the CPU, as
tests/test_track.py runs it; the port's ``track_corr`` on a CPU tensor
runs its plain PyTorch version, and ``track_corr_tf32`` below repeats the
CUDA kernel's TF32 arithmetic in numpy.  Inputs are made with numpy from
a seed and handed to both.  Tolerances are those the JAX package holds
its own kernel to against its einsum path
(tests/test_track.py:227-236,328-331): 2e-3·max|P| at even n1, 4e-3 at
odd n1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gnss.constants import CODE_LEN_CHIPS
from tpu_gnss.ops import mxu_track as jmt
from tpu_gnss.signal import synth
from tpu_gnss_torch.acquire.folded import fft_len_for_period
from tpu_gnss_torch.ops import mxu_track as tmt
from tpu_gnss_torch.ops.mxu_corr import four_step_np, mma_tables, split_nf
from tpu_gnss_torch.track import channel as tc
from tpu_gnss_torch.track.channel import code_spectra_np

from .test_torch_mxu_corr import _stage_pair
from .test_torch_track import _run_both


def _inputs(fs, prns, chips, dops, e_sub, seed):
    p = int(round(fs * 1e-3))
    nf = fft_len_for_period(p)
    n1, _ = split_nf(nf)
    u_rows = four_step_np(nf, p)["u_rows"]
    svs = [synth.SvSignal(prn=pr, doppler_hz=d, code_phase_chips=c)
           for pr, c, d in zip(prns, chips, dops)]
    iq = synth.synth_baseband(svs, fs, e_sub * p, noise_std=0.3, seed=seed)
    blk = np.pad(iq.reshape(e_sub, p), ((0, 0), (0, u_rows * n1 - p)))
    blk = blk.reshape(e_sub, u_rows, n1)
    scale = p / CODE_LEN_CHIPS
    spacing = 0.5
    e = np.arange(e_sub)[:, None]
    chips0 = np.asarray(chips)[None, :] + 0.02 * e        # [e, c]
    s0p = (chips0 % CODE_LEN_CHIPS) * scale
    s0e = ((chips0 + spacing) % CODE_LEN_CHIPS) * scale
    s0l = ((chips0 - spacing) % CODE_LEN_CHIPS) * scale
    delta = np.asarray(dops)[None, :] / fs + 0 * e
    phase0 = (0.3 + delta * e * p) % 1.0
    params = np.stack([phase0, delta, s0p, (s0e < s0p), (s0l > s0p)],
                      axis=-1).astype(np.float32)
    spec = code_spectra_np(list(prns), len(prns), fs)
    return nf, p, blk, params, spec, spacing * scale


def _jax_track_corr(nf, p, blk, params, spec, dsamp):
    """The JAX Pallas kernel in interpret mode on the same inputs."""
    prns = params.shape[1]
    n_pad = jmt.pad_channels(prns)
    par128 = np.zeros((params.shape[0], n_pad, 128), np.float32)
    par128[:, :prns, :5] = params
    jr, ji = jmt.spec_planes(jnp.asarray(spec), nf, n_pad)
    blk_t = np.transpose(blk, (0, 2, 1))
    want = np.asarray(jmt.track_corr(
        jnp.asarray(blk_t.real.astype(np.float32)),
        jnp.asarray(blk_t.imag.astype(np.float32)), jnp.asarray(par128),
        jr, ji, period=p, nf=nf, dsamp=dsamp,
        interpret=True))[:, :prns]
    ref = np.hypot(want[..., 0], want[..., 1]).max()     # max |P|
    assert ref > 100.0      # the channels sit on their signals
    return want, ref


def _torch_args(nf, blk, params, spec):
    return (torch.from_numpy(blk.real.astype(np.float32)),
            torch.from_numpy(blk.imag.astype(np.float32)),
            torch.from_numpy(params),
            *tmt.spec_planes(torch.from_numpy(spec), nf))


# prompt near the period end (early wraps) and near 0 (late wraps)
_CASE = dict(prns=(7, 21, 3), chips=(1022.9, 0.1, 500.3),
             dops=(1234.0, -2100.0, 300.0))


@pytest.mark.parametrize("fs,atol", [(2.048e6, 2e-3), (12.5e6, 4e-3)],
                         ids=["even_n1_nf2048", "odd_n1_nf12500"])
def test_track_corr_plain_matches_jax_kernel(fs, atol):
    nf, p, blk, params, spec, dsamp = _inputs(fs, *_CASE.values(), 3, 4)
    assert params[..., 3].any() and params[..., 4].any()
    got = tmt.track_corr(*_torch_args(nf, blk, params, spec),
                         period=p, nf=nf, dsamp=dsamp).numpy()
    want, ref = _jax_track_corr(nf, p, blk, params, spec, dsamp)
    np.testing.assert_allclose(got, want, atol=atol * ref)


# --- the tensor-core kernel's arithmetic, emulated in numpy ---------------
#
# csrc/track_corr.cu forms the carrier wipe in float32 while it stages the
# epoch, runs the forward four-step DFT as the TF32 stage pair of
# csrc/four_step_mma.cuh (emulated by test_torch_mxu_corr._stage_pair from
# the same mma_tables), then the code product, the exact prompt ramp and
# the early/late taps in float32.  Held to the JAX kernel at the bars the
# reference holds its own bf16 kernel to (tests/test_track.py:226-236,
# 327-331).

def track_corr_tf32(blk_r, blk_i, params, cw_r, cw_i, *, period, nf,
                    dsamp=0.0):
    """``track_corr`` as the CUDA kernel computes it, in numpy."""
    f32 = np.float32
    t = four_step_np(nf, period)
    n1, n2, u_rows = t["n1"], t["n2"], t["u_rows"]
    par = params.numpy()
    phase0, delta, tau = par[..., 0], par[..., 1], par[..., 2]
    # e^{-j2pi frac(cyc)}; the LO phasor factored as lo_u[u] * lo_v[v]
    # (sample n1*u + v)
    lo = lambda cyc: np.exp(1j * (f32(-2.0 * np.pi) * (cyc % f32(1.0)))
                            ).astype(np.complex64)
    lo_u = lo(phase0[..., None] + delta[..., None]
              * (np.arange(u_rows, dtype=f32) * f32(n1)))
    lo_v = lo(delta[..., None] * np.arange(n1, dtype=f32))
    y = ((blk_r.numpy() + 1j * blk_i.numpy()).astype(np.complex64)[:, None]
         * (lo_u[..., :, None] * lo_v[..., None, :]))        # [e, c, u, v]
    g_r, g_i = _stage_pair(y.real, y.imag, mma_tables(nf, period, "cpu")[0])
    g = (g_r[..., :n2, :n1] + 1j * g_i[..., :n2, :n1]).astype(np.complex64)
    cw = (cw_r.numpy() + 1j * cw_i.numpy()).astype(np.complex64)
    # the ramp and taps as products of shared factors (csrc/track_corr.cu):
    # columns k1, rows k2 and the upper-half phasor, per lag
    ti = np.floor(tau)
    tf = (tau - ti)[..., None]
    tim = ti.astype(np.int64)[..., None] % nf
    k1, k2 = np.arange(n1), np.arange(n2)
    a = np.concatenate([
        lo(((k1 * (tim % n1)) % n1).astype(f32) / f32(n1)
           + k1.astype(f32) * tf / f32(n1)),
        lo(((k2 * tim) % nf).astype(f32) / f32(nf)
           + k2.astype(f32) * tf / f32(nf)),
        lo(-tf)], -1)                                      # [e, c, nfac]
    tapf = tmt.tap_factors(nf, period, dsamp, "cpu").numpy()
    pick = lambda flag, i, j: np.where((flag > 0.5)[..., None], tapf[j],
                                       tapf[i])
    upper = (k1[None, :] * n2 + k2[:, None]) >= nf // 2    # [k2, k1]
    p = cw.reshape(-1, n2, n1) * g
    sums = []
    for fx in (a, a * pick(par[..., 3], 0, 1), a * pick(par[..., 4], 2, 3)):
        f = fx[..., None, :n1] * fx[..., n1:n1 + n2, None]
        f = np.where(upper, f * fx[..., -1:, None], f)
        sums.append((p * f).sum((-2, -1)) / f32(nf))
    return torch.from_numpy(np.stack(
        [f(s) for s in sums for f in (np.real, np.imag)], -1).astype(f32))


@pytest.mark.parametrize("fs,atol", [(2.048e6, 2e-3), (5.456e6, 2e-3),
                                     (12.5e6, 4e-3)],
                         ids=["nf2048", "nf16384", "odd_n1_nf12500"])
def test_track_corr_tf32_emulation_matches_jax_kernel(fs, atol):
    nf, p, blk, params, spec, dsamp = _inputs(fs, *_CASE.values(), 3, 4)
    assert params[..., 3].any() and params[..., 4].any()
    got = track_corr_tf32(*_torch_args(nf, blk, params, spec), period=p,
                          nf=nf, dsamp=dsamp).numpy()
    want, ref = _jax_track_corr(nf, p, blk, params, spec, dsamp)
    np.testing.assert_allclose(got, want, atol=atol * ref)


@pytest.mark.parametrize("e_sub", [4, 10])
def test_track_epochs_tf32_emulation_matches_jax(monkeypatch, e_sub):
    """The closed loop: the port's track_epochs with the kernel's TF32
    arithmetic holds the JAX XLA tracker's code phase within 1e-4 chips
    and its carrier within 0.05 Hz (tests/test_track.py:226-236)."""
    monkeypatch.setattr(tc.mxu_track, "track_corr", track_corr_tf32)
    svs = [synth.SvSignal(prn=7, doppler_hz=1234.0, code_phase_chips=500.25),
           synth.SvSignal(prn=21, doppler_hz=-2100.0,
                          code_phase_chips=12.75, amplitude=0.7)]
    st_x, out_x, st_t, out_t = _run_both(
        5.456e6, svs, 40, e_sub, 4, [500.25, 12.75], [1234.0, -2100.0])
    ip_t, qp_t, e_t, _, _, _, cp_t = out_t
    ref = np.abs(out_x.ip).max()
    np.testing.assert_allclose(ip_t, out_x.ip, atol=2e-3 * ref)
    np.testing.assert_allclose(qp_t, out_x.qp, atol=2e-3 * ref)
    np.testing.assert_allclose(e_t, out_x.e_mag, atol=2e-3 * ref)
    np.testing.assert_allclose(cp_t, out_x.code_phase, atol=1e-4)
    np.testing.assert_allclose(st_t.carrier_freq, st_x.carrier_freq,
                               atol=0.05)


def test_frac_ramp_exact_reduction():
    """The ramp's integer/fraction phase split equals the float64 ramp."""
    nf = period = 16384
    keff = torch.from_numpy(four_step_np(nf, period)["keff"])
    tau = torch.tensor([0.0, 0.5, 8191.75, 16383.999], dtype=torch.float32)
    got = tmt.frac_ramp(tau, keff, nf).numpy()
    k = keff.numpy().astype(np.float64)
    want = np.exp(-2j * np.pi * k[None] * tau.numpy().astype(np.float64)
                  [:, None, None] / nf)
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_track_corr_rejects_bad_shapes():
    nf = period = 2048
    n1, n2 = split_nf(nf)
    u_rows = four_step_np(nf, period)["u_rows"]
    blk = torch.zeros(2, u_rows, n1)
    cw = torch.zeros(3 * n2, n1)
    with pytest.raises(ValueError):
        tmt.track_corr(blk, blk, torch.zeros(2, 3, 4), cw, cw,
                       period=period, nf=nf)
    with pytest.raises(ValueError):
        tmt.track_corr(blk, blk, torch.zeros(2, 2, 5), cw, cw,
                       period=period, nf=nf)


@pytest.mark.parametrize("fs", [2.048e6, 5.456e6, 12.5e6],
                         ids=["e2e", "nottingham", "odd_n1"])
def test_tf32_emulation_within_chip_smoke_tolerance(fs):
    """On chip_smoke.py's own tracking step (12 channels x 10 epochs, wrap
    edges included), the emulated kernel stays within a quarter of the
    tolerance chip_smoke.py holds the CUDA kernel to against the plain
    version."""
    import chip_smoke
    args, kw = chip_smoke.track_case(fs, "cpu")
    got = track_corr_tf32(*args, **kw)
    want = tmt.track_corr_plain(*args, **kw)
    ref = float(torch.hypot(want[..., 0], want[..., 1]).max())
    assert ref > 100.0
    err = float((got - want).abs().max())
    assert err <= chip_smoke.TRACK_ATOL / 4 * ref, err / ref


@pytest.mark.parametrize("fs", [2.048e6, 5.456e6, 8.184e6, 10e6, 12.5e6])
def test_track_smem_fits_every_preset_geometry(fs):
    p = int(round(fs * 1e-3))
    nf = fft_len_for_period(p)
    assert tmt.track_smem(nf, p) <= tmt.kernels.SMEM_LIMIT
    assert split_nf(nf)[1] * nf < 2 ** 31


@pytest.mark.parametrize("nf,period", [(2048, 2048), (16384, 5456),
                                       (12500, 12500)])
def test_tap_factors_rebuild_the_tap_grids(nf, period):
    """Column x row factors, times the upper-half phasor where keff = k -
    NF, give every tap grid of dense_taps (to complex64 rounding)."""
    n1, n2 = split_nf(nf)
    dsamp = 0.5 * period / CODE_LEN_CHIPS
    f = tmt.tap_factors(nf, period, dsamp, "cpu").numpy().astype(complex)
    upper = (np.arange(n1)[None, :] * n2 + np.arange(n2)[:, None]) >= nf // 2
    grid = f[:, None, :n1] * f[:, n1:n1 + n2, None]
    grid = np.where(upper, grid * f[:, -1:, None], grid)
    np.testing.assert_allclose(grid, tmt.dense_taps(nf, period, dsamp),
                               atol=1e-6)
