"""Port's tracking correlator (plain version) vs the JAX Pallas kernel.

The JAX kernel runs in Pallas interpret mode on the CPU, as
tests/test_track.py runs it; the port's ``track_corr`` on a CPU tensor
runs its plain PyTorch version.  Inputs are made with numpy from a seed
and handed to both.  Tolerances are those the JAX package holds its own
kernel to against its einsum path (tests/test_track.py:227-236,328-331):
2e-3·max|P| at even n1, 4e-3 at odd n1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gnss.constants import CODE_LEN_CHIPS
from tpu_gnss.ops import mxu_track as jmt
from tpu_gnss.signal import synth
from tpu_gnss_torch.ops import mxu_track as tmt
from tpu_gnss_torch.ops.mxu_corr import four_step_np, split_nf
from tpu_gnss_torch.track.channel import code_spectra_np


def _inputs(fs, prns, chips, dops, e_sub, seed):
    p = int(round(fs * 1e-3))
    nf = p
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


@pytest.mark.parametrize("fs,atol", [(2.048e6, 2e-3), (12.5e6, 4e-3)],
                         ids=["even_n1_nf2048", "odd_n1_nf12500"])
def test_track_corr_plain_matches_jax_kernel(fs, atol):
    prns = (7, 21, 3)
    # prompt near the period end (early wraps) and near 0 (late wraps)
    chips = (1022.9, 0.1, 500.3)
    dops = (1234.0, -2100.0, 300.0)
    nf, p, blk, params, spec, dsamp = _inputs(fs, prns, chips, dops, 3, 4)
    assert params[..., 3].any() and params[..., 4].any()
    got = tmt.track_corr(
        torch.from_numpy(blk.real.astype(np.float32)),
        torch.from_numpy(blk.imag.astype(np.float32)),
        torch.from_numpy(params),
        *tmt.spec_planes(torch.from_numpy(spec), nf),
        period=p, nf=nf, dsamp=dsamp).numpy()

    n_pad = jmt.pad_channels(len(prns))
    par128 = np.zeros((params.shape[0], n_pad, 128), np.float32)
    par128[:, : len(prns), :5] = params
    jr, ji = jmt.spec_planes(jnp.asarray(spec), nf, n_pad)
    blk_t = np.transpose(blk, (0, 2, 1))
    want = np.asarray(jmt.track_corr(
        jnp.asarray(blk_t.real.astype(np.float32)),
        jnp.asarray(blk_t.imag.astype(np.float32)), jnp.asarray(par128),
        jr, ji, period=p, nf=nf, dsamp=dsamp,
        interpret=True))[:, : len(prns)]
    ref = np.hypot(want[..., 0], want[..., 1]).max()     # max |P|
    assert ref > 100.0      # the channels sit on their signals
    np.testing.assert_allclose(got, want, atol=atol * ref)


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
