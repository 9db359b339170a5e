"""Port's tracking loop vs the JAX tracker, with every loop option.

Mirrors tests/test_track.py::test_pallas_correlator_matches_einsum: both
banks start from one state (the JAX state carried across with
``state_from_numpy``) and see the same numpy-synthesized samples, through
the FFT-dot correlator (the port's plain version against the JAX einsum
path) or the gather correlator (``code_tables``, no spectra) on both
sides.  Tolerances as stated there: ip/qp/e_mag atol 2e-3·ref,
code_phase atol 1e-4 chips, carrier_freq atol 0.05 Hz.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gnss.signal import synth
from tpu_gnss.track import channel as jc
from tpu_gnss_torch.track import channel as tc
from tests.torch_threads import one_torch_thread  # noqa: F401

FS = 5.456e6


def _run_both(fs, svs, n_epochs, e_sub, seed, chips, dops, gather=False,
              **opts):
    p = int(round(fs * 1e-3))
    iq = synth.synth_baseband(svs, fs, n_epochs * p, noise_std=0.3,
                              seed=seed)
    prns = [s.prn for s in svs]
    n = len(prns)
    state = jc.init_state(n)
    for ch, (d, c) in enumerate(zip(dops, chips)):
        state = jc.start_channel(state, ch, d, c)
    spec = tc.code_spectra_np(prns, n, fs)
    tables = tc.channel_code_tables(prns, n)
    gains = (jc.second_order_gains(18.0, t_s=e_sub * 1e-3),
             jc.second_order_gains(2.0, t_s=e_sub * 1e-3))
    st_x, out_x = jc.track_epochs(
        jnp.asarray(iq), state, jnp.asarray(tables),
        fs=fs, pll_gains=gains[0], dll_gains=gains[1],
        epochs_per_step=e_sub,
        code_ffts=None if gather else jnp.asarray(spec), use_pallas=False,
        **opts)
    st_t, out_t = tc.track_epochs(
        torch.from_numpy(iq),
        tc.state_from_numpy(jax.tree.map(np.asarray, state), "cpu"),
        torch.from_numpy(tables) if gather else None, fs=fs,
        pll_gains=gains[0], dll_gains=gains[1], epochs_per_step=e_sub,
        code_ffts=None if gather else torch.from_numpy(spec), **opts)
    return (jax.tree.map(np.asarray, st_x), jax.tree.map(np.asarray, out_x),
            tc.state_to_numpy(st_t), [o.numpy() for o in out_t])


@pytest.mark.parametrize("e_sub", [4, 10])
def test_track_epochs_matches_jax_einsum(e_sub):
    svs = [synth.SvSignal(prn=7, doppler_hz=1234.0, code_phase_chips=500.25),
           synth.SvSignal(prn=21, doppler_hz=-2100.0,
                          code_phase_chips=12.75, amplitude=0.7)]
    st_x, out_x, st_t, out_t = _run_both(
        FS, svs, 40, e_sub, 4, [500.25, 12.75], [1234.0, -2100.0])
    ip_t, qp_t, e_t, _, _, _, cp_t = out_t
    assert ip_t.shape == out_x.ip.shape
    ref = np.abs(out_x.ip).max()
    np.testing.assert_allclose(ip_t, out_x.ip, atol=2e-3 * ref)
    np.testing.assert_allclose(qp_t, out_x.qp, atol=2e-3 * ref)
    np.testing.assert_allclose(e_t, out_x.e_mag, atol=2e-3 * ref)
    np.testing.assert_allclose(cp_t, out_x.code_phase, atol=1e-4)
    np.testing.assert_allclose(st_t.carrier_freq, st_x.carrier_freq,
                               atol=0.05)


def test_state_round_trip_and_dtypes():
    st = jc.start_channel(jc.init_state(3), 1, 500.0, 1022.5)
    np_st = jax.tree.map(np.asarray, st)
    t = tc.state_from_numpy(np_st, "cpu")
    assert t.active.dtype == torch.bool
    assert t.code_phase.dtype == torch.float32
    back = tc.state_to_numpy(t)
    for a, b in zip(back, np_st):
        np.testing.assert_array_equal(a, b)
    # float64 host arrays are cast down at the boundary
    t64 = tc.state_from_numpy(
        {k: np.asarray(v, np.float64) for k, v in np_st._asdict().items()},
        "cpu")
    assert t64.carrier_seed.dtype == torch.float32


def test_start_channels_matches_jax():
    args = ([0, 2], [1500.0, -700.0], [1022.75, 3000.5], [1500.0, -700.0])
    want = jax.tree.map(np.asarray, jc.start_channels(jc.init_state(4), *args))
    got = tc.state_to_numpy(tc.start_channels(tc.init_state(4, "cpu"),
                                              *args))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("prns", [[7, 21], [1, 32, 5]])
def test_channel_code_tables_match_jax(prns):
    np.testing.assert_array_equal(tc.channel_code_tables(prns, 4),
                                  jc.channel_code_tables(prns, 4))


def test_track_epochs_needs_code_ffts():
    """One correlator input is required: with neither the spectra nor the
    code tables, the call raises."""
    with pytest.raises(ValueError, match="code_ffts.*code_tables"):
        tc.track_epochs(torch.zeros(5456, dtype=torch.complex64),
                        tc.init_state(1, "cpu"), fs=FS,
                        pll_gains=(1.0, 1.0), dll_gains=(1.0, 1.0))


_SVS = [(7, 1234.0, 500.25, 1.0), (21, -2100.0, 12.75, 0.7)]


@pytest.mark.parametrize("gather,e_sub,opts", [
    (True, 10, {}),
    (False, 10, dict(corr_spacing=0.25)),
    (False, 2, dict(corr_spacing=1.0)),
    (True, 10, dict(corr_spacing=1.0)),
    (False, 10, dict(fll_bn_hz=8.0, carrier_aiding=False)),
    (True, 10, dict(carrier_aiding=False, aid_offset_hz=300.0)),
], ids=["gather", "fft-spacing-0.25", "fft-spacing-1.0",
        "gather-spacing-1.0", "fft-fll8-no-aiding", "gather-no-aiding"])
def test_track_epochs_options_match_jax(gather, e_sub, opts):
    """The gather correlator and the loop options against the JAX
    tracker at the file's tolerances.  At 1-chip spacing the early and
    late taps sit near the triangle's zeros, so the DLL discriminator
    divides the two FFT formulations' float32 rounding by a small E + L;
    that case runs 2-epoch steps, whose code phase output follows the
    loop sooner."""
    svs = [synth.SvSignal(prn=p, doppler_hz=d, code_phase_chips=c,
                          amplitude=a) for p, d, c, a in _SVS]
    st_x, out_x, st_t, out_t = _run_both(
        FS, svs, 30, e_sub, 4, [c for _, _, c, _ in _SVS],
        [d for _, d, _, _ in _SVS], gather=gather, **opts)
    ip_t, qp_t, e_t, l_t, _, cd_t, cp_t = out_t
    ref = np.abs(out_x.ip).max()
    np.testing.assert_allclose(ip_t, out_x.ip, atol=2e-3 * ref)
    np.testing.assert_allclose(qp_t, out_x.qp, atol=2e-3 * ref)
    np.testing.assert_allclose(e_t, out_x.e_mag, atol=2e-3 * ref)
    np.testing.assert_allclose(l_t, out_x.l_mag, atol=2e-3 * ref)
    np.testing.assert_allclose(cp_t, out_x.code_phase, atol=1e-4)
    np.testing.assert_allclose(st_t.carrier_freq, st_x.carrier_freq,
                               atol=0.05)


def test_agc_hysteresis_matches_jax():
    """agc_thresholds: the Costas gain halves above ``hi`` and the flag
    holds until the power falls below ``lo``, in step with the JAX
    tracker (tests/test_track.py's AGC case, at small size)."""
    svs = [synth.SvSignal(prn=p, doppler_hz=d, code_phase_chips=c,
                          amplitude=a) for p, d, c, a in _SVS]
    p = int(round(FS * 1e-3))
    # after three steps the running power of the strong channel sits
    # above hi, the weak one's between lo and hi: one flag switches on,
    # the other holds its state
    thr = (1.0, (0.45 * p) ** 2)
    st_x, out_x, st_t, out_t = _run_both(
        FS, svs, 30, 10, 4, [c for _, _, c, _ in _SVS],
        [d for _, d, _, _ in _SVS], agc_thresholds=thr)
    np.testing.assert_array_equal(st_t.agc_on, st_x.agc_on)
    assert st_t.agc_on.any() and not st_t.agc_on.all()
    ref = np.abs(out_x.ip).max()
    np.testing.assert_allclose(out_t[0], out_x.ip, atol=2e-3 * ref)
    np.testing.assert_allclose(st_t.carrier_freq, st_x.carrier_freq,
                               atol=0.05)


def test_carrier_pull_in_matches_jax():
    st = jc.start_channels(jc.init_state(4), [0, 2], [1500.0, -700.0],
                           [10.0, 20.0], [1400.0, -650.0])
    st = st._replace(pll_acc=st.pll_acc + 3.0)
    want = jax.tree.map(np.asarray, jc.carrier_pull_in(st, 250.0))
    got = tc.state_to_numpy(tc.carrier_pull_in(
        tc.state_from_numpy(jax.tree.map(np.asarray, st), "cpu"), 250.0))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-3)
    assert got.pll_acc[1] == 3.0 and got.pll_acc[0] == 0.0
