"""Port's tracking loop (plain correlator) vs the JAX einsum tracker.

Mirrors tests/test_track.py::test_pallas_correlator_matches_einsum: both
banks start from one state (the JAX state carried across with
``state_from_numpy``) and see the same numpy-synthesized samples.
Tolerances as stated there: ip/qp/e_mag atol 2e-3·ref, code_phase atol
1e-4 chips, carrier_freq atol 0.05 Hz.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gnss.signal import synth
from tpu_gnss.track import channel as jc
from tpu_gnss_torch.track import channel as tc

FS = 5.456e6


def _run_both(fs, svs, n_epochs, e_sub, seed, chips, dops):
    p = int(round(fs * 1e-3))
    iq = synth.synth_baseband(svs, fs, n_epochs * p, noise_std=0.3,
                              seed=seed)
    prns = [s.prn for s in svs]
    n = len(prns)
    state = jc.init_state(n)
    for ch, (d, c) in enumerate(zip(dops, chips)):
        state = jc.start_channel(state, ch, d, c)
    spec = tc.code_spectra_np(prns, n, fs)
    gains = (jc.second_order_gains(18.0, t_s=e_sub * 1e-3),
             jc.second_order_gains(2.0, t_s=e_sub * 1e-3))
    st_x, out_x = jc.track_epochs(
        jnp.asarray(iq), state, jnp.asarray(jc.channel_code_tables(prns, n)),
        fs=fs, pll_gains=gains[0], dll_gains=gains[1],
        epochs_per_step=e_sub, code_ffts=jnp.asarray(spec), use_pallas=False)
    st_t, out_t = tc.track_epochs(
        torch.from_numpy(iq),
        tc.state_from_numpy(jax.tree.map(np.asarray, state), "cpu"), fs=fs,
        pll_gains=gains[0], dll_gains=gains[1], epochs_per_step=e_sub,
        code_ffts=torch.from_numpy(spec))
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
    """The gather correlator is not ported: the spectra are required."""
    with pytest.raises(TypeError, match="code_ffts"):
        tc.track_epochs(torch.zeros(5456, dtype=torch.complex64),
                        tc.init_state(1, "cpu"), fs=FS,
                        pll_gains=(1.0, 1.0), dll_gains=(1.0, 1.0))
