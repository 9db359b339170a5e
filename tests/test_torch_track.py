"""Port's tracking loop vs the JAX tracker, with every loop option.

Mirrors tests/test_track.py::test_pallas_correlator_matches_einsum: both
banks start from one state (the JAX state carried across with
``state_from_numpy``) and see the same numpy-synthesized samples, through
the FFT-dot correlator (the port's plain version against the JAX einsum
path) or the gather correlator (``code_tables``, no spectra) on both
sides.  Tolerances as stated there: ip/qp/e_mag atol 2e-3·ref,
code_phase atol 1e-4 chips, carrier_freq atol 0.05 Hz.  Also the
on-device spectra function ``code_spectra`` against the reference's, and
the launch geometry of the ``loop_update`` kernel (``loop_geometry``).
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


def _one_step_case(e_sub, agc, seed):
    """A JAX bank of 4 channels (3 active, channel 3 inactive) from a
    seeded mid-track state, one step of seeded samples through the gather
    correlator: ``(state before, state after, EpochOut, kwargs)`` as
    numpy, the state carried with every field set (previous prompts,
    integrators, an AGC flag)."""
    rng = np.random.default_rng(seed)
    svs = [synth.SvSignal(prn=p, doppler_hz=d, code_phase_chips=c,
                          amplitude=a) for p, d, c, a in _SVS]
    p = int(round(FS * 1e-3))
    iq = synth.synth_baseband(svs, FS, e_sub * p, noise_std=0.3, seed=seed)
    st = jc.start_channels(jc.init_state(4), [0, 1, 2],
                           [1234.0 + 7.0, -2100.0 - 5.0, 900.0],
                           [500.25, 12.75, 300.0], [1234.0, -2100.0, 900.0])
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))
    st = st._replace(
        carrier_phase=f32(rng.uniform(0, 1, 4)),
        pll_acc=f32(rng.normal(0, 20, 4)), dll_acc=f32(rng.normal(0, 1, 4)),
        pwr_avg=f32(rng.uniform(1e5, 1e6, 4)),
        ip_prev=f32(rng.normal(0, 900, 4)), qp_prev=f32(rng.normal(0, 900, 4)),
        agc_on=jnp.asarray([True, False, True, True]))
    kw = dict(fs=FS, pll_gains=jc.second_order_gains(18.0, t_s=e_sub * 1e-3),
              dll_gains=jc.second_order_gains(2.0, t_s=e_sub * 1e-3),
              epochs_per_step=e_sub, agc_thresholds=agc, aid_offset_hz=250.0)
    tables = tc.channel_code_tables([7, 21, 5, 1], 4)
    after, out = jc.track_epochs(jnp.asarray(iq), st, jnp.asarray(tables),
                                 use_pallas=False, **kw)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return to_np(st), to_np(after), to_np(out), kw


@pytest.mark.parametrize("e_sub,agc", [
    (10, None), (4, None), (10, (2e5, 5e5))], ids=["e10", "e4", "e10-agc"])
def test_loop_update_plain_matches_jax_epoch_body(e_sub, agc):
    """One ``loop_update_plain`` step on the reference's own correlator
    output ``(ip, qp, |e|, 0, |l|, 0)`` against the reference's epoch
    body (tpu_gnss/track/channel.py:441-541): the new state and the
    step's seven output planes within rtol 1e-6 (float32 atan and
    summation order); flags equal; the next step's track_corr
    parameters from the new state as ``step_params`` computes them.
    The carrier phase is the float32 sum of a phase in [0, 1) and the
    step's advance of tens of cycles, whose ulp (~2e-6 cycles) is above
    1e-6 of the phase: it is held wrap-aware to 1e-6 of the cycles the
    step advanced."""
    before, after, out, kw = _one_step_case(e_sub, agc, seed=11)
    taps = np.stack([out.ip, out.qp, out.e_mag, np.zeros_like(out.ip),
                     out.l_mag, np.zeros_like(out.ip)], axis=-1)
    state = tc.pack_state(tc.state_from_numpy(before, "cpu"))
    opts = tc.loop_opts(**{k: v for k, v in kw.items()
                           if k != "aid_offset_hz"})
    outs = torch.empty(7, e_sub, 4)
    par = torch.empty(e_sub, 4, 5)
    tc.loop_update_plain(torch.from_numpy(taps.astype(np.float32)), state,
                         tc.aid_tensor(kw["aid_offset_hz"], "cpu"), par,
                         outs, 0, opts)
    got = tc.state_to_numpy(tc.unpack_state(state))
    for f in tc.ChannelState._fields:
        a, b = getattr(got, f), getattr(after, f)
        if f in ("active", "agc_on"):
            np.testing.assert_array_equal(a, b, err_msg=f)
        elif f == "carrier_phase":
            cycles = (np.abs(after.carrier_freq).max() * opts.period
                      * e_sub / FS)
            d = np.abs(a.astype(np.float64) - b)
            assert np.minimum(d, 1.0 - d).max() <= 1e-6 * cycles
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=f)
    for plane, f in zip(outs.numpy(), tc.EpochOut._fields):
        np.testing.assert_allclose(plane, getattr(out, f), rtol=1e-6,
                                   err_msg=f)
    if agc is not None:
        assert got.agc_on.tolist() != before.agc_on.tolist()
    torch.testing.assert_close(par, tc.step_params(state, opts), rtol=0,
                               atol=0)


def test_loop_update_prepare_only_writes_params():
    """``taps=None`` leaves the state as it is and writes the params of
    the step that starts from it: step 0's ``track_corr`` input."""
    before, _, _, kw = _one_step_case(10, None, seed=3)
    state = tc.pack_state(tc.state_from_numpy(before, "cpu"))
    want_state = state.clone()
    opts = tc.loop_opts(**{k: v for k, v in kw.items()
                           if k != "aid_offset_hz"})
    par = torch.full((10, 4, 5), float("nan"))
    tc.loop_update(None, state, tc.aid_tensor(0.0, "cpu"), par, None, 0,
                   opts)
    assert torch.equal(state, want_state)
    assert torch.equal(par, tc.step_params(state, opts))
    # the wrap flags are 0/1 and the prompt lag lies in [0, P)
    assert set(par[..., 3:].unique().tolist()) <= {0.0, 1.0}
    assert bool((par[..., 2] >= 0).all()) and bool(
        (par[..., 2] < opts.period).all())


@pytest.mark.parametrize("fs,prns,n_chan", [
    (2.048e6, [3, 7, 19], 5), (5.456e6, [1, 32], 4),
    (10e6, [5, 21, 12], 12)], ids=["2.048", "5.456", "10"])
def test_code_spectra_matches_jax(fs, prns, n_chan):
    """``code_spectra`` against the reference's jitted function
    (tpu_gnss/track/channel.py:601-630), fewer PRNs than channels: the
    same NF, complex64, and every bin within 1e-6 x max|spec|, a few
    float32 ulps of the largest bin (the two FFTs round differently; the
    wrap's float32 angles are the same numbers in both)."""
    want, nf_x = jc.code_spectra(prns, n_chan, fs)
    got, nf = tc.code_spectra(prns, n_chan, fs, "cpu")
    want = np.asarray(want)
    assert nf == nf_x and got.dtype == torch.complex64
    assert tuple(got.shape) == want.shape == (n_chan, nf)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("e_sub", [1, 4, 10, 20])
@pytest.mark.parametrize("n_chan", [1, 3, 6, 12, 13, 32, 200, 256])
def test_loop_geometry_covers_every_epoch_once(n_chan, e_sub):
    """``loop_geometry``: a block of C channels x e_sub epochs within the
    card's 1024 threads and the default 48 KB of shared memory (the
    block's taps and 7 floats per channel), enough blocks for every
    channel, and thread ``e*C + c`` of block b on (channel b*C + c, epoch
    e) covering each (channel, epoch) exactly once."""
    chans, blocks, threads, smem = tc.loop_geometry(n_chan, e_sub)
    assert threads == chans * e_sub <= 1024
    assert smem == 4 * chans * (6 * e_sub + 7) <= 48 * 1024
    assert blocks * chans >= n_chan
    tid = np.arange(threads)
    ch = (np.arange(blocks)[:, None] * chans + tid % chans).ravel()
    ep = np.tile(tid // chans, blocks)
    live = ch < n_chan
    cells = ch[live] * e_sub + ep[live]
    assert np.array_equal(np.sort(cells), np.arange(n_chan * e_sub))
    assert tc.loop_geometry(n_chan, e_sub) == (chans, blocks, threads, smem)


def test_loop_geometry_rejects_a_step_no_block_holds():
    """One channel's 1024 epochs still fit a block; 1025 raise."""
    assert tc.loop_geometry(3, 1024)[:3] == (1, 3, 1024)
    with pytest.raises(ValueError, match="1025"):
        tc.loop_geometry(3, 1025)
