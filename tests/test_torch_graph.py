"""``GraphedTracker``, the channel bank as one device program per chunk.

On a card it replays one CUDA graph per chunk shape (``chip_smoke.py``
holds it against eager ``track_epochs`` there).  Here, on the CPU, it is
``track_epochs`` with its options bound: over a chain of chunks with
channel starts and stops, a changed oscillator offset, new slot PRNs and
a partial tail chunk, it gives chained ``track_epochs`` calls' results
bit for bit; its outputs never alias another call's or another
tracker's; a tracker for a card refuses CPU tensors.
"""

import numpy as np
import pytest
import torch

from tpu_gnss_torch.signal import synth
from tpu_gnss_torch.track import channel as tc
from tpu_gnss_torch.track.graph import GraphedTracker
from tests.torch_threads import one_torch_thread  # noqa: F401

FS = 2.048e6
E_SUB = 10
N_CHAN = 4
_SVS = [(7, 1234.0, 500.25), (21, -2100.0, 12.75), (5, 800.0, 300.5),
        (13, -450.0, 900.0)]


def _opts():
    return dict(fs=FS, pll_gains=tc.second_order_gains(18.0, t_s=0.01),
                dll_gains=tc.second_order_gains(2.0, t_s=0.01),
                epochs_per_step=E_SUB, agc_thresholds=(1e5, 4e5))


def _samples(n_steps, seed):
    p = int(round(FS * 1e-3))
    svs = [synth.SvSignal(prn=q, doppler_hz=d, code_phase_chips=c)
           for q, d, c in _SVS]
    return torch.from_numpy(synth.synth_baseband(
        svs, FS, int(n_steps * E_SUB * p), noise_std=0.4, seed=seed))


def _code(prns, gather):
    if gather:
        return torch.from_numpy(tc.channel_code_tables(prns, N_CHAN)), None
    return None, torch.from_numpy(tc.code_spectra_np(prns, N_CHAN, FS))


def _chain(track, gather):
    """Five chunks (4 + 4 + 4 + 4 steps, then a 2.5-step tail) with the
    bank edited between them as the receiver edits it."""
    state = tc.start_channels(tc.init_state(N_CHAN, "cpu"), [0, 1],
                              [1240.0, -2095.0], [500.25, 12.75],
                              [1234.0, -2100.0])
    prns, aid, outs = [7, 21, 1, 1], 0.0, []
    for k, steps in enumerate((4, 4, 4, 4, 2.5)):
        if k == 1:      # a new SV in slot 2
            prns[2] = 5
            state = tc.start_channels(state, [2], [805.0], [300.5], [800.0])
        if k == 2:      # the oscillator offset re-estimated mid-run
            aid = 180.0
        if k == 3:      # slot 1 lost; slot 3 re-seeded on another PRN
            state = tc.stop_channel(state, 1)
            prns[3] = 13
            state = tc.start_channels(state, [3], [-440.0], [900.0],
                                      [-450.0])
        tables, ffts = _code(prns, gather)
        state, out = track(_samples(steps, seed=k), state, tables, ffts,
                           aid)
        outs.append(out)
    return state, outs


@pytest.mark.parametrize("gather", [False, True], ids=["fft", "gather"])
def test_graphed_tracker_chain_equals_track_epochs(gather):
    tracker = GraphedTracker(**_opts(), device="cpu")
    eager = lambda x, st, tables, ffts, aid: tc.track_epochs(
        x, st, tables, code_ffts=ffts, aid_offset_hz=aid, **_opts())
    st_g, outs_g = _chain(tracker, gather)
    st_e, outs_e = _chain(eager, gather)
    for a, b in zip(st_g, st_e):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert [o.ip.shape[0] for o in outs_g] == [40, 40, 40, 40, 20]
    for og, oe in zip(outs_g, outs_e):
        for a, b in zip(og, oe):
            assert torch.equal(a, b)
    assert bool(st_g.active[2]) and not bool(st_g.active[1])


def test_trackers_never_alias_outputs():
    """Two trackers on the same inputs, and two calls of one tracker:
    equal results in separate storage, so writing one leaves the others
    as they were."""
    a, b = (GraphedTracker(**_opts(), device="cpu") for _ in range(2))
    x = _samples(3, seed=5)
    tables, ffts = _code([7, 21, 5, 13], gather=False)
    st = tc.start_channels(tc.init_state(N_CHAN, "cpu"), [0, 1, 2, 3],
                           [d for _, d, _ in _SVS], [c for _, _, c in _SVS],
                           [d for _, d, _ in _SVS])
    runs = [a(x, st, tables, ffts), b(x, st, tables, ffts),
            a(x, st, tables, ffts)]
    flat = [[t for part in run for t in part] for run in runs]
    keep = [[t.clone() for t in ts] for ts in flat]
    ptrs = [{t.untyped_storage().data_ptr() for t in ts} for ts in flat]
    assert not (ptrs[0] & ptrs[1]) and not (ptrs[0] & ptrs[2])
    assert not (ptrs[1] & ptrs[2])
    for t in flat[0]:
        t.zero_()
    for ts, want in zip(flat[1:], keep[1:]):
        for t, w in zip(ts, want):
            assert torch.equal(t, w)
    for t, w in zip(flat[1], keep[0]):
        assert torch.equal(t, w)


def test_card_tracker_refuses_cpu_tensors():
    """A tracker for the card never runs the CPU path."""
    tracker = GraphedTracker(**_opts(), device="cuda")
    _, ffts = _code([7, 21, 5, 13], gather=False)
    with pytest.raises(ValueError, match="GraphedTracker on cuda"):
        tracker(_samples(1, seed=0), tc.init_state(N_CHAN, "cpu"), None,
                ffts)
