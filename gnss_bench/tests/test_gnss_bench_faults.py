"""The harness with the timed path broken underneath, driven on the CPU
at a test size: ``correct`` comes out false for each fault the cells can
have.  (A cell takes one card, so there is no exchange between chips to
leave out.)"""

from __future__ import annotations

import pytest
import torch


def test_sound_run_is_correct(cpu_run):
    out = cpu_run("1bit")
    assert out["correct"], (out["bad"], out["missed"], out["errors"])
    assert out["failed"] == 0 and out["attempted"] == 1


def test_state_returned_unchanged(cpu_run, monkeypatch):
    from tpu_gnss_torch.track import channel as tc
    orig = tc.loop_update

    def frozen(taps, state, aid, par, outs, s, opts):
        saved = state.clone()
        orig(taps, state, aid, par, outs, s, opts)
        state.copy_(saved)
        if par is not None:
            par.copy_(tc.step_params(state, opts))
    monkeypatch.setattr(tc, "loop_update", frozen)
    out = cpu_run("1bit")
    assert not out["correct"]


def test_half_the_epochs_left_out(cpu_run, monkeypatch):
    # each step's second half of epochs replaced by the mean of the first
    from tpu_gnss_torch.ops import mxu_track
    orig = mxu_track.track_corr

    def half(*a, **kw):
        taps = orig(*a, **kw)
        h = taps.shape[0] // 2
        taps[h:] = taps[:h].mean(0, keepdim=True)
        return taps
    monkeypatch.setattr(mxu_track, "track_corr", half)
    out = cpu_run("1bit")
    assert not out["correct"]
    assert out["numbers"]["prompt_gap"] > out["checks"]["prompt_gap"][
        "limit"]


def test_a_prompt_altered_where_it_is_made(cpu_run, monkeypatch):
    from tpu_gnss_torch.ops import mxu_track
    orig = mxu_track.track_corr
    calls = {"n": 0}

    def altered(*a, **kw):
        taps = orig(*a, **kw)
        calls["n"] += 1
        if calls["n"] == 150:          # one epoch of one channel, 3% off
            taps[3, 0, :2] *= 1.03
        return taps
    monkeypatch.setattr(mxu_track, "track_corr", altered)
    out = cpu_run("1bit")
    assert not out["correct"]
    assert "prompt_gap" in out["bad"]


def test_a_detection_altered_where_it_is_made(cpu_run, monkeypatch):
    from tpu_gnss_torch.acquire.folded import FoldedSearcher
    orig = FoldedSearcher._dets_from_stack

    def shifted(self, *a, **kw):
        dets = orig(self, *a, **kw)
        for d in dets:
            d["doppler_hz"] += 600.0
        return dets
    monkeypatch.setattr(FoldedSearcher, "_dets_from_stack", shifted)
    out = cpu_run("1bit")
    assert not out["correct"]


def test_an_ephemeris_field_decoded_one_lsb_off(cpu_run, monkeypatch):
    # c_rs one LSB (3 cm) off where the receiver decodes it: the fixes
    # stay good, the NAV comparison alone catches it
    from tpu_gnss_torch.nav import ephemeris
    orig = ephemeris.decode_field

    def off(data240, name, table=ephemeris.FIELDS):
        v = orig(data240, name, table)
        return v + table[name][3] if name == "c_rs" else v
    monkeypatch.setattr(ephemeris, "decode_field", off)
    out = cpu_run("1bit", capture_s=20.0)
    assert not out["correct"]
    assert out["bad"] == ["nav_field_mismatch"], out["bad"]
    assert out["numbers"]["fix_err_m"] < 60.0
