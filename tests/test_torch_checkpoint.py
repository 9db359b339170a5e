"""Checkpoints cross between the packages: a file written by either loads
in the other (tpu_gnss/utils/checkpoint.py against
tpu_gnss_torch/utils/checkpoint.py, the npz keys shared).

Each direction carries ephemerides, the almanac store, channel state,
detections holding numpy scalars, and meta; a file with one ``chan_*``
field dropped (a checkpoint older than the field) loads with
``init_state``'s default in both packages.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_gnss.nav.almanac import Almanac as JAlmanac
from tpu_gnss.nav.ephemeris import Ephemeris as JEphemeris
from tpu_gnss.track import channel as jtc
from tpu_gnss.utils import checkpoint as jck
from tpu_gnss_torch.nav.almanac import Almanac
from tpu_gnss_torch.nav.ephemeris import Ephemeris
from tpu_gnss_torch.track import channel as tc
from tpu_gnss_torch.utils import checkpoint as ck
from tests.torch_threads import one_torch_thread  # noqa: F401


def _ephemeris(cls, k):
    e = cls(week=900, iodc=7 + k, iode2=7 + k, iode3=7 + k,
            sqrt_a=5153.0 + k, e=0.01, t_oe=302400.0, tow=50000 + k,
            m_0=0.5 * k, has_utc=bool(k % 2))
    e.alpha = (1e-8, 2e-8 * k, 0.0, -3e-8)
    e.beta = (90112.0, 0.0, -196610.0, -65536.0 * k)
    return e


def _almanac(cls, prn):
    return cls(prn=prn, e=0.004 + 1e-4 * prn, t_oa=405504.0,
               delta_i=0.01, sqrt_a=5153.6, omega_0=0.1 * prn,
               m_0=-0.2 * prn, a_f0=1e-5)


# detections as the receivers make them, with numpy scalars mixed in
DETS = [dict(prn=np.int64(9), sv=8, snr=np.float32(55.5),
             doppler_hz=1500.0, ca_shift=np.int32(123)),
        dict(prn=4, sv=3, snr=31.25, doppler_hz=np.float64(-250.0),
             ca_shift=7.5)]
META = dict(fs=5.456e6, last_fix=dict(ecef=[1.0, 2.0, 3.0],
                                      tow=np.float64(302500.0), wall=1e9))


def _assert_same_eph(a, b):
    for f in dataclasses.fields(a):
        assert getattr(a, f.name) == pytest.approx(getattr(b, f.name)), \
            f.name
    assert isinstance(a.tow, int) and isinstance(a.has_utc, bool)


def _assert_same_load(path):
    """Both packages read one file into the same values of the same
    Python types (``week`` comes back a float in both, as the
    reference's loader makes it)."""
    mine = ck.load_state(path, device="cpu")["ephemerides"]
    ref = jck.load_state(path)["ephemerides"]
    assert sorted(mine) == sorted(ref)
    for prn in ref:
        for f in dataclasses.fields(ref[prn]):
            a, b = getattr(mine[prn], f.name), getattr(ref[prn], f.name)
            assert a == b and type(a) is type(b), (prn, f.name)


def _assert_loaded(back, cls_eph, cls_alm, state_np):
    assert sorted(back["ephemerides"]) == [3, 9]
    for k, prn in ((0, 3), (1, 9)):
        _assert_same_eph(back["ephemerides"][prn], _ephemeris(cls_eph, k))
    assert sorted(back["almanac"]) == [5, 17]
    for prn in (5, 17):
        assert back["almanac"][prn] == _almanac(cls_alm, prn)
    st = back["channel_state"]
    for f in tc.ChannelState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(st, f)),
                                      state_np[f], err_msg=f)
    assert back["detections"] == [
        dict(prn=9, sv=8, snr=55.5, doppler_hz=1500.0, ca_shift=123),
        dict(prn=4, sv=3, snr=31.25, doppler_hz=-250.0, ca_shift=7.5)]
    assert back["meta"] == dict(
        fs=5.456e6, last_fix=dict(ecef=[1.0, 2.0, 3.0], tow=302500.0,
                                  wall=1e9))


def _jax_state():
    st = jtc.init_state(4)
    st = jtc.start_channel(st, 1, 1500.0, 333.5)
    return jtc.start_channel(st, 3, -2250.0, 1000.25)


def test_jax_written_loads_in_port(tmp_path):
    p = str(tmp_path / "jax.npz")
    st = _jax_state()
    jck.save_state(p, ephemerides={9: _ephemeris(JEphemeris, 1),
                                   3: _ephemeris(JEphemeris, 0)},
                   channel_state=st, detections=DETS,
                   almanac={p_: _almanac(JAlmanac, p_) for p_ in (17, 5)},
                   meta=META)
    back = ck.load_state(p, device="cpu")
    assert isinstance(back["channel_state"], tc.ChannelState)
    assert back["channel_state"].active.dtype == torch.bool
    assert back["channel_state"].carrier_seed.dtype == torch.float32
    _assert_loaded(back, Ephemeris, Almanac,
                   {f: np.asarray(getattr(st, f)) for f in st._fields})
    _assert_same_load(p)


def test_port_written_loads_in_jax(tmp_path):
    p = str(tmp_path / "port.npz")
    st = tc.state_from_numpy(
        {f: np.asarray(getattr(_jax_state(), f))
         for f in tc.ChannelState._fields}, "cpu")
    ck.save_state(p, ephemerides={9: _ephemeris(Ephemeris, 1),
                                  3: _ephemeris(Ephemeris, 0)},
                  channel_state=st, detections=DETS,
                  almanac={p_: _almanac(Almanac, p_) for p_ in (17, 5)},
                  meta=META)
    back = jck.load_state(p)
    _assert_loaded(back, JEphemeris, JAlmanac,
                   {f: getattr(st, f).numpy() for f in st._fields})
    # and the port reads its own file the same way
    mine = ck.load_state(p, device="cpu")
    _assert_loaded(mine, Ephemeris, Almanac,
                   {f: getattr(st, f).numpy() for f in st._fields})
    _assert_same_load(p)


@pytest.mark.parametrize("dropped", ["pwr_avg", "agc_on"])
def test_missing_channel_field_keeps_the_default(tmp_path, dropped):
    """A ``chan_*`` field missing from an older file keeps init_state's
    default in both packages."""
    p = str(tmp_path / "full.npz")
    jck.save_state(p, channel_state=_jax_state())
    z = dict(np.load(p))
    del z[f"chan_{dropped}"]
    old = str(tmp_path / "old.npz")
    np.savez(old, **z)
    want = jck.load_state(old)["channel_state"]
    got = ck.load_state(old, device="cpu")["channel_state"]
    for f in tc.ChannelState._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    default = tc.init_state(4, "cpu")
    assert torch.equal(getattr(got, dropped), getattr(default, dropped))
    assert bool(got.active[1]) and float(got.carrier_seed[3]) == -2250.0


def test_file_without_channel_state_never_touches_the_device(tmp_path):
    """Ephemerides only: loading with a device that does not exist here
    must not fail, since no tensor is made."""
    p = str(tmp_path / "eph.npz")
    ck.save_state(p, ephemerides={3: _ephemeris(Ephemeris, 0)})
    back = ck.load_state(p, device="cuda:7")
    assert set(back) == {"ephemerides"}
    if not torch.cuda.is_available():
        ck.save_state(p, channel_state=tc.init_state(2, "cpu"))
        with pytest.raises((RuntimeError, AssertionError)):
            ck.load_state(p, device="cuda")
