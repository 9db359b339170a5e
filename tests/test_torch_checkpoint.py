"""Checkpoints cross between the packages: a file written by either loads
in the other (tpu_gnss/utils/checkpoint.py against
tpu_gnss_torch/utils/checkpoint.py, the npz keys shared).

Each direction carries ephemerides, the almanac store, channel state,
detections holding numpy scalars, and meta; a file with one ``chan_*``
field dropped (a checkpoint older than the field) loads with
``init_state``'s default in both packages.

The port reads each npz member of a file once (``_read_npz``), as
``np.load`` gives it, and counts the reads in ``checkpoint.member_reads``.
"""

import dataclasses
import io
import zipfile

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
from tpu_gnss_torch.utils.metrics import METRICS
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


def _zip_of_npy(path, arrays, version=None, compression=zipfile.ZIP_STORED):
    """An npz built by hand: each array written as ``<key>.npy`` in the
    npy format ``version`` (numpy's choice where None)."""
    with zipfile.ZipFile(path, "w", compression) as zf:
        for k, a in arrays.items():
            zf.writestr(k + ".npy", _npy_bytes(a, version))


def _mixed():
    rng = np.random.default_rng(7)
    return dict(f8=rng.standard_normal(6), i4=np.arange(5, dtype=np.int32),
                u8=np.frombuffer(b'{"a": 1}', np.uint8),
                b=np.array([True, False]),
                c8=(rng.standard_normal(3) + 1j).astype(np.complex64),
                m=rng.standard_normal((3, 4)).astype(np.float32),
                s=np.float64(2.5), rec=np.array([(1, 2.0)], "<i2,>f4"))


def _case(name, path):
    """Write the archive of reader case ``name`` at ``path``."""
    if name == "savez_compressed":
        np.savez_compressed(path, **_mixed())
    elif name == "savez":
        np.savez(path, **_mixed())
    elif name in ("npy_v2", "npy_v3"):
        _zip_of_npy(path, _mixed(), version=(int(name[-1]), 0),
                    compression=zipfile.ZIP_DEFLATED)
    elif name == "lzma":
        # a compression other than deflate
        _zip_of_npy(path, _mixed(), compression=zipfile.ZIP_LZMA)
    elif name == "zip64":
        # local headers with a zip64 extra field
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
            for k, a in _mixed().items():
                with zf.open(k + ".npy", "w", force_zip64=True) as f:
                    f.write(_npy_bytes(a))
    elif name == "streamed":
        # written to a pipe: sizes and CRCs in data descriptors after
        # each member, the local headers' sizes left zero
        with open(path, "wb") as raw:
            with zipfile.ZipFile(_Unseekable(raw), "w",
                                 zipfile.ZIP_DEFLATED) as zf:
                for k, a in _mixed().items():
                    zf.writestr(k + ".npy", _npy_bytes(a))
    elif name == "fortran_2d":
        a = np.asfortranarray(np.arange(12.0).reshape(3, 4))
        np.savez_compressed(path, f=a, c=np.ascontiguousarray(a),
                            f3=np.asfortranarray(np.ones((2, 3, 2), "<i8")))
    elif name == "big_endian":
        np.savez(path, be=np.arange(4.0).astype(">f8"),
                 bei=np.arange(3).astype(">i4"), le=np.arange(4.0))
    elif name == "empty":
        np.savez_compressed(path, e=np.zeros(0), e2=np.zeros((0, 3), "<i4"),
                            full=np.ones(2))
    elif name == "not_npy":
        # a member that is no npy array: np.load gives its bytes
        with zipfile.ZipFile(path, "w") as zf:
            zf.writestr("notes.txt", b"written by hand")
            zf.writestr("x.npy", _npy_bytes(np.arange(3.0)))
    elif name == "object":
        _zip_of_npy(path, dict(ok=np.ones(2),
                               obj=np.array([{"a": 1}, None], object)))
    else:
        raise AssertionError(name)


class _Unseekable(io.RawIOBase):
    """A file that can only be written to, as a pipe."""

    def __init__(self, f):
        self.f = f

    def writable(self):
        return True

    def write(self, b):
        return self.f.write(b)


def _npy_bytes(a, version=None):
    buf = io.BytesIO()
    np.lib.format.write_array(buf, a, version=version, allow_pickle=True)
    return buf.getvalue()


@pytest.mark.parametrize("case", ["savez_compressed", "savez", "npy_v2",
                                  "npy_v3", "lzma", "zip64", "streamed",
                                  "fortran_2d", "big_endian",
                                  "empty", "not_npy", "object"])
def test_one_pass_reader_gives_what_np_load_gives(tmp_path, case):
    """``_read_npz`` against ``np.load(allow_pickle=False)``, member by
    member: the keys in order, values bit for bit, dtype with its byte
    order, shape, memory order and writability; an object-dtype member
    refused with ``ValueError`` by both."""
    p = str(tmp_path / "case.npz")
    _case(case, p)
    if case == "object":
        with np.load(p, allow_pickle=False) as z:
            with pytest.raises(ValueError, match="allow_pickle=False"):
                z["obj"]
        with pytest.raises(ValueError, match="allow_pickle=False"):
            ck._read_npz(p)
        return
    got = ck._read_npz(p)
    with np.load(p, allow_pickle=False) as z:
        assert list(got) == z.files
        for k in z.files:
            want, mine = z[k], got[k]
            if isinstance(want, bytes):
                assert mine == want, k
                continue
            assert type(mine) is np.ndarray, k
            assert mine.dtype.str == want.dtype.str, k
            assert mine.dtype == want.dtype and mine.shape == want.shape, k
            for flag in ("C_CONTIGUOUS", "F_CONTIGUOUS", "WRITEABLE"):
                assert mine.flags[flag] == want.flags[flag], (k, flag)
            assert mine.tobytes("A") == want.tobytes("A"), k
            np.testing.assert_array_equal(mine, want, err_msg=k)


def _harness_ephemeris(k):
    """An ephemeris with every field set, as the receiver decodes one."""
    vals = {f.name: (k + 1) * 1.0e-3 * (i + 1) + 0.125 * i
            for i, f in enumerate(dataclasses.fields(Ephemeris))}
    vals.update(week=2345.0, iodc=40.0 + k, iode2=40.0 + k, iode3=40.0 + k,
                sqrt_a=5153.7 + 0.1 * k, e=0.004 + 1e-3 * k, t_oe=302400.0,
                tow=50400 + 6 * k, has_utc=k % 2 == 0,
                alpha=(1.1e-8, 7.4e-9 * k, -6.0e-8, 1.2e-7),
                beta=(90112.0, -32768.0 * k, -131072.0, 65536.0))
    return Ephemeris(**vals)


@pytest.mark.parametrize("dropped", [None, "eph_a0_utc"])
def test_harness_checkpoint_loads_as_the_reference_does(tmp_path, dropped,
                                                        monkeypatch):
    """A warm start's checkpoint as the benchmark writes one (6 PRNs,
    their ephemerides, an almanac reduced from them, the last fix): the
    port's load gives the reference's records field by field and type by
    type, also for a file older than an ``eph_*`` field (its default
    kept), reads each member from the archive once, and counts those
    reads."""
    p = str(tmp_path / "checkpoint.npz")
    ephs = {prn: _harness_ephemeris(k) for k, prn in enumerate(range(2, 8))}
    alms = {prn: Almanac.from_ephemeris(prn, e) for prn, e in ephs.items()}
    meta = dict(last_fix=dict(ecef=[3.9e6, -1.2e5, 5.0e6], tow=302512.5))
    ck.save_state(p, ephemerides=ephs, almanac=alms, meta=meta)
    if dropped:
        z = dict(np.load(p))
        del z[dropped]
        np.savez_compressed(p, **z)
    with np.load(p) as z:
        n_members, npz_file = len(z.files), type(z)
    assert n_members == (51 if dropped is None else 50)
    _assert_same_load(p)
    reads = []
    getitem = npz_file.__getitem__
    monkeypatch.setattr(npz_file, "__getitem__",
                        lambda z, k: reads.append(k) or getitem(z, k))
    for _ in range(2):
        reads.clear()
        before = METRICS.counters["checkpoint.member_reads"]
        mine = ck.load_state(p, device="cpu")
        assert sorted(reads) == sorted(set(reads)) and len(reads) == n_members
        assert (METRICS.counters["checkpoint.member_reads"] - before
                == n_members)
    monkeypatch.undo()
    ref = jck.load_state(p)
    assert set(mine) == set(ref) == {"ephemerides", "almanac", "meta"}
    assert mine["meta"] == ref["meta"] == meta
    assert list(mine["almanac"]) == list(ref["almanac"]) == list(alms)
    for prn, a in alms.items():
        for f in dataclasses.fields(a):
            got, want = getattr(mine["almanac"][prn], f.name), getattr(
                ref["almanac"][prn], f.name)
            assert got == want == getattr(a, f.name), (prn, f.name)
            assert type(got) is type(want), (prn, f.name)
    for prn, e in ephs.items():
        got = mine["ephemerides"][prn]
        assert got.a0_utc == (0.0 if dropped else e.a0_utc)
        assert got.alpha == e.alpha and got.beta == e.beta
        assert all(type(v) is np.float64 for v in got.alpha + got.beta)
