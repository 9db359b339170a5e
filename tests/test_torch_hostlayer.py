"""The port's copy of the float64 host layer against its source.

``tpu_gnss_torch`` keeps its own copies of the jax-free modules it needs
(constants, config, C/A codes, signal synthesis, the 1-bit loaders and
stream sources, NAV decode, PVT, satellite geometry).  Each copy is held
to the reference module on the same seeded numpy inputs: equal where the
arithmetic is the same code, within 1e-9 for the float64 solver.
"""

import dataclasses

import numpy as np
import pytest

from tpu_gnss import config as jcfg
from tpu_gnss.cli import nmea_out as jnmea
from tpu_gnss.io import loaders as jld
from tpu_gnss.io import stream as jst
from tpu_gnss.nav import bits as jnb
from tpu_gnss.nav import ephemeris as jne
from tpu_gnss.pvt import solve as jps
from tpu_gnss.signal import cacode as jca
from tpu_gnss.signal import synth as jsy

from tpu_gnss_torch import config as tcfg
from tpu_gnss_torch.cli import nmea_out as tnmea
from tpu_gnss_torch.io import loaders as tld
from tpu_gnss_torch.io import stream as tst
from tpu_gnss_torch.nav import bits as tnb
from tpu_gnss_torch.nav import ephemeris as tne
from tpu_gnss_torch.pvt import solve as tps
from tpu_gnss_torch.signal import cacode as tca
from tpu_gnss_torch.signal import scene
from tpu_gnss_torch.signal import synth as tsy

_DERIVED = ("lags", "dop_max_bin", "num_dop_bins", "dop_bin_hz",
            "samples_per_ms", "ca_rate", "lo_rate")


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_presets_equal(name):
    want, got = jcfg.PRESETS[name], tcfg.PRESETS[name]
    assert sorted(tcfg.PRESETS) == sorted(jcfg.PRESETS)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for attr in _DERIVED:
        assert getattr(got, attr) == getattr(want, attr), attr


@pytest.mark.parametrize("fs", [2.048e6, 5.456e6, 8.184e6, 12.5e6])
def test_code_table_and_resample_equal(fs):
    np.testing.assert_array_equal(tca.code_table(), jca.code_table())
    np.testing.assert_array_equal(tca.g1_state_table(), jca.g1_state_table())
    p = int(round(fs * 1e-3))
    chips = jca.code_table()[[0, 7, 31]]
    np.testing.assert_array_equal(tca.resample(chips, fs, p),
                                  jca.resample(chips, fs, p))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_onebit_loaders_equal(seed):
    rng = np.random.default_rng(seed)
    assert tld.LO_TABLES == jld.LO_TABLES
    bits = rng.integers(0, 2, 8 * 1000 + 8 * seed, dtype=np.uint8)
    raw = tld.pack_1bit(bits)
    assert raw == jld.pack_1bit(bits)
    np.testing.assert_array_equal(tld.unpack_1bit(raw), jld.unpack_1bit(raw))
    np.testing.assert_array_equal(tld.unpack_1bit(raw, 1001),
                                  jld.unpack_1bit(raw, 1001))
    cfg = jcfg.PRESETS["nottingham"]
    sample0 = int(rng.integers(0, 10 ** 9))
    np.testing.assert_array_equal(
        tld.lo_phase_index(len(bits), cfg.lo_rate, sample0),
        jld.lo_phase_index(len(bits), cfg.lo_rate, sample0))
    np.testing.assert_array_equal(
        tld.mix_1bit_block(bits, cfg, sample0=sample0),
        jld.mix_1bit_block(bits, cfg, sample0=sample0))


@pytest.mark.parametrize("mode", ["blocks", "bit_blocks", "packed_blocks"])
def test_file_source_equal(tmp_path, mode):
    """The port's FileSource1Bit yields the reference's blocks, final
    partial chunk included, directly and through the Prefetcher."""
    rng = np.random.default_rng(5)
    path = tmp_path / "cap.bin"
    path.write_bytes(jld.pack_1bit(rng.integers(0, 2, 8 * 5003,
                                                dtype=np.uint8)))
    cfg = jcfg.PRESETS["nottingham"]
    want = list(getattr(jst.FileSource1Bit(str(path), cfg), mode)(4096))
    got = list(getattr(tst.FileSource1Bit(str(path), cfg), mode)(4096))
    mode_name = {"blocks": "iq", "bit_blocks": "bits",
                 "packed_blocks": "packed"}[mode]
    pf = tst.Prefetcher(tst.FileSource1Bit(str(path), cfg), 4096,
                        mode=mode_name)
    fetched = list(pf)
    pf.stop()
    assert len(got) == len(want) == len(fetched) > 1
    for g, f, w in zip(got, fetched, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(f, w)


@pytest.mark.parametrize("seed", [3, 4])
def test_synth_baseband_equal(seed):
    svs = [(3, 1840.0, 303.4, 1.0), (19, -3810.0, 1001.9, 0.6)]
    fs, n = 4.092e6, 12_000
    want = jsy.synth_baseband([jsy.SvSignal(prn=p, doppler_hz=d,
                                            code_phase_chips=c, amplitude=a)
                               for p, d, c, a in svs],
                              fs, n, noise_std=1.0, seed=seed)
    got = tsy.synth_baseband([tsy.SvSignal(prn=p, doppler_hz=d,
                                           code_phase_chips=c, amplitude=a)
                              for p, d, c, a in svs],
                             fs, n, noise_std=1.0, seed=seed)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tsy.baseband_to_1bit_if(got, 1.023e6, fs),
                                  jsy.baseband_to_1bit_if(want, 1.023e6, fs))


def _eph_kwargs(k: int) -> dict:
    """Ephemeris fields of scene.make_constellation's SV k."""
    return dataclasses.asdict(scene.make_constellation(k + 1)[k])


@pytest.mark.parametrize("inverted", [False, True])
def test_subframes_encode_decode_equal(inverted):
    ref = jne.Ephemeris(**_eph_kwargs(2))
    port = tne.Ephemeris(**_eph_kwargs(2))
    sids = (4, 1, 2, 3)
    want_frames = jne.encode_subframes(ref, tow_start=17000, sids=sids)
    got_frames = tne.encode_subframes(port, tow_start=17000, sids=sids)
    for g, w in zip(got_frames, want_frames, strict=True):
        np.testing.assert_array_equal(g, w)
    stream = np.concatenate(got_frames)
    if inverted:
        stream = 1 - stream
    decoded = []
    for nb, ne in ((tnb, tne), (jnb, jne)):
        found = nb.frame_sync(stream)
        assert len(found) == 4
        assert all(f["inverted"] == inverted for f in found)
        eph = ne.Ephemeris()
        for f in found:
            eph.ingest(f["data"])
        assert eph.valid()
        decoded.append(dataclasses.asdict(eph))
    assert decoded[0] == decoded[1]


@pytest.mark.parametrize("n_sv", [5, 6])
def test_solve_raim_and_sat_geometry_equal(n_sv):
    """The port's RAIM solve and satellite geometry on the port's
    Ephemeris objects against the reference's on its own, with one
    pseudorange fault at 6 SVs (the exclusion path)."""
    t_rx = scene.T_OE + 100.0
    rx = jps.geodetic_to_ecef(*scene.TRUTH_LLA)
    ref = [jne.Ephemeris(**_eph_kwargs(k)) for k in range(n_sv)]
    port = [tne.Ephemeris(**dataclasses.asdict(e)) for e in ref]
    t_tx = np.array([scene.sv_time_knots(e, rx, [t_rx])[0] for e in ref])
    if n_sv == 6:
        t_tx[4] += 1e-3                      # a code-period slip
    w = np.linspace(1.0, 2.0, n_sv)
    got, gx = tps.solve_position_raim(t_tx, port, w)
    want, wx = jps.solve_position_raim(t_tx, ref, w)
    assert gx == wx and (wx is not None) == (n_sv == 6)
    assert got.converged and want.converged
    for f in ("x", "y", "z", "t_bias", "residual_rms_m"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=0, atol=1e-9, err_msg=f)
    pos = np.array([want.x, want.y, want.z])
    assert np.linalg.norm(pos - np.array(rx)) < 1.0
    sv = np.array([e.get_xyz(t) for e, t in zip(ref, t_tx)])
    ge, ga, gd = tnmea.sat_geometry(pos, sv)
    we, wa, wd = jnmea.sat_geometry(pos, sv)
    np.testing.assert_allclose(ge, we, rtol=0, atol=1e-9)
    np.testing.assert_allclose(ga, wa, rtol=0, atol=1e-9)
    assert sorted(gd) == sorted(wd) == ["gdop", "hdop", "pdop", "vdop"]
    for k in wd:
        np.testing.assert_allclose(gd[k], wd[k], rtol=0, atol=1e-9)
