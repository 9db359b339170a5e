"""The port's sharded engines and mesh receiver against the JAX package's.

Ports tests/test_dist.py one for one: each test feeds the same seeded
inputs to the JAX engine on ``shard.make_mesh(8, ...)`` of virtual CPU
devices and to the port's engine on a mesh of 8 CPU entries, with the
reference's tolerances (equal Doppler bins and lags, SNR rtol 1e-5, 1e-4
for the folded kernel against the port's single-device kernel engine and
0.03, the bf16 kernel bound, against the JAX one; prompt I rtol 1e-5 /
atol 1e-2, code phase atol 1e-3 chips).  Beyond those: ``pad_dops``, the
sharded refined search against the JAX one (the bars of
tests/test_torch_folded.py) and against the port's single-device search
(equal), the mesh receiver against the port's ``acq_engine="mxu"``
receiver and the JAX mesh receiver (the bars of
tests/test_torch_receiver.py), its engine rule and its errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gnss.config import ReceiverConfig
from tpu_gnss.dist import shard as jshard
from tpu_gnss.signal import synth
from tpu_gnss_torch.acquire import folded as tf
from tpu_gnss_torch.acquire import search as ts
from tpu_gnss_torch.dist import shard
from tpu_gnss_torch.receiver import Receiver
from tpu_gnss_torch.signal import scene
from tpu_gnss_torch.track import channel as tc
from tpu_gnss_torch.track.quality import pll_lock_metric
from tests.torch_threads import one_torch_thread  # noqa: F401

SMALL = ReceiverConfig(fs=2.048e6, fc=0.512e6, max_fo=5000.0, fft_len=4096)


@pytest.fixture(scope="module")
def fixture_block():
    sv = synth.SvSignal(prn=17, doppler_hz=2 * SMALL.dop_bin_hz,
                        code_phase_chips=417.0)
    iq = synth.synth_baseband([sv], SMALL.fs, SMALL.fft_len, noise_std=1.0,
                              seed=21)
    return synth.baseband_to_1bit_if(iq, SMALL.fc, SMALL.fs)


def _dops(n_shards, chunk):
    return shard.pad_dops(np.arange(-SMALL.dop_max_bin, SMALL.dop_max_bin + 1,
                                    dtype=np.int32), n_shards, chunk)


def _same_acq(got, want, snr_rtol=1e-5):
    np.testing.assert_array_equal(got.lo_shift.numpy(),
                                  np.asarray(want.lo_shift))
    np.testing.assert_array_equal(got.ca_shift.numpy(),
                                  np.asarray(want.ca_shift))
    np.testing.assert_allclose(got.snr.numpy(), np.asarray(want.snr),
                               rtol=snr_rtol)


def test_doppler_sharded_matches_single(fixture_block):
    from tpu_gnss.acquire import search as S
    want = S.Searcher(SMALL, dop_chunk=4).acquire_bits(fixture_block)
    dops = _dops(8, 4)
    jiq = S.mix_baseband(jnp.asarray(fixture_block, jnp.uint8), SMALL.lo_rate)
    jgot = jshard.acquire_from_fft_sharded(
        jnp.fft.fft(jiq), S.Searcher(SMALL, dop_chunk=4).code_ffts,
        jnp.asarray(dops), mesh=jshard.make_mesh(8, axes=("dop",)),
        lags=SMALL.lags, dop_chunk=4)
    searcher = ts.Searcher(SMALL, dop_chunk=4, device="cpu")
    iq = ts.mix_baseband(torch.from_numpy(fixture_block), SMALL.lo_rate)
    got = shard.acquire_from_fft_sharded(
        torch.fft.fft(iq), searcher.code_ffts, torch.from_numpy(dops),
        mesh=shard.make_mesh(8, axes=("dop",), device="cpu"),
        lags=SMALL.lags, dop_chunk=4)
    _same_acq(got, want)
    _same_acq(got, jgot)
    _same_acq(got, searcher.acquire_bits(fixture_block), snr_rtol=0)


def test_block_doppler_sharded(fixture_block):
    from tpu_gnss.acquire import search as S
    rng = np.random.default_rng(0)
    blocks = np.stack([fixture_block,
                       rng.integers(0, 2, SMALL.fft_len).astype(np.uint8),
                       fixture_block,
                       rng.integers(0, 2, SMALL.fft_len).astype(np.uint8)])
    dops = _dops(4, 4)
    jsearch = S.Searcher(SMALL, dop_chunk=4)
    want = jshard.acquire_blocks_sharded(
        jnp.asarray(blocks), jsearch.code_ffts, jnp.asarray(dops),
        mesh=jshard.make_mesh(8, axes=("blk", "dop"), shape=(2, 4)),
        lo_rate=SMALL.lo_rate, lags=SMALL.lags, dop_chunk=4)
    searcher = ts.Searcher(SMALL, dop_chunk=4, device="cpu")
    got = shard.acquire_blocks_sharded(
        torch.from_numpy(blocks), searcher.code_ffts, torch.from_numpy(dops),
        mesh=shard.make_mesh(8, ("blk", "dop"), (2, 4), device="cpu"),
        lo_rate=SMALL.lo_rate, lags=SMALL.lags, dop_chunk=4)
    _same_acq(got, want)
    for b in range(4):
        one = searcher.acquire_bits(blocks[b])
        np.testing.assert_array_equal(got.lo_shift[b].numpy(),
                                      one.lo_shift.numpy())
        np.testing.assert_array_equal(got.ca_shift[b].numpy(),
                                      one.ca_shift.numpy())
    # the signal block detects PRN 17, the noise blocks nothing
    assert float(got.snr[0][16]) > 50
    assert float(got.snr[1].max()) < 25


def test_channel_sharded_tracking_matches_single():
    from tpu_gnss.track import channel as jtc
    fs = 2.048e6
    svs = [synth.SvSignal(prn=p, doppler_hz=300.0 * i - 1000.0,
                          code_phase_chips=100.0 * i)
           for i, p in enumerate([2, 5, 9, 12, 17, 21, 25, 30])]
    iq = synth.synth_baseband(svs, fs, 50 * 2048, noise_std=0.4, seed=31)
    state = jtc.init_state(8)
    for ch, sv in enumerate(svs):
        state = jtc.start_channel(state, ch, sv.doppler_hz,
                                  sv.code_phase_chips)
    tables = np.asarray(jtc.channel_code_tables([s.prn for s in svs], 8))
    gains = (jtc.second_order_gains(18.0), jtc.second_order_gains(2.0))
    want_st, want = jshard.track_epochs_sharded(
        jnp.asarray(iq), state, jnp.asarray(tables),
        mesh=jshard.make_mesh(8, axes=("blk",)), fs=fs,
        pll_gains=gains[0], dll_gains=gains[1])

    st0 = tc.state_from_numpy(jax.tree.map(np.asarray, state), "cpu")
    x = torch.from_numpy(iq.astype(np.complex64))
    got_st, got = shard.track_epochs_sharded(
        x, st0, torch.from_numpy(tables),
        mesh=shard.make_mesh(8, ("blk",), device="cpu"), fs=fs,
        pll_gains=gains[0], dll_gains=gains[1])
    np.testing.assert_allclose(got.ip.numpy(), np.asarray(want.ip),
                               rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(got_st.code_phase.numpy(),
                               np.asarray(want_st.code_phase),
                               rtol=0, atol=1e-3)
    one_st, one = tc.track_epochs(x, st0, torch.from_numpy(tables), fs=fs,
                                  pll_gains=gains[0], dll_gains=gains[1])
    np.testing.assert_allclose(got.ip.numpy(), one.ip.numpy(), rtol=1e-5,
                               atol=1e-2)
    np.testing.assert_allclose(got_st.code_phase.numpy(),
                               one_st.code_phase.numpy(), rtol=0, atol=1e-3)


def _folded_case():
    cfg = ReceiverConfig(fs=1.024e6, fc=0.256e6, max_fo=5000.0,
                         fft_len=4096)
    s = tf.FoldedSearcher(cfg, n_coherent=4, device="cpu")
    svs = [synth.SvSignal(prn=17, doppler_hz=1500.0, code_phase_chips=417.0)]
    rng = np.random.default_rng(4)
    iq0 = synth.synth_baseband(svs, cfg.fs, s.block_len, noise_std=0.8,
                               seed=4)
    noise = (rng.standard_normal(s.block_len)
             + 1j * rng.standard_normal(s.block_len)).astype(np.complex64)
    return cfg, s, iq0, np.stack([iq0, noise, iq0, noise])


def test_folded_mxu_sharded_matches_single():
    from tpu_gnss.acquire import folded as jf
    cfg, s, iq0, blocks = _folded_case()
    js = jf.FoldedSearcher(cfg, n_coherent=4, dop_chunk=2)
    dops = shard.pad_dops(s.dops_hz.numpy(), 4, 2)
    jcw = js.mxu_code_planes()
    want = jshard.acquire_folded_sharded(
        jnp.asarray(blocks), *jcw, jnp.asarray(dops),
        mesh=jshard.make_mesh(8, axes=("blk", "dop"), shape=(2, 4)),
        fs=cfg.fs, lo_rate=cfg.lo_rate, n_coherent=4, dop_chunk=2,
        period=js.period, nf=js.nf, from_bits=False, interpret=True)
    got = shard.acquire_folded_sharded(
        torch.from_numpy(blocks), *s.mxu_code_planes(),
        torch.from_numpy(dops),
        mesh=shard.make_mesh(8, ("blk", "dop"), (2, 4), device="cpu"),
        fs=cfg.fs, lo_rate=cfg.lo_rate, n_coherent=4, period=s.period,
        nf=s.nf, from_bits=False)
    # the port's single-device engine within the reference's 1e-4; the
    # JAX kernel is bf16, so against it the kernel bound of
    # tests/test_torch_folded_grid.py, 0.03
    one = s.acquire(iq=iq0, engine="mxu")
    for b in (0, 2):
        for ca, dop, snr, rtol in (
                (one.ca_shift[16], one.doppler_hz[16], one.snr[16], 1e-4),
                (want.ca_shift[b][16], want.doppler_hz[b][16],
                 want.snr[b][16], 0.03)):
            assert int(got.ca_shift[b][16]) == int(ca)
            assert float(got.doppler_hz[b][16]) == float(dop)
            np.testing.assert_allclose(float(got.snr[b][16]), float(snr),
                                       rtol=rtol)
    assert float(got.snr[1].max()) < 25


@pytest.mark.parametrize("n,shards,chunk", [(41, 4, 1), (41, 4, 16),
                                            (801, 4, 64), (21, 8, 2),
                                            (8, 8, 1)])
def test_pad_dops_matches_jax(n, shards, chunk):
    dops = (np.arange(n, dtype=np.float32) - n // 2) * 250.0
    got = shard.pad_dops(dops, shards, chunk)
    np.testing.assert_array_equal(got, jshard.pad_dops(dops, shards, chunk))
    assert len(got) % shards == 0 and got.dtype == dops.dtype


@pytest.mark.parametrize("k", [1, 3])
def test_refined_sharded_matches_jax_and_single(k):
    """The sharded cold search on 1, 3 and 4 shards gives the port's
    single-device stack exactly (the grid rows do not depend on the
    shard they run in), and the JAX sharded search's decisions."""
    from tpu_gnss.acquire import folded as jf
    cfg = ReceiverConfig(fs=1.024e6, fc=0.256e6, max_fo=5000.0, fft_len=4096)
    svs = [synth.SvSignal(prn=7, doppler_hz=1840.0, code_phase_chips=303.4),
           synth.SvSignal(prn=21, doppler_hz=-2460.0,
                          code_phase_chips=777.7, amplitude=0.8)]
    s = tf.FoldedSearcher(cfg, n_coherent=4, device="cpu")
    iq = synth.synth_baseband(svs, cfg.fs, k * s.block_len, noise_std=0.6,
                              seed=7 + k)
    kw = dict(fs=cfg.fs, lo_rate=cfg.lo_rate, n_coherent=4,
              n_noncoherent=k, period=s.period, nf=s.nf, from_bits=False)
    x = torch.from_numpy(iq)
    want = tf.acquire_refined_mxu(x, *s.mxu_code_planes(), s.code_ffts_p,
                                  s.dops_hz, **kw)
    for n in (1, 3, 4):
        dops = torch.from_numpy(shard.pad_dops(s.dops_hz.numpy(), n, 1))
        got = shard.acquire_refined_sharded(
            x, *s.mxu_code_planes(), s.code_ffts_p, dops,
            mesh=shard.make_mesh(n, device="cpu"), **kw)
        assert torch.equal(got, want), n
    js = jf.FoldedSearcher(cfg, n_coherent=4, dop_chunk=8)
    jd = js.detections_refined_sharded(
        iq=iq, n_noncoherent=k, mesh=jshard.make_mesh(4, axes=("dop",)))
    td = s.detections_refined_sharded(
        iq=iq, n_noncoherent=k, mesh=shard.make_mesh(4, device="cpu"))
    assert {d["prn"] for d in td} == {7, 21}
    assert [d["prn"] for d in td] == [d["prn"] for d in jd]
    p = cfg.fs / 1000
    for w, g in zip(jd, td):
        np.testing.assert_allclose(g["snr"], w["snr"], rtol=0.03)
        assert abs(g["doppler_hz"] - w["doppler_hz"]) < 1.0
        assert abs((g["ca_shift"] - w["ca_shift"] + p / 2) % p - p / 2) < 0.05
    assert td == s.detections_refined_fast(iq=iq, n_noncoherent=k)


RX_CFG = ReceiverConfig(fs=scene.FS, fc=scene.FS / 4, max_fo=5000.0,
                        fft_len=4096, snr_threshold=17.0)


def _locked(res):
    return {(r.ch, r.prn) for r in res.channels
            if pll_lock_metric(r.ip_hist, r.qp_hist, 1000) > 0.45}


def test_mesh_receiver_matches_single_and_jax():
    """``Receiver(mesh=2 CPU entries)`` on a 2 s, 4-SV scene: the port's
    ``acq_engine="mxu"`` receiver's and the JAX mesh receiver's
    detections (Doppler within one 250 Hz bin, code phase within one
    sample) and locked channels."""
    from tpu_gnss.receiver import Receiver as JaxReceiver
    iq, _, _ = scene.build_scene(duration=2.0, n_sv=4, seed=9)
    mesh = shard.make_mesh(2, device="cpu")
    recv = Receiver(RX_CFG, mesh=mesh, device="cpu")
    got = recv.process_iq(iq)
    single = Receiver(RX_CFG, acq_engine="mxu", device="cpu").process_iq(iq)
    jmesh = JaxReceiver(RX_CFG, mesh=jshard.make_mesh(2, axes=("dop",))
                        ).process_iq(iq)
    p = RX_CFG.fs / 1000
    assert len(got.detections) >= 4
    for want in (single, jmesh):
        g = {d["prn"]: d for d in got.detections}
        w = {d["prn"]: d for d in want.detections}
        assert set(g) == set(w)
        for prn in g:
            assert abs(g[prn]["doppler_hz"] - w[prn]["doppler_hz"]) < 250.0
            dca = (g[prn]["ca_shift"] - w[prn]["ca_shift"] + p / 2) % p - p / 2
            assert abs(dca) < 1.0
        assert len(_locked(got)) >= 4 and _locked(got) == _locked(want)


def test_mesh_engine_rule():
    """auto picks the sharded kernel search on a mesh where the kernel
    factors, else the grid engine; an explicit engine is kept."""
    mesh = shard.make_mesh(2, device="cpu")
    recv = Receiver(RX_CFG, mesh=mesh, device="cpu")
    assert recv._resolve_engine(recv.searcher) == "mxu_sharded"
    assert Receiver(RX_CFG, device="cpu")._resolve_engine(
        recv.searcher) == "mxu"
    for engine in ("mxu", "xla"):
        r = Receiver(RX_CFG, mesh=mesh, acq_engine=engine, device="cpu")
        assert r._resolve_engine(r.searcher) == engine

    class NoKernel:
        def mxu_supported(self):
            return False
    assert recv._resolve_engine(NoKernel()) == "xla"


def test_mesh_errors():
    """A mesh without a "dop" axis, one spanning other ranks, a device
    outside the mesh, too many cards, and a channel count that does not
    divide all raise ValueError."""
    cpu2 = shard.make_mesh(2, device="cpu")
    bad = [object(), shard.make_mesh(2, ("blk",), device="cpu"),
           shard.Mesh(["cpu", "cpu"], ("dop",), ranks=[0, 1]),
           shard.Mesh(["cuda:0", "cuda:0"], ("dop",))]
    for mesh in bad:
        with pytest.raises(ValueError):
            Receiver(RX_CFG, mesh=mesh, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="cards"):
            shard.make_mesh(2, device="cuda")
    with pytest.raises(ValueError, match="shape"):
        shard.make_mesh(8, ("blk", "dop"), device="cpu")
    iq, _, _ = scene.build_scene(duration=0.5, n_sv=2, seed=3)
    recv = Receiver(RX_CFG, mesh=shard.make_mesh(8, device="cpu"),
                    device="cpu")
    with pytest.raises(ValueError, match="max_channels"):
        recv.process_iq(iq, max_channels=12, chunk_s=0.5)
    with pytest.raises(ValueError, match="pad_dops"):
        shard.acquire_from_fft_sharded(
            torch.zeros(8, dtype=torch.complex64),
            torch.zeros(1, 8, dtype=torch.complex64),
            torch.arange(5), mesh=cpu2, lags=4)


@pytest.mark.slow
def test_distributed_receiver_full_chain_equality():
    """tests/test_dist.py:141-179 through the port: the 20 s scene on a
    4-shard mesh gives the single-device (``acq_engine="mxu"``) run's fix
    epochs and PRNs, fixes within 1 m of it, and an error under 8 m."""
    iq, _, rx = scene.build_scene(duration=20.0, n_sv=6)
    cfg = ReceiverConfig(fs=scene.FS, fc=scene.FS / 4, max_fo=5000.0,
                         fft_len=4096, snr_threshold=20.0)
    single = Receiver(cfg, acq_engine="mxu", device="cpu").process_iq(
        iq, max_channels=12)
    dist = Receiver(cfg, mesh=shard.make_mesh(4, device="cpu"),
                    device="cpu").process_iq(iq, max_channels=12)
    assert dist.solutions and single.solutions
    assert ([s.snap_epoch for s in dist.solutions]
            == [s.snap_epoch for s in single.solutions])
    assert (sorted(r.prn for r in dist.channels)
            == sorted(r.prn for r in single.channels))
    for a, b in zip(dist.solutions, single.solutions):
        d = np.linalg.norm([a.x - b.x, a.y - b.y, a.z - b.z])
        assert d < 1.0, f"sharded fix differs from single-device by {d:.2f} m"
    last = dist.solutions[-1]
    err = np.linalg.norm(np.array([last.x, last.y, last.z]) - np.array(rx))
    assert err < 8.0, f"distributed fix error {err:.1f} m"
