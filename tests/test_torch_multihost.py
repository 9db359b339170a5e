"""The port's multi-process runs: N processes on ``torch.distributed``.

Counterpart of tests/test_multihost.py.  Each test spawns N processes of
``python -m tpu_gnss_torch.dist.multihost --device cpu`` (gloo, the
backend it picks for CPU ranks; CPU mesh entries, a free port, one torch
thread each, its own time limit; every worker is killed as soon as one
fails), joined into one process-major mesh.  Every process must write
the same gathered results, and they must equal the port's single-process
engines and the JAX package's: acquisition SNR rtol 1e-5 with equal
Doppler bins and lags, tracking prompt I rtol 1e-4 / atol 1e-2 x the
period (the reference's bars); the folded kernel engine, in both of the
worker's layouts, SNR rtol 1e-4 with equal bins and lags.
"""

import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gnss_torch.acquire import folded as tf
from tpu_gnss_torch.acquire import search as ts
from tpu_gnss_torch.dist import multihost as mh
from tpu_gnss_torch.signal import synth
from tpu_gnss_torch.track import channel as tc
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = mh.worker_config(flagship=False)[0]
FLAGSHIP = mh.worker_config(flagship=True)[0]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(tmp_path, n_proc, argv, timeout):
    """Run ``argv(pid, coordinator, out)`` in ``n_proc`` processes; return
    their npz paths.  A worker that fails, or the time limit, kills them
    all (the others would wait in a collective)."""
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs, outs, logs = [], [], []
    for pid in range(n_proc):
        outs.append(str(tmp_path / f"mh_{pid}.npz"))
        logs.append(open(tmp_path / f"mh_{pid}.log", "w+"))
        procs.append(subprocess.Popen(
            [sys.executable] + argv(pid, coord, outs[-1]), cwd=REPO,
            env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = any(p.poll() not in (None, 0) for p in procs)
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for p, log in zip(procs, logs):
        log.seek(0)
        text = log.read()
        log.close()
        assert p.returncode == 0, f"worker failed:\n{text[-3000:]}"
    return [dict(np.load(o)) for o in outs]


def _workers(tmp_path, n_proc, cpu_devices=2, blocks_per_dev=2,
             timeout=420.0, flagship=False):
    return _spawn(tmp_path, n_proc, lambda pid, coord, out: [
        "-m", "tpu_gnss_torch.dist.multihost", "--coordinator", coord,
        "--num-processes", str(n_proc), "--process-id", str(pid),
        "--cpu-devices", str(cpu_devices), "--blocks-per-dev",
        str(blocks_per_dev), "--out", out, "--device", "cpu"]
        + (["--flagship"] if flagship else []), timeout)


def _all_agree(results, keys):
    for k in keys:
        for r in results[1:]:
            np.testing.assert_array_equal(results[0][k], r[k])


def _check_acquisition(res, cfg, dop_chunk, n_blk):
    """The gathered blocks against both packages' single-process
    searcher (the worker's seeded batch)."""
    from tpu_gnss.acquire.search import Searcher as JaxSearcher
    bits_all = mh.worker_blocks(cfg, n_blk)
    port = ts.Searcher(cfg, dop_chunk=dop_chunk, device="cpu")
    jax_s = JaxSearcher(cfg, dop_chunk=dop_chunk)
    assert res["snr"].shape == (n_blk, len(cfg.prns))
    for b in range(n_blk):
        for want in (port.acquire_bits(bits_all[b]),
                     jax_s.acquire_bits(bits_all[b])):
            np.testing.assert_allclose(res["snr"][b], np.asarray(want.snr),
                                       rtol=1e-5)
            np.testing.assert_array_equal(res["lo_shift"][b],
                                          np.asarray(want.lo_shift))
            np.testing.assert_array_equal(res["ca_shift"][b],
                                          np.asarray(want.ca_shift))


def _check_folded(res, cfg, n_blk):
    """The folded search, blocks across the processes (``f*``) and the
    Doppler grid across them (``x*``), against the single-process
    ``acquire_folded_batch_mxu`` on the whole batch."""
    s = tf.FoldedSearcher(cfg, device="cpu")
    blocks = mh.worker_folded_blocks(cfg, n_blk, s.block_len)
    one = tf.acquire_folded_batch_mxu(
        torch.from_numpy(blocks), *s.mxu_code_planes(), s.dops_hz,
        fs=cfg.fs, lo_rate=cfg.lo_rate, n_coherent=s.n_coherent,
        from_bits=True, period=s.period, nf=s.nf)
    for k in "fx":
        np.testing.assert_allclose(res[k + "snr"], one.snr.numpy(), rtol=1e-4)
        np.testing.assert_array_equal(res[k + "dop"], one.doppler_hz.numpy())
        np.testing.assert_array_equal(res[k + "ca"], one.ca_shift.numpy())
    assert (res["fsnr"][:, 8] > 25).all()       # PRN 9 found in every block


def _track_truth(cfg, n_chan, n_epochs):
    """The worker's seeded tracking scene, unsharded, through both
    packages' gather correlator: ``(port ip, JAX ip, period)``."""
    from tpu_gnss.track import channel as jtc
    iq, state, tables = mh.worker_bank(cfg, n_chan, n_epochs)
    gains = (tc.second_order_gains(18.0), tc.second_order_gains(2.0))
    _, out = tc.track_epochs(torch.from_numpy(iq.astype(np.complex64)),
                             state, torch.from_numpy(tables), fs=cfg.fs,
                             pll_gains=gains[0], dll_gains=gains[1])
    jstate = jax.tree.map(jnp.asarray, tc.state_to_numpy(state)._asdict())
    _, jout = jtc.track_epochs(iq, jtc.ChannelState(**jstate), tables,
                               fs=cfg.fs, pll_gains=gains[0],
                               dll_gains=gains[1])
    return out.ip.numpy(), np.asarray(jout.ip), round(cfg.fs * 1e-3)


def _check_tracking(ip, cfg, n_chan, n_epochs):
    port_ip, jax_ip, p_len = _track_truth(cfg, n_chan, n_epochs)
    assert ip.shape == port_ip.shape == (n_epochs, n_chan)
    for want in (port_ip, jax_ip):
        np.testing.assert_allclose(ip, want, rtol=1e-4, atol=1e-2 * p_len)
    # every cross-process channel locked on its SV
    lock = np.abs(ip[n_epochs // 2:]).mean(axis=0) / p_len
    assert np.all(lock > 0.25), f"multi-process channels not locked: {lock}"


def test_two_process_blocks_and_tracking(tmp_path):
    """2 gloo processes x 2 CPU shards at the tiny config: every process
    gathers the same blocks and tracking bank, equal to both packages'
    single-process engines."""
    results = _workers(tmp_path, n_proc=2)
    _all_agree(results, ("snr", "lo_shift", "ca_shift", "track_ip", "fsnr",
                         "fdop", "fca", "xsnr", "xdop", "xca"))
    assert int(results[0]["n_devices"]) == 4
    assert str(results[0]["backend"]) == "gloo"
    _check_acquisition(results[0], TINY, dop_chunk=2, n_blk=4)
    _check_folded(results[0], TINY, n_blk=4)
    _check_tracking(results[0]["track_ip"], TINY, n_chan=8, n_epochs=40)


@pytest.mark.parametrize("device,n_proc,cards,want", [
    ("cpu", 1, 0, "gloo"), ("cpu", 2, 2, "gloo"), ("cuda", 1, 1, "nccl"),
    ("cuda", 2, 2, "nccl"), ("cuda", 2, 1, "gloo"), ("cuda", 1, 0, "gloo")])
def test_default_backend(monkeypatch, device, n_proc, cards, want):
    """nccl exactly where every rank has a card of its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert mh.default_backend(device, n_proc) == want


def test_worker_runs_on_the_card_by_default(monkeypatch, tmp_path):
    """Without ``--device`` the worker asks for the card, and raises where
    there is none; it does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        mh._worker(["--num-processes", "1", "--process-id", "0",
                    "--out", str(tmp_path / "x.npz")])


_DOP_ACROSS = r"""
import sys
import numpy as np
import torch
from tpu_gnss_torch.acquire import folded
from tpu_gnss_torch.acquire import search as S
from tpu_gnss_torch.config import ReceiverConfig
from tpu_gnss_torch.dist import multihost, shard
from tpu_gnss_torch.signal import synth
pid, coord, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
local = multihost.initialize(coord, 2, pid, backend="gloo", cpu_devices=2)
mesh = multihost.global_mesh(("dop",), local_devices=local)
cfg = ReceiverConfig(fs=1.024e6, fc=0.256e6, max_fo=5000.0, fft_len=2048)
iq = synth.synth_baseband([synth.SvSignal(prn=9, doppler_hz=1500.0,
                                          code_phase_chips=300.0)],
                          cfg.fs, cfg.fft_len, noise_std=1.0, seed=3)
dops = shard.pad_dops(np.arange(-cfg.dop_max_bin, cfg.dop_max_bin + 1,
                                dtype=np.int32), 4, 2)
res = shard.acquire_from_fft_sharded(
    torch.fft.fft(torch.from_numpy(iq)),
    S.Searcher(cfg, dop_chunk=2, device="cpu").code_ffts,
    torch.from_numpy(dops), mesh=mesh, lags=cfg.lags, dop_chunk=2)
# the folded kernel engine with blocks split across the processes
fs_ = folded.FoldedSearcher(cfg, n_coherent=2, device="cpu")
blocks = synth.baseband_to_1bit_if(
    synth.synth_baseband([synth.SvSignal(prn=9, doppler_hz=1500.0,
                                         code_phase_chips=300.0)],
                         cfg.fs, 4 * fs_.block_len, noise_std=1.0, seed=4),
    cfg.fc, cfg.fs).reshape(4, fs_.block_len)
fsnr, fdop, fca = multihost.acquire_folded_multihost(
    blocks[2 * pid: 2 * pid + 2], *fs_.mxu_code_planes(),
    shard.pad_dops(fs_.dops_hz.numpy(), 2, 1),
    mesh=multihost.global_mesh(("blk", "dop"), (2, 2), local_devices=local),
    fs=cfg.fs, lo_rate=cfg.lo_rate, n_coherent=2, period=fs_.period,
    nf=fs_.nf)
np.savez(out, snr=res.snr.numpy(), lo_shift=res.lo_shift.numpy(),
         ca_shift=res.ca_shift.numpy(), ranks=mesh.ranks, fsnr=fsnr,
         fdop=fdop, fca=fca)
torch.distributed.destroy_process_group()
"""


def test_doppler_axis_across_processes(tmp_path):
    """A "dop" axis laid across 2 processes: the gather of the shards'
    bests crosses the process boundary (``shard.all_gather`` through
    gloo), and both processes reduce to the single-process search.  Then
    ``acquire_folded_multihost`` with the blocks split across the
    processes gives the single-process kernel engine's bests."""
    results = _spawn(tmp_path, 2, lambda pid, coord, out: [
        "-c", _DOP_ACROSS, str(pid), coord, out], timeout=300.0)
    _all_agree(results, ("snr", "lo_shift", "ca_shift"))
    assert results[0]["ranks"].tolist() == [0, 0, 1, 1]
    iq = synth.synth_baseband([synth.SvSignal(prn=9, doppler_hz=1500.0,
                                              code_phase_chips=300.0)],
                              TINY.fs, TINY.fft_len, noise_std=1.0, seed=3)
    want = ts.Searcher(TINY, dop_chunk=2, device="cpu").acquire_iq(iq)
    np.testing.assert_allclose(results[0]["snr"], want.snr.numpy(),
                               rtol=1e-5)
    np.testing.assert_array_equal(results[0]["lo_shift"],
                                  want.lo_shift.numpy())
    np.testing.assert_array_equal(results[0]["ca_shift"],
                                  want.ca_shift.numpy())
    assert results[0]["snr"][8] > 25     # PRN 9 found
    # folded blocks split across the processes: the single-process engine
    _all_agree(results, ("fsnr", "fdop", "fca"))
    s = tf.FoldedSearcher(TINY, n_coherent=2, device="cpu")
    blocks = synth.baseband_to_1bit_if(synth.synth_baseband(
        [synth.SvSignal(prn=9, doppler_hz=1500.0, code_phase_chips=300.0)],
        TINY.fs, 4 * s.block_len, noise_std=1.0, seed=4), TINY.fc, TINY.fs)
    one = tf.acquire_folded_batch_mxu(
        torch.from_numpy(blocks.reshape(4, s.block_len)),
        *s.mxu_code_planes(), s.dops_hz, fs=TINY.fs, lo_rate=TINY.lo_rate,
        n_coherent=2, from_bits=True, period=s.period, nf=s.nf)
    np.testing.assert_allclose(results[0]["fsnr"], one.snr.numpy(),
                               rtol=1e-4)
    np.testing.assert_array_equal(results[0]["fdop"], one.doppler_hz.numpy())
    np.testing.assert_array_equal(results[0]["fca"], one.ca_shift.numpy())
    assert (results[0]["fsnr"][:, 8] > 25).all()


_PEER_LOST = r"""
import sys
import torch
from tpu_gnss_torch.dist import multihost
pid, coord = int(sys.argv[1]), sys.argv[2]
local = multihost.initialize(coord, 2, pid, backend="gloo", cpu_devices=1,
                             timeout_s=30.0)
if pid == 1:
    sys.exit(3)                  # leaves before the first collective
multihost.global_mesh(("dop",), local_devices=local)
print("collective returned")
"""


def test_failed_collective_fails_the_run(tmp_path):
    """A rank that leaves before a collective makes the collective raise
    on the other rank within its time limit: the run fails, it neither
    hangs nor goes on with a partial mesh."""
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _PEER_LOST, str(pid),
                               coord], cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for pid in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert procs[1].returncode == 3
    assert procs[0].returncode != 0, outs[0]
    assert "collective returned" not in outs[0]


@pytest.mark.slow
def test_two_process_acquisition_matches_single(tmp_path):
    results = _workers(tmp_path, n_proc=2)
    _all_agree(results, ("snr", "lo_shift", "ca_shift"))
    assert int(results[0]["n_devices"]) == 4
    _check_acquisition(results[0], TINY, dop_chunk=2, n_blk=4)


@pytest.mark.slow
def test_two_process_tracking_matches_single(tmp_path):
    results = _workers(tmp_path, n_proc=2)
    _all_agree(results, ("track_ip",))
    _check_tracking(results[0]["track_ip"], TINY, n_chan=8, n_epochs=40)


@pytest.mark.slow
def test_four_process_acquisition_and_tracking(tmp_path):
    results = _workers(tmp_path, n_proc=4, blocks_per_dev=1, timeout=600.0)
    _all_agree(results, ("snr", "lo_shift", "ca_shift", "track_ip", "xsnr"))
    assert int(results[0]["n_devices"]) == 8
    _check_acquisition(results[0], TINY, dop_chunk=2, n_blk=4)
    _check_folded(results[0], TINY, n_blk=4)
    _check_tracking(results[0]["track_ip"], TINY, n_chan=8, n_epochs=40)


@pytest.mark.slow
def test_four_process_flagship_shapes(tmp_path):
    """4 processes at the reference capture's shapes: fs 5.456 MHz,
    40000-point windows, the 73-bin 136.4 Hz grid, and a 16-channel bank
    of 5456-sample epochs."""
    results = _workers(tmp_path, n_proc=4, blocks_per_dev=1, timeout=900.0,
                       flagship=True)
    _all_agree(results, ("snr", "lo_shift", "ca_shift", "track_ip"))
    assert int(results[0]["n_devices"]) == 8
    assert abs(FLAGSHIP.dop_bin_hz - 136.4) < 0.1
    _check_acquisition(results[0], FLAGSHIP, dop_chunk=8, n_blk=4)
    _check_folded(results[0], FLAGSHIP, n_blk=4)
    _check_tracking(results[0]["track_ip"], FLAGSHIP, n_chan=16,
                    n_epochs=200)
