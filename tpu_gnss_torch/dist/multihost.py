"""Multi-process execution on ``torch.distributed``: bring-up, a
process-spanning mesh, per-process capture feeding and result gathering.

Counterpart of :mod:`tpu_gnss.dist.multihost`.  The sharded engines of
:mod:`tpu_gnss_torch.dist.shard` take a :class:`~tpu_gnss_torch.dist.shard.
Mesh` whose positions record their owning rank, so they serve several
processes unchanged; this module adds (1) the process group
(:func:`initialize`), (2) the process-major mesh over every rank's
devices (:func:`global_mesh`), (3) per-process feeding, where each rank
holds only its slice of the capture blocks (:func:`feed_local_blocks`),
and (4) the gathering of each rank's part of a result to every rank
(:func:`gather_to_hosts`).

Backends (:func:`default_backend`): ``"gloo"`` for CPU ranks and for
ranks that share a card (gloo's collectives take CPU tensors, so results
are staged through the host); ``"nccl"`` for one rank per card, and only
so: NCCL refuses two ranks on one card.  ``python -m
tpu_gnss_torch.dist.multihost`` is the worker of the N-process runs
(tests/test_torch_multihost.py, ``chip_smoke.py``); it runs on the card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import datetime
from typing import Optional, Sequence

import numpy as np
import torch

from .shard import (LocalShards, Mesh, _object_array, acquire_blocks_sharded,
                    acquire_folded_sharded, track_epochs_sharded)


def default_backend(device, num_processes: int) -> str:
    """``"nccl"`` where each of ``num_processes`` ranks on this machine
    has a card of its own (``device`` of type cuda), ``"gloo"`` otherwise:
    CPU ranks, or ranks that share a card."""
    if (torch.device(device).type == "cuda" and torch.cuda.is_available()
            and num_processes <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def initialize(coordinator: str, num_processes: int, process_id: int, *,
               backend: str, cpu_devices: Optional[int] = None,
               timeout_s: float = 600.0) -> list[torch.device]:
    """Join the process group at ``tcp://<coordinator>`` (``host:port``)
    as rank ``process_id`` of ``num_processes``.

    Returns this process's mesh entries: ``cpu_devices`` entries of the
    CPU when given (the reference's virtual CPU devices), else its card,
    ``cuda:<process_id mod cards>``, made current.  A collective that
    waits longer than ``timeout_s`` raises.
    """
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    if cpu_devices is not None:
        if backend == "nccl":
            raise ValueError("nccl runs on cards: pass cpu_devices=None")
        local = [torch.device("cpu")] * cpu_devices
    else:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("no CUDA card: pass cpu_devices for CPU ranks")
        if backend == "nccl" and num_processes > n:
            raise ValueError(f"nccl needs one card per rank: {num_processes} "
                             f"ranks, {n} cards (use gloo to share a card)")
        local = [torch.device("cuda", process_id % n)]
        torch.cuda.set_device(local[0])
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return local


def global_mesh(axes: Sequence[str], shape: Optional[Sequence[int]] = None,
                *, local_devices: Sequence) -> Mesh:
    """Mesh over every rank's devices, process-major
    (tpu_gnss/dist/multihost.py:63-78).

    Every rank passes its own ``local_devices`` (the same count on each);
    rank r's entries follow rank r-1's, so the first mesh axis groups
    whole processes when its extent is a multiple of the process count.
    """
    dist = torch.distributed
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, [str(d) for d in local_devices])
    if len({len(n) for n in names}) != 1:
        raise ValueError(f"ranks hold different device counts: {names}")
    devs = [d for n in names for d in n]
    ranks = [r for r, n in enumerate(names) for _ in n]
    if shape is None:
        if len(axes) != 1:
            raise ValueError("a mesh of several axes needs its shape")
        shape = (len(devs),)
    if int(np.prod(shape)) != len(devs):
        raise ValueError(f"mesh shape {tuple(shape)} does not hold "
                         f"{len(devs)} devices")
    return Mesh(_object_array(devs, tuple(shape)), axes,
                ranks=np.reshape(ranks, tuple(shape)))


def _first_local(mesh: Mesh) -> torch.device:
    return mesh.local_devices()[0]


def feed_local_blocks(blocks_local, mesh: Mesh, axis: str = "blk"
                      ) -> LocalShards:
    """Per-process capture feeding: this rank's contiguous slice of the
    global block batch, on its first mesh device, marked as its part of
    ``axis``; the mesh records which rank holds the rest
    (tpu_gnss/dist/multihost.py:81-93).  No rank touches another's
    samples."""
    x = (blocks_local if isinstance(blocks_local, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(blocks_local)))
    return LocalShards(x.to(_first_local(mesh)), axis)


def gather_to_hosts(tree, dim: int = 0):
    """Every rank's part of a result, concatenated in rank order along
    ``dim``, as numpy on every rank (tpu_gnss/dist/multihost.py:96-103;
    ``torch.distributed.all_gather``, staged through the host under
    gloo).  ``tree``: a tensor or a NamedTuple of tensors, the same
    shapes on every rank."""
    if isinstance(tree, tuple):
        return type(tree)(*(gather_to_hosts(t, dim) for t in tree))
    dist = torch.distributed
    flag = tree.dtype == torch.bool
    comm = torch.device("cpu") if dist.get_backend() == "gloo" else tree.device
    x = (tree.to(torch.uint8) if flag else tree).to(comm).contiguous()
    bufs = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(bufs, x)
    out = torch.cat(bufs, dim).cpu().numpy()
    return out.astype(bool) if flag else out


def _gather_split(res, mesh: Mesh, axis: str = "blk"):
    """A result split along mesh axis ``axis`` (each rank holds the
    pieces of the indices it owns, in mesh order, along dim 0), whole and
    in mesh order on every rank, as numpy.  Where several ranks own an
    index (an axis that does not span the processes), the first owner's
    piece is kept."""
    world = torch.distributed.get_world_size()
    ai = mesh.axis_names.index(axis)
    owned = [sorted({p[ai] for p in mesh.positions() if mesh.ranks[p] == r})
             for r in range(world)]
    if len({len(o) for o in owned}) != 1:
        raise ValueError(f"every rank must own as many indices of {axis!r}")
    g = gather_to_hosts(res)
    n_own = len(owned[0])
    per = g[0].shape[0] // (world * n_own)
    rows = []
    for i in range(mesh.shape[axis]):
        r = next(r for r in range(world) if i in owned[r])
        start = (r * n_own + owned[r].index(i)) * per
        rows.extend(range(start, start + per))
    return type(g)(*(f[rows] for f in g))


def acquire_blocks_multihost(bits_local, code_ffts: torch.Tensor, dops, *,
                             mesh: Mesh, lo_rate: float, lags: int,
                             dop_chunk: int = 16):
    """Multi-process block+Doppler sharded acquisition, results on every
    rank (tpu_gnss/dist/multihost.py:106-123).

    ``bits_local``: this rank's ``[B_local, fft_len]`` slice of the global
    block batch.  Returns numpy ``[B_global, n_sv]`` (snr, lo_shift,
    ca_shift), the same on every rank and the same as the single-process
    engine on the whole batch.
    """
    blocks = feed_local_blocks(bits_local, mesh, "blk")
    res = acquire_blocks_sharded(
        blocks, code_ffts, torch.as_tensor(np.asarray(dops)).to(_first_local(mesh)),
        mesh=mesh, lo_rate=lo_rate, lags=lags, dop_chunk=dop_chunk)
    g = _gather_split(res, mesh)
    return g.snr, g.lo_shift, g.ca_shift


def acquire_folded_multihost(blocks_local, cw_r, cw_i, dops_hz, *,
                             mesh: Mesh, fs: float, lo_rate: float,
                             n_coherent: int, period: int, nf: int):
    """Multi-process folded (``fold_corr_reduce``) acquisition of 1-bit
    blocks, results on every rank (tpu_gnss/dist/multihost.py:126-141):
    numpy (snr, doppler_hz, ca_shift) ``[B_global, n_sv]``.

    ``blocks_local``: the blocks of the "blk" indices this rank owns;
    where the "blk" axis does not span the processes (the "dop" axis
    does), every rank passes the same blocks."""
    blocks = feed_local_blocks(blocks_local, mesh, "blk")
    res = acquire_folded_sharded(
        blocks, cw_r, cw_i,
        torch.as_tensor(np.asarray(dops_hz)).to(_first_local(mesh)), mesh=mesh,
        fs=fs, lo_rate=lo_rate, n_coherent=n_coherent, period=period, nf=nf,
        from_bits=True)
    g = _gather_split(res, mesh)
    return g.snr, g.doppler_hz, g.ca_shift


def track_epochs_multihost(iq: np.ndarray, state_local, tables_local, *,
                           mesh: Mesh, axis: str = "chan", fs: float,
                           pll_gains, dll_gains):
    """Multi-process channel-sharded tracking, outputs on every rank
    (tpu_gnss/dist/multihost.py:144-174).

    Each rank feeds only its slice of the channel state
    (``state_local``: a ChannelState of numpy ``[n_chan_local]`` fields)
    and code tables; the 1 ms sample stream is replicated.  Returns
    (state, EpochOut) of numpy arrays over the whole bank.
    """
    from ..track.channel import state_from_numpy
    home = _first_local(mesh)
    st = state_from_numpy(state_local, home)
    x = torch.from_numpy(np.ascontiguousarray(iq, np.complex64)).to(home)
    tables = torch.from_numpy(np.ascontiguousarray(tables_local)).to(home)
    st2, out = track_epochs_sharded(x, st, tables, mesh=mesh, axis=axis,
                                    fs=fs, pll_gains=pll_gains,
                                    dll_gains=dll_gains)
    return gather_to_hosts(st2, 0), gather_to_hosts(out, 1)


# ----------------------------------------------------------------------
# the worker's seeded inputs, shared with the callers that check it
def worker_config(flagship: bool):
    """``(cfg, dop_chunk, n_epochs)`` of the worker: the reference
    gps_test's own geometry with ``flagship`` (fs 5.456 MHz, IF 4.092 MHz,
    40000-point window, bin fs/40000), else the tiny test geometry."""
    from ..config import ReceiverConfig
    if flagship:
        return (ReceiverConfig(fs=5.456e6, fc=4.092e6, max_fo=5000.0,
                               fft_len=40000), 8, 200)
    return (ReceiverConfig(fs=1.024e6, fc=0.256e6, max_fo=5000.0,
                           fft_len=2048), 2, 40)


def worker_blocks(cfg, n_blk: int) -> np.ndarray:
    """The global ``[n_blk, fft_len]`` batch of {0,1} blocks (seed 7)."""
    return np.random.default_rng(7).integers(0, 2, (n_blk, cfg.fft_len),
                                             dtype=np.uint8)


def worker_folded_blocks(cfg, n_blk: int, block_len: int) -> np.ndarray:
    """The global ``[n_blk, block_len]`` batch of 1-bit IF blocks of the
    folded search: PRN 9 at +1500 Hz in noise (seed 4)."""
    from ..signal import synth
    sv = synth.SvSignal(prn=9, doppler_hz=1500.0, code_phase_chips=300.0)
    iq = synth.synth_baseband([sv], cfg.fs, n_blk * block_len,
                              noise_std=1.0, seed=4)
    return synth.baseband_to_1bit_if(iq, cfg.fc, cfg.fs).reshape(
        n_blk, block_len)


def worker_bank(cfg, n_chan: int, n_epochs: int):
    """The tracking scene: ``(iq, state, code tables)``, a multi-SV
    baseband (seed 5) and a CPU ChannelState seeded on its SVs."""
    from ..signal import synth
    from ..track import channel as tc
    p_len = round(cfg.fs * 1e-3)
    svs = [synth.SvSignal(prn=1 + (3 * ch) % 32,
                          doppler_hz=500.0 * (ch % 5) - 1000.0,
                          code_phase_chips=61.0 * ch % 1023.0)
           for ch in range(n_chan)]
    iq = synth.synth_baseband(svs, cfg.fs, n_epochs * p_len, noise_std=0.3,
                              seed=5)
    state = tc.init_state(n_chan, "cpu")
    for ch, sv in enumerate(svs):
        state = tc.start_channel(state, ch, sv.doppler_hz,
                                 sv.code_phase_chips)
    return iq, state, tc.channel_code_tables([sv.prn for sv in svs], n_chan)


def worker_channels(n_total: int, flagship: bool) -> int:
    """The bank's channel count: a multiple of the shard count and of the
    process count, 8 at the test sizes, more when the shards outnumber
    them, at least 2 per shard at the flagship shapes."""
    n_chan = n_total * max(1, 8 // n_total)
    return max(n_chan, 2 * n_total) if flagship else n_chan


def _worker(argv=None) -> int:
    """Worker of the N-process runs (tpu_gnss/dist/multihost.py:178-293).

    Every process builds the same seeded global block batch, keeps its
    slice, runs the mesh engines and writes the gathered global results,
    so a caller can check that (a) every process agrees and (b) they equal
    the single-process engine.  Beyond the reference's keys it writes the
    folded (``fold_corr_reduce``) search of 1-bit blocks in two layouts,
    blocks across the processes (``fsnr``, ``fdop``, ``fca``) and the
    Doppler grid across them (``xsnr``, ``xdop``, ``xca``), and this
    process's kernel launches (``launches_<kernel>``).
    """
    import argparse
    import time
    p = argparse.ArgumentParser(prog="multihost_worker")
    p.add_argument("--coordinator", default="127.0.0.1:9955")
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--shards", "--cpu-devices", dest="shards", type=int,
                   default=2,
                   help="mesh entries per process (the reference's "
                        "--cpu-devices): CPU entries with --device cpu, "
                        "logical shards of the process's card with "
                        "--device cuda")
    p.add_argument("--out", required=True, help="npz path for results")
    p.add_argument("--blocks-per-dev", type=int, default=2,
                   help="capture blocks per process")
    p.add_argument("--bench-repeats", type=int, default=0,
                   help="also time the sharded engines (bench mode)")
    p.add_argument("--flagship", action="store_true",
                   help="run at the reference capture's real shapes "
                        "(Nottingham: fs=5.456e6, 40000-pt FFT, 136 Hz "
                        "Doppler bins, 73-bin grid) instead of the tiny "
                        "test config")
    p.add_argument("--device", choices=["cpu", "cuda"], default="cuda")
    p.add_argument("--backend", choices=["gloo", "nccl"], default=None,
                   help="default: nccl where every process has a card of "
                        "its own, else gloo")
    args = p.parse_args(argv)

    from .. import kernels
    from ..acquire.folded import FoldedSearcher
    from ..acquire.search import Searcher
    from ..track import channel as tc
    from .shard import pad_dops

    backend = args.backend or default_backend(args.device,
                                              args.num_processes)
    local = initialize(
        args.coordinator, args.num_processes, args.process_id,
        backend=backend,
        cpu_devices=args.shards if args.device == "cpu" else None)
    try:
        kernels.LAUNCHES.reset()
        if args.device == "cuda":
            local = local * args.shards         # shards of this rank's card
        n_total = args.num_processes * args.shards
        # blk axis spans processes (outer), dop axis inside each process
        mesh = global_mesh(("blk", "dop"), (args.num_processes, args.shards),
                           local_devices=local)
        cfg, dop_chunk, n_epochs = worker_config(args.flagship)
        searcher = Searcher(cfg, dop_chunk=dop_chunk, device=local[0])
        dops = pad_dops(np.arange(-cfg.dop_max_bin, cfg.dop_max_bin + 1,
                                  dtype=np.int32), args.shards, dop_chunk)
        per = args.blocks_per_dev
        mine = slice(args.process_id * per, (args.process_id + 1) * per)
        bits_local = worker_blocks(cfg, args.num_processes * per)[mine]
        acq = lambda: acquire_blocks_multihost(
            bits_local, searcher.code_ffts, dops, mesh=mesh,
            lo_rate=cfg.lo_rate, lags=cfg.lags, dop_chunk=dop_chunk)
        snr, lo_shift, ca_shift = acq()

        # the folded kernel engine: blocks across the processes (Doppler
        # inside each), then the Doppler grid across the processes (its
        # gather crosses ranks; every rank holds all the blocks)
        fsr = FoldedSearcher(cfg, device=local[0])
        f_all = worker_folded_blocks(cfg, args.num_processes * per,
                                     fsr.block_len)
        f_dops = pad_dops(fsr.dops_hz.cpu().numpy(), n_total, 1)
        mesh_x = global_mesh(("blk", "dop"), (1, n_total),
                             local_devices=local)
        fold = lambda blocks, m: acquire_folded_multihost(
            blocks, *fsr.mxu_code_planes(), f_dops, mesh=m, fs=cfg.fs,
            lo_rate=cfg.lo_rate, n_coherent=fsr.n_coherent,
            period=fsr.period, nf=fsr.nf)
        folded = fold(f_all[mine], mesh)
        folded_x = fold(f_all, mesh_x)

        walls = [np.nan, np.nan]
        if args.bench_repeats:
            for k, fn in enumerate((acq, lambda: fold(f_all[mine], mesh))):
                t0 = time.perf_counter()
                for _ in range(args.bench_repeats):
                    fn()
                walls[k] = (time.perf_counter() - t0) / args.bench_repeats

        # channel-sharded tracking across processes: every process builds
        # the same seeded scene, keeps its channels and gathers the bank
        n_chan = worker_channels(n_total, args.flagship)
        mesh_ch = global_mesh(("chan",), (n_total,), local_devices=local)
        iq_scene, state, tables = worker_bank(cfg, n_chan, n_epochs)
        per_ch = n_chan // args.num_processes
        lo_ch = args.process_id * per_ch
        state_local = tc.ChannelState(*(
            a[lo_ch: lo_ch + per_ch] for a in tc.state_to_numpy(state)))
        gains = (tc.second_order_gains(18.0), tc.second_order_gains(2.0))
        _, track_out = track_epochs_multihost(
            iq_scene, state_local, tables[lo_ch: lo_ch + per_ch],
            mesh=mesh_ch, fs=cfg.fs, pll_gains=gains[0],
            dll_gains=gains[1])

        np.savez(args.out, snr=snr, lo_shift=lo_shift, ca_shift=ca_shift,
                 wall=np.float64(walls[0]), fold_wall=np.float64(walls[1]),
                 n_devices=np.int64(n_total), backend=backend,
                 fsnr=folded[0], fdop=folded[1], fca=folded[2],
                 xsnr=folded_x[0], xdop=folded_x[1], xca=folded_x[2],
                 track_ip=track_out.ip, track_code_dev=track_out.code_dev,
                 **{f"launches_{k}": np.int64(kernels.LAUNCHES.get(k))
                    for k in kernels.KERNELS})
        print(f"[p{args.process_id}] wrote {args.out} snr_shape={snr.shape} "
              f"devices={n_total} ({backend} on "
              f"{[str(d) for d in local]})", flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_worker())
