"""Sharded acquisition and tracking over a mesh of devices.

Counterpart of :mod:`tpu_gnss.dist.shard` (tpu_gnss/dist/shard.py).  The
reference runs one program on several devices of a process through
``jax.sharding.Mesh`` and ``shard_map``; torch has neither, so the port
has two pieces:

* :class:`Mesh`: ``torch.device`` entries on named axes, and for each
  position the process rank that owns it.  Entries may repeat: N entries
  of the CPU stand in for the reference's N virtual CPU devices, and N
  entries of ``cuda:0`` run the shard code on one card.
* :func:`all_gather`: the results of every shard along one mesh axis, in
  mesh order; shards of this process come from memory, shards of other
  ranks through ``torch.distributed`` (the counterpart of
  ``jax.lax.all_gather`` inside ``shard_map``).

Every engine runs the body of each position this process owns, one
after another, on that position's device: an input split along a mesh
axis gives the position its piece, a replicated input is copied to its
device.  The engines serve :mod:`tpu_gnss_torch.dist.multihost` unchanged.
A result split along a mesh axis covers the axis indices this process
owns (in one process, all of them).

* **Doppler sharding** (latency): each shard searches a contiguous slice
  of the Doppler grid; the per-shard bests are stacked in mesh order and
  reduced by the first maximum, which on an ascending grid is the serial
  scan's tie-break.
* **Block sharding** (throughput): capture blocks split across shards.
* **Channel sharding**: the tracking bank split across shards.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..acquire.folded import (FoldedResult, _baseband, _corr_reduce_grid_mxu,
                              _refine_from_centers, acquire_folded_batch_mxu)
from ..acquire.search import (AcqResult, _first_argmax, acquire_from_fft,
                              mix_baseband)
from ..track.channel import ChannelState, EpochOut
from ..track.graph import GraphedTracker


def _rank() -> int:
    """This process's rank in the ``torch.distributed`` group (0 alone)."""
    dist = torch.distributed
    return (dist.get_rank()
            if dist.is_available() and dist.is_initialized() else 0)


def _object_array(items, shape) -> np.ndarray:
    out = np.empty(len(items), dtype=object)
    for i, x in enumerate(items):
        out[i] = x
    return out.reshape(shape)


class Mesh:
    """Devices on named axes, the counterpart of ``jax.sharding.Mesh``.

    ``devices``: an array-like of ``torch.device`` entries (or device
    strings), one dimension per name of ``axis_names``; entries may
    repeat.  ``ranks``: the process rank that owns each position, same
    shape (default: this process owns them all).  ``shape`` maps each
    axis name to its extent.
    """

    def __init__(self, devices, axis_names: Sequence[str], ranks=None):
        arr = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError(f"mesh devices have {arr.ndim} dimensions, "
                             f"axis names {self.axis_names}")
        self.devices = _object_array(
            [torch.device(d) for d in arr.reshape(-1)], arr.shape)
        self.shape = dict(zip(self.axis_names, arr.shape))
        self.rank = _rank()
        self.ranks = (np.full(arr.shape, self.rank, np.int64) if ranks is None
                      else np.asarray(ranks, np.int64).reshape(arr.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def positions(self) -> list[tuple]:
        """Every position, in mesh (row-major) order."""
        return list(np.ndindex(*self.devices.shape))

    def local_positions(self) -> list[tuple]:
        """The positions this process owns, in mesh order."""
        return [p for p in self.positions() if self.ranks[p] == self.rank]

    def local_devices(self) -> list[torch.device]:
        return [self.devices[p] for p in self.local_positions()]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.reshape(-1)]}, "
                f"ranks={self.ranks.reshape(-1).tolist()})")


def make_mesh(n_devices: Optional[int] = None,
              axes: Sequence[str] = ("dop",),
              shape: Optional[Sequence[int]] = None, *, device) -> Mesh:
    """A mesh of this process over ``n_devices`` devices of one type.

    ``device="cpu"``: ``n_devices`` entries of the CPU (default 1), the
    counterpart of the reference's virtual CPU devices.  ``device="cuda"``:
    cards ``cuda:0 .. n_devices-1`` (default all); asking for more cards
    than the machine has raises ``ValueError``, as the reference's assert
    does (tpu_gnss/dist/shard.py:31-39).  A mesh of several entries of one
    card is built with :class:`Mesh` directly.
    """
    kind = torch.device(device).type
    if kind == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = n_devices or have
        if not 1 <= n <= have:
            raise ValueError(f"a mesh of {n} cards was asked for; this "
                             f"machine has {have}")
        devs = [torch.device("cuda", i) for i in range(n)]
    elif kind == "cpu":
        devs = [torch.device("cpu")] * (n_devices or 1)
    else:
        raise ValueError(f"device type must be 'cpu' or 'cuda', got {kind!r}")
    if shape is None:
        if len(axes) != 1:
            raise ValueError("a mesh of several axes needs its shape")
        shape = (len(devs),)
    if int(np.prod(shape)) != len(devs):
        raise ValueError(f"mesh shape {tuple(shape)} does not hold "
                         f"{len(devs)} devices")
    return Mesh(_object_array(devs, tuple(shape)), axes)


# copied from tpu_gnss/dist/shard.py:42-51
def pad_dops(dops: np.ndarray, n_shards: int, dop_chunk: int) -> np.ndarray:
    """Pad the Doppler grid so each shard gets equal whole chunks.

    Padding replays the final bin; duplicates can never win the
    first-max-wins reduction over an ascending grid, so results are
    unchanged.
    """
    per = -(-len(dops) // (n_shards * dop_chunk)) * dop_chunk
    pad = per * n_shards - len(dops)
    return np.concatenate([dops, np.full(pad, dops[-1], dops.dtype)])


class LocalShards(NamedTuple):
    """This process's part of an array split along mesh axis ``axis``:
    the pieces of the axis indices it owns, in mesh order, concatenated
    along dim 0 (:func:`tpu_gnss_torch.dist.multihost.feed_local_blocks`).
    A plain tensor passed to an engine is the whole array instead."""
    data: torch.Tensor
    axis: str


def _owned(mesh: Mesh, axis: str) -> list[int]:
    ai = mesh.axis_names.index(axis)
    return sorted({p[ai] for p in mesh.local_positions()})


def _pieces(x, mesh: Mesh, axis: str) -> dict:
    """``{axis index: piece}`` for the indices of ``axis`` this process
    owns: equal pieces along dim 0 of the whole array, or of a
    :class:`LocalShards`."""
    own = _owned(mesh, axis)
    local = isinstance(x, LocalShards)
    if local and x.axis != axis:
        raise ValueError(f"input is split along {x.axis!r}, not {axis!r}")
    data = x.data if local else x
    n = len(own) if local else mesh.shape[axis]
    if data.shape[0] % n:
        raise ValueError(f"{data.shape[0]} rows do not split into {n} "
                         f"equal shards along mesh axis {axis!r}")
    chunks = torch.split(data, data.shape[0] // n)
    return dict(zip(own, chunks)) if local else {i: chunks[i] for i in own}


def _device_of(x) -> torch.device:
    return (x.data if isinstance(x, LocalShards) else x).device


def _exchange(mesh: Mesh, parts: dict) -> dict:
    """Every position's result, on every rank: one
    ``torch.distributed.all_gather`` per field of the rank-stacked parts
    (staged through the host under gloo, whose all_gather takes CPU
    tensors only).  Every rank of the group must call it."""
    dist = torch.distributed
    world = dist.get_world_size()
    owned = [[p for p in mesh.positions() if mesh.ranks[p] == r]
             for r in range(world)]
    if len({len(o) for o in owned}) != 1:
        raise ValueError("every rank must own the same number of mesh "
                         "positions")
    mine = owned[mesh.rank]
    n_fields = len(parts[mine[0]])
    out = {p: [] for p in mesh.positions()}
    for f in range(n_fields):
        x = torch.stack([parts[p][f] for p in mine])
        comm = (torch.device("cpu") if dist.get_backend() == "gloo"
                else x.device)
        send = x.to(comm).contiguous()
        bufs = [torch.empty_like(send) for _ in range(world)]
        dist.all_gather(bufs, send)
        for r in range(world):
            for k, p in enumerate(owned[r]):
                out[p].append(bufs[r][k])
    return {p: tuple(v) for p, v in out.items()}


def all_gather(mesh: Mesh, axis: str, parts: dict, device) -> dict:
    """The results of every shard along ``axis``, in mesh order.

    ``parts`` maps each position this process owns to its shard's result,
    a tuple of tensors whose shapes are the same in every shard.  Returns,
    for each line of the mesh along ``axis`` that holds a position of
    this process (keyed by the position's other coordinates), the list of
    its shards' results in order along ``axis``, every tensor on
    ``device``.  The counterpart of ``jax.lax.all_gather`` inside
    ``shard_map``: results of this process come from memory; where a line
    crosses process boundaries, every rank calls ``torch.distributed``
    (a failed collective raises).
    """
    ai = mesh.axis_names.index(axis)
    if np.any(mesh.ranks.min(axis=ai) != mesh.ranks.max(axis=ai)):
        parts = _exchange(mesh, parts)
    lines = {}
    for pos in mesh.local_positions():
        key = pos[:ai] + pos[ai + 1:]
        if key not in lines:
            lines[key] = [
                tuple(t.to(device) for t in parts[key[:ai] + (i,) + key[ai:]])
                for i in range(mesh.devices.shape[ai])]
    return lines


def _best_of(shards: list, cls):
    """Per-shard bests stacked in mesh order, reduced by the first maximum
    of the first field (SNR) over the shard axis
    (tpu_gnss/dist/shard.py:73-79)."""
    fields = [torch.stack(f) for f in zip(*shards)]      # [n_shards, ...]
    idx = _first_argmax(fields[0].movedim(0, -1))[None]
    return cls(*(torch.gather(f, 0, idx)[0] for f in fields))


def _blockwise(mesh: Mesh, lines: dict, cls):
    """Reduce each line over "dop" and concatenate the lines along "blk"
    (the blocks this process holds, in mesh order)."""
    bi = [a for a in mesh.axis_names if a != "dop"].index("blk")
    keys = sorted(lines, key=lambda k: k[bi])
    best = [_best_of(lines[k], cls) for k in keys]
    return cls(*(torch.cat(f) for f in zip(*best)))


def acquire_from_fft_sharded(data_fft: torch.Tensor, code_ffts: torch.Tensor,
                             dops: torch.Tensor, *, mesh: Mesh, lags: int,
                             dop_chunk: int = 16) -> AcqResult:
    """Doppler-sharded grid search for one block
    (tpu_gnss/dist/shard.py:54-87).

    ``dops`` must divide evenly by ``mesh.shape["dop"]`` (use
    :func:`pad_dops`).  The spectra are replicated; each shard searches
    its Doppler slice with :func:`tpu_gnss_torch.acquire.search.
    acquire_from_fft`, and the per-shard bests are reduced in mesh order.
    ``[n_sv]`` fields on ``data_fft``'s device.
    """
    ndev = mesh.shape["dop"]
    if dops.shape[0] % ndev:
        raise ValueError(f"{dops.shape[0]} Doppler bins do not divide over "
                         f"{ndev} shards: pad them with pad_dops")
    di = mesh.axis_names.index("dop")
    dop_p = _pieces(dops, mesh, "dop")
    parts = {}
    for pos in mesh.local_positions():
        dev = mesh.devices[pos]
        parts[pos] = tuple(acquire_from_fft(
            data_fft.to(dev), code_ffts.to(dev), dop_p[pos[di]].to(dev),
            lags=lags, dop_chunk=dop_chunk))
    lines = all_gather(mesh, "dop", parts, data_fft.device)
    return _best_of(next(iter(lines.values())), AcqResult)


def acquire_blocks_sharded(bits_blocks, code_ffts: torch.Tensor,
                           dops: torch.Tensor, *, mesh: Mesh, lo_rate: float,
                           lags: int, dop_chunk: int = 16,
                           variant: str = "offline") -> AcqResult:
    """Block+Doppler sharded full front end for a batch of 1-bit blocks
    (tpu_gnss/dist/shard.py:271-308).

    ``bits_blocks``: ``[n_blk, fft_len]`` {0,1} samples, n_blk divisible by
    ``mesh.shape["blk"]``, or this process's :class:`LocalShards` of them.
    Each (blk, dop) shard mixes and FFTs its blocks (the LO restarting at
    each block) and searches its Doppler slice.  Returns per-block, per-SV
    bests ``[n_blk, n_sv]`` for the blocks this process holds.
    """
    if dops.shape[0] % mesh.shape["dop"]:
        raise ValueError("the Doppler bins must divide over the 'dop' "
                         "shards: pad them with pad_dops")
    bi, di = (mesh.axis_names.index(a) for a in ("blk", "dop"))
    blk_p = _pieces(bits_blocks, mesh, "blk")
    dop_p = _pieces(dops, mesh, "dop")
    parts = {}
    for pos in mesh.local_positions():
        dev = mesh.devices[pos]
        ffts = torch.fft.fft(mix_baseband(blk_p[pos[bi]].to(dev), lo_rate,
                                          variant), dim=-1)
        cf, dl = code_ffts.to(dev), dop_p[pos[di]].to(dev)
        res = [acquire_from_fft(f, cf, dl, lags=lags, dop_chunk=dop_chunk)
               for f in ffts]
        parts[pos] = tuple(torch.stack(f) for f in zip(*res))
    lines = all_gather(mesh, "dop", parts, _device_of(bits_blocks))
    return _blockwise(mesh, lines, AcqResult)


def acquire_folded_sharded(blocks, cw_r: torch.Tensor, cw_i: torch.Tensor,
                           dops_hz: torch.Tensor, *, mesh: Mesh, fs: float,
                           lo_rate: float, n_coherent: int, period: int,
                           nf: int, from_bits: bool = True) -> FoldedResult:
    """Block+Doppler sharded folded acquisition through the fused kernel
    (tpu_gnss/dist/shard.py:90-131).

    Each (blk, dop) shard runs :func:`tpu_gnss_torch.acquire.folded.
    acquire_folded_batch_mxu` (``fold_corr_reduce`` on a card) over its
    blocks and Doppler slice; the per-shard bests are reduced in mesh
    order.  ``dops_hz`` must divide by ``mesh.shape["dop"]``
    (:func:`pad_dops`), ``blocks`` by ``mesh.shape["blk"]`` (or be this
    process's :class:`LocalShards`).  ``[B, n_sv]`` fields for the blocks
    this process holds.
    """
    if dops_hz.shape[0] % mesh.shape["dop"]:
        raise ValueError("the Doppler bins must divide over the 'dop' "
                         "shards: pad them with pad_dops")
    bi, di = (mesh.axis_names.index(a) for a in ("blk", "dop"))
    blk_p = _pieces(blocks, mesh, "blk")
    dop_p = _pieces(dops_hz, mesh, "dop")
    parts = {}
    for pos in mesh.local_positions():
        dev = mesh.devices[pos]
        parts[pos] = tuple(acquire_folded_batch_mxu(
            blk_p[pos[bi]].to(dev), cw_r.to(dev), cw_i.to(dev),
            dop_p[pos[di]].to(dev), fs=fs, lo_rate=lo_rate,
            n_coherent=n_coherent, from_bits=from_bits, period=period,
            nf=nf))
    lines = all_gather(mesh, "dop", parts, _device_of(blocks))
    return _blockwise(mesh, lines, FoldedResult)


def acquire_refined_sharded(samples: torch.Tensor, cw_r: torch.Tensor,
                            cw_i: torch.Tensor, code_ffts_p: torch.Tensor,
                            dops_pad: torch.Tensor, *, mesh: Mesh, fs: float,
                            lo_rate: float, n_coherent: int,
                            n_noncoherent: int = 1, period: int, nf: int,
                            from_bits: bool = True) -> torch.Tensor:
    """Doppler-sharded cold search: kernel grid + refine
    (tpu_gnss/dist/shard.py:215-268).

    The mesh version of :func:`tpu_gnss_torch.acquire.folded.
    acquire_refined_mxu`: the capture head is mixed once on ``samples``'
    device, each shard reduces its contiguous Doppler slice through
    ``fold_corr_reduce`` (one launch per shard), the per-bin SNR rows are
    gathered in ascending-Doppler order, and the ±2-bin refinement
    (``_refine_from_centers``, the single-device arithmetic) runs once on
    ``samples``' device.  Returns the stacked ``[3, n_sv]`` (snr,
    doppler_hz, ca_shift) there.

    ``dops_pad`` must divide by ``mesh.shape["dop"]`` (use
    :func:`pad_dops`); padding replays the last bin and cannot win the
    first-max argmax.
    """
    ndev = mesh.shape["dop"]
    if dops_pad.shape[0] % ndev:
        raise ValueError(f"{dops_pad.shape[0]} Doppler bins do not divide "
                         f"over {ndev} shards: pad them with pad_dops")
    iq = _baseband(samples, lo_rate, from_bits)
    block = n_coherent * period
    blocks = iq[: n_noncoherent * block].reshape(n_noncoherent, block)
    di = mesh.axis_names.index("dop")
    dop_p = _pieces(dops_pad, mesh, "dop")
    parts = {}
    for pos in mesh.local_positions():
        dev = mesh.devices[pos]
        pk, _, tt = _corr_reduce_grid_mxu(
            blocks.to(dev), cw_r.to(dev), cw_i.to(dev),
            dop_p[pos[di]].to(dev), fs=fs, n_coherent=n_coherent,
            period=period, nf=nf, accumulate=True)
        parts[pos] = (pk / (tt / period),)                # [sv, nd_local]
    line = next(iter(all_gather(mesh, "dop", parts, samples.device).values()))
    snr_grid = torch.cat([s for (s,) in line], dim=1)     # [sv, n_dop]
    # the argmax of acquire_refined_mxu, on the same ascending grid
    centers = dops_pad[snr_grid.argmax(dim=-1)]
    return _refine_from_centers(blocks, code_ffts_p, centers, dops_pad,
                                fs=fs, n_coherent=n_coherent, period=period,
                                nf=nf)


def make_tracker_sharded(*, mesh: Mesh, axis: str = "blk", fs: float,
                         pll_gains, dll_gains, epochs_per_step: int = 1,
                         agc_thresholds=None):
    """A reusable channel-sharded tracking step
    (tpu_gnss/dist/shard.py:134-191).

    Returns ``fn(samples, state, code_tables, code_ffts=None,
    aid_offset_hz=0.0) -> (state, EpochOut)``.  The ``ChannelState``
    fields (``[n_chan]``) and the code tables or spectra (whichever is
    given; the other is None) split along the channel axis over the
    indices of mesh axis ``axis`` this process owns; each shard runs its
    own :class:`tpu_gnss_torch.track.graph.GraphedTracker` (``track_epochs``
    as one CUDA graph per chunk shape on a card) on its slice, on its
    device, with the chunk ``samples`` replicated there.  ``EpochOut``
    comes back concatenated along dim 1 and the state along dim 0, on the
    state's device.  Where the mesh has other axes, one position per
    index of ``axis`` runs the body (the others would repeat it).  The
    reference's trace cache and ``have_code_ffts`` flag have no
    counterpart: nothing is traced, and the correlator follows from which
    of ``code_tables`` / ``code_ffts`` is given.
    """
    ai = mesh.axis_names.index(axis)
    own = _owned(mesh, axis)
    shard_dev = {}
    for pos in mesh.local_positions():
        shard_dev.setdefault(pos[ai], mesh.devices[pos])
    # one tracker per shard, never shared: two shards of one shape on one
    # card would otherwise overwrite each other's graph outputs
    trackers = {i: GraphedTracker(
        fs=fs, pll_gains=pll_gains, dll_gains=dll_gains,
        epochs_per_step=epochs_per_step, agc_thresholds=agc_thresholds,
        device=shard_dev[i]) for i in own}

    def run(samples, state: ChannelState, code_tables=None, code_ffts=None,
            aid_offset_hz: float = 0.0):
        n_chan = state.active.shape[0]
        if n_chan % len(own):
            raise ValueError(f"{n_chan} channels do not divide over the "
                             f"{len(own)} shards of mesh axis {axis!r}")
        k = n_chan // len(own)
        home = state.active.device
        states, outs = [], []
        for j, i in enumerate(own):
            dev = shard_dev[i]
            sl = slice(j * k, (j + 1) * k)
            cut = lambda t: None if t is None else t[sl].to(dev)
            st, out = trackers[i](
                samples.to(dev), ChannelState(*(t[sl].to(dev) for t in state)),
                cut(code_tables), cut(code_ffts), aid_offset_hz)
            states.append(st)
            outs.append(out)
        cat = lambda parts, dim: torch.cat([t.to(home) for t in parts], dim)
        return (ChannelState(*(cat(f, 0) for f in zip(*states))),
                EpochOut(*(cat(f, 1) for f in zip(*outs))))

    return run


def track_epochs_sharded(samples: torch.Tensor, state: ChannelState,
                         code_tables: torch.Tensor, *, mesh: Mesh,
                         axis: str = "blk", fs: float, pll_gains, dll_gains):
    """Channel-sharded tracking with the gather correlator, one call
    (tpu_gnss/dist/shard.py:194-212): the channel count must divide by
    the shards of ``axis``.  Streaming callers build
    :func:`make_tracker_sharded` once instead."""
    run = make_tracker_sharded(mesh=mesh, axis=axis, fs=fs,
                               pll_gains=pll_gains, dll_gains=dll_gains)
    return run(samples, state, code_tables)
