"""The channel bank as one device program per chunk: a CUDA graph.

Counterpart of the reference's ``jax.jit`` of
:func:`tpu_gnss.track.channel.track_epochs` (tpu_gnss/track/channel.py:
188-193), whose ``lax.scan`` runs a whole chunk of steps as one
dispatch.  :class:`GraphedTracker` captures the port's step loop
(:func:`tpu_gnss_torch.track.channel.track_packed`: ``track_corr`` and
``loop_update`` per step) into one ``torch.cuda.CUDAGraph`` per chunk
shape and replays it, so a chunk of ``n_steps`` 10 ms steps costs the
host one graph launch and a few copies instead of two launches a step.

:func:`shared_tracker` is the counterpart of the jit cache itself (and
of ``tpu_gnss.utils.progcache``'s per-process memo, tpu_gnss/utils/
progcache.py:48): one tracker, and so one set of graphs, per device and
option set in a process, shared by every receiver that asks for it.
"""

from __future__ import annotations

import collections
import threading
from typing import NamedTuple, Optional

import torch

from .. import cache, kernels
from ..device import resolve_device
from ..utils.metrics import METRICS
from .channel import (ChannelState, EpochOut, aid_tensor, init_state,
                      loop_opts, pack_state, track_epochs, track_packed,
                      unpack_state)


class _Captured(NamedTuple):
    """One captured chunk shape: the graph, its static inputs (the packed
    state is also its output) and outputs, and the kernel launches one
    replay runs."""
    graph: torch.cuda.CUDAGraph
    samples: torch.Tensor       # [n_steps * step_len] complex64
    state: torch.Tensor         # [12, n_chan] float32, updated in place
    code: torch.Tensor          # code spectra or code tables
    aid_offset: torch.Tensor    # [1] float32
    outs: torch.Tensor          # [7, n_steps * e_sub, n_chan] float32
    launches: dict


class GraphedTracker:
    """``track_epochs`` with its static options bound, one CUDA graph per
    chunk shape on a card.

    ``tracker(samples, state, code_tables=None, code_ffts=None,
    aid_offset_hz=0.0)`` returns what :func:`track_epochs` returns for
    the same arguments.  On a card the graphs are keyed on ``(n_steps,
    e_sub, n_chan, P, NF, correlator)``:

    * the first chunk of a key runs ``track_epochs`` eagerly, through the
      same kernels; that fills the cached device tables (an upload cannot
      be captured) and builds the kernel library;
    * the second captures the step loop on a side stream
      (``capture_error_mode="thread_local"``: the receiver's prefetch and
      re-acquisition threads go on launching meanwhile), then it and
      every later chunk copy the samples, state, code spectra or tables
      and ``aid_offset_hz`` into the graph's static inputs, replay, and
      return clones of the state and outputs, so that nothing the caller
      holds is overwritten by the next replay.  Each replay adds the
      launches the capture recorded to ``kernels.LAUNCHES``.

    :meth:`prewarm` runs a key's eager pass and capture ahead of its
    first chunk.  A capture or replay that fails raises.  A partial tail
    chunk is a key of its own, so it runs eagerly on first sight.  On the
    CPU every call is ``track_epochs``.

    One tracker may serve several receivers and threads
    (:func:`shared_tracker`).  A lock serialises each call on a card, from
    the copy into the static inputs to the clones it returns, and the
    returned tensors are clones: no two calls share outputs.  Each call
    runs on the caller's current stream; a call on another stream than
    the previous replay's first waits for that replay's clones.
    :meth:`counts` says how many chunks ran eagerly, were captured and
    replayed, and how many keys :meth:`prewarm` built.

    A captured key holds its static samples buffer (``n_steps x e_sub x
    P`` complex64: 16.4 MB for a 1 s chunk at 2.048 Msps, 80 MB at 10
    Msps), its state and code copies, and in the graph's private pool the
    step loop's intermediates and the ``[7, n_steps x e_sub, n_chan]``
    float32 outputs (336 KB for 1000 epochs x 12 channels), for the
    tracker's lifetime.
    """

    def __init__(self, *, fs: float, pll_gains, dll_gains,
                 fll_bn_hz: float = 3.0, corr_spacing: float = 0.5,
                 carrier_aiding: bool = True, epochs_per_step: int = 1,
                 agc_thresholds=None, device):
        self.device = torch.device(device)
        self._kw = dict(fs=fs, pll_gains=pll_gains, dll_gains=dll_gains,
                        fll_bn_hz=fll_bn_hz, corr_spacing=corr_spacing,
                        carrier_aiding=carrier_aiding,
                        epochs_per_step=epochs_per_step,
                        agc_thresholds=agc_thresholds)
        self._opts = loop_opts(**self._kw)
        self._seen: set = set()
        self._graphs: dict = {}
        self._lock = threading.Lock()
        self._last = None           # (stream, event) of the last replay
        self._counts = collections.Counter()

    def counts(self) -> dict:
        """``{"eager", "captures", "replays", "prewarms"}``: the chunks
        that calls ran eagerly, captured and replayed on a card, and the
        keys that :meth:`prewarm` captured (each after an eager pass of
        its own)."""
        with self._lock:
            return {k: self._counts[k]
                    for k in ("eager", "captures", "replays", "prewarms")}

    def _key(self, n_steps: int, n_chan: int, code_len: int,
             fft: bool) -> tuple:
        o = self._opts
        return (n_steps, o.e_sub, n_chan, o.period, code_len,
                "fft" if fft else "gather")

    def __call__(self, samples: torch.Tensor, state: ChannelState,
                 code_tables: Optional[torch.Tensor] = None,
                 code_ffts: Optional[torch.Tensor] = None,
                 aid_offset_hz: float = 0.0
                 ) -> tuple[ChannelState, EpochOut]:
        eager = lambda: track_epochs(
            samples, state, code_tables, code_ffts=code_ffts,
            aid_offset_hz=aid_offset_hz, **self._kw)
        dev = samples.device
        if dev.type == self.device.type == "cpu":
            return eager()
        if (dev.type != "cuda" or self.device.type != "cuda"
                or self.device.index not in (None, dev.index)):
            raise ValueError(f"GraphedTracker on {self.device} got samples "
                             f"on {dev}")
        if code_ffts is None and code_tables is None:
            raise ValueError("track_epochs needs code_ffts (FFT-dot "
                             "correlator) or code_tables (gather correlator)")
        o = self._opts
        n_steps = samples.shape[0] // (o.period * o.e_sub)
        fft = code_ffts is not None
        code = code_ffts if fft else code_tables
        key = self._key(n_steps, state.active.shape[0], code.shape[-1], fft)
        with self._lock:
            cap = self._graphs.get(key)
            if cap is None:
                if key not in self._seen:
                    self._seen.add(key)
                    self._counts["eager"] += 1
                    METRICS.add("track.graph_misses")
                    return eager()
                cap = self._graphs[key] = self._capture(n_steps, state,
                                                        code, fft)
                self._counts["captures"] += 1
                METRICS.add("track.graph_misses")
            stream = torch.cuda.current_stream(self.device)
            if self._last is not None and self._last[0] != stream:
                stream.wait_event(self._last[1])
            n = cap.samples.shape[0]
            cap.samples.copy_(samples[:n])
            pack_state(state, out=cap.state)
            cap.code.copy_(code)
            cap.aid_offset.fill_(float(aid_offset_hz))
            cap.graph.replay()
            for name, k in cap.launches.items():
                kernels.LAUNCHES.add(name, k)
            out = (unpack_state(cap.state.clone()),
                   EpochOut(*cap.outs.clone()))
            done = torch.cuda.Event()
            done.record(stream)
            self._last = (stream, done)
            self._counts["replays"] += 1
            return out

    def prewarm(self, n_steps: int, n_chan: int, code_len: int,
                fft: bool) -> bool:
        """Build the key of ``n_steps`` steps over ``n_chan`` channels and
        ``code_len`` code columns (the spectra's NF with ``fft``, else the
        1023-chip tables) before its first chunk: the eager pass on zero
        samples from ``init_state(n_chan)``, which fills the cached device
        tables, then the capture, so that the key's first chunk replays.
        Returns whether it captured: False on the CPU, where there is
        nothing to build, and for a key captured already.  A failure
        raises."""
        if self.device.type != "cuda":
            return False
        o, dev = self._opts, self.device
        key = self._key(n_steps, n_chan, code_len, fft)
        with self._lock:
            if key in self._graphs:
                return False
            samples = torch.zeros(n_steps * o.period * o.e_sub,
                                  dtype=torch.complex64, device=dev)
            code = torch.zeros(n_chan, code_len, device=dev,
                               dtype=torch.complex64 if fft
                               else torch.float32)
            state, _ = track_epochs(samples, init_state(n_chan, dev),
                                    None if fft else code,
                                    code_ffts=code if fft else None,
                                    **self._kw)
            self._seen.add(key)
            self._graphs[key] = self._capture(n_steps, state, code, fft)
            self._counts["prewarms"] += 1
            METRICS.add("track.graph_misses")
            return True

    def _capture(self, n_steps: int, state: ChannelState,
                 code: torch.Tensor, fft: bool) -> _Captured:
        """Record the step loop of one chunk shape on static buffers."""
        dev, o = self.device, self._opts
        samples = torch.zeros(n_steps * o.period * o.e_sub,
                              dtype=torch.complex64, device=dev)
        packed = pack_state(state).contiguous()
        code_s = torch.empty_like(code).copy_(code)
        aid = aid_tensor(0.0, dev)
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with kernels.recording() as tally, torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                outs = track_packed(samples, packed,
                                    None if fft else code_s,
                                    code_s if fft else None, aid, o)
            finally:
                graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        return _Captured(graph, samples, packed, code_s, aid, outs,
                         dict(tally))


_SHARED = cache.store()


def shared_tracker(*, device, fs: float, pll_gains, dll_gains,
                   fll_bn_hz: float = 3.0, corr_spacing: float = 0.5,
                   carrier_aiding: bool = True, epochs_per_step: int = 1,
                   agc_thresholds=None) -> GraphedTracker:
    """The process's :class:`GraphedTracker` for the resolved ``device``
    and these static options: the same tracker, with its graphs, for
    equal options, and another when any of them differs, as ``jax.jit``
    keys ``track_epochs`` on its static arguments (tpu_gnss/track/
    channel.py:188-193)."""
    dev = resolve_device(device)
    kw = dict(fs=float(fs), pll_gains=tuple(float(g) for g in pll_gains),
              dll_gains=tuple(float(g) for g in dll_gains),
              fll_bn_hz=fll_bn_hz, corr_spacing=corr_spacing,
              carrier_aiding=carrier_aiding,
              epochs_per_step=epochs_per_step,
              agc_thresholds=(None if agc_thresholds is None
                              else tuple(float(a) for a in agc_thresholds)))
    key = (str(dev), loop_opts(**kw), kw["fs"], kw["pll_gains"],
           kw["dll_gains"])
    return cache.once(_SHARED, key, lambda: GraphedTracker(**kw, device=dev))
