"""The channel bank as one device program per chunk: a CUDA graph.

Counterpart of the reference's ``jax.jit`` of
:func:`tpu_gnss.track.channel.track_epochs` (tpu_gnss/track/channel.py:
188-193), whose ``lax.scan`` runs a whole chunk of steps as one
dispatch.  :class:`GraphedTracker` captures the port's step loop
(:func:`tpu_gnss_torch.track.channel.track_packed`: ``track_corr`` and
``loop_update`` per step) into one ``torch.cuda.CUDAGraph`` per chunk
shape and replays it, so a chunk of ``n_steps`` 10 ms steps costs the
host one graph launch and a few copies instead of two launches a step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import kernels
from .channel import (ChannelState, EpochOut, aid_tensor, loop_opts,
                      pack_state, track_epochs, track_packed, unpack_state)


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

    A capture or replay that fails raises.  A partial tail chunk is a key
    of its own, so it runs eagerly.  On the CPU every call is
    ``track_epochs``.  Each tracker owns its buffers: two trackers never
    share outputs.
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
        code = code_tables if code_ffts is None else code_ffts
        key = (n_steps, o.e_sub, state.active.shape[0], o.period,
               code.shape[-1], "gather" if code_ffts is None else "fft")
        cap = self._graphs.get(key)
        if cap is None:
            if key not in self._seen:
                self._seen.add(key)
                return eager()
            cap = self._graphs[key] = self._capture(
                n_steps, state, code, code_ffts is not None)
        n = cap.samples.shape[0]
        cap.samples.copy_(samples[:n])
        pack_state(state, out=cap.state)
        cap.code.copy_(code)
        cap.aid_offset.fill_(float(aid_offset_hz))
        cap.graph.replay()
        for name, k in cap.launches.items():
            kernels.LAUNCHES.add(name, k)
        return (unpack_state(cap.state.clone()),
                EpochOut(*cap.outs.clone()))

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
