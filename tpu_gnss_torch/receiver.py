"""Streaming receiver: a capture in, position fixes out.

Counterpart of :mod:`tpu_gnss.receiver` on PyTorch.  The stages are
pipelined over one device:

  acquisition (device, fused kernel)  ->  channel allocation (host)
  tracking loop (device, 10 ms steps) ->  NAV bit/frame decode (host)
  ephemeris ingest                    ->  PVT solve every 4 s (host)

Chunk k's tracking is enqueued on the device BEFORE chunk k-1's
correlator outputs are fetched, so host decode and bookkeeping overlap
device compute (the reference SPI pipelining, c/spi.cpp:34-53).  Uploads
run in the prefetch thread, the blocking device-to-host copies in a
fetch thread, and re-acquisition searches in a worker thread; all device
work goes to the default stream.

What crosses to the device is the capture's smallest form
(:mod:`tpu_gnss_torch.utils.xfer`): 1-bit captures as their own packed
words, unpacked and mixed there by
:func:`tpu_gnss_torch.ops.onebit.mix_packed` (the CUDA kernel on a card;
a ragged final chunk is mixed from its bits by
:func:`tpu_gnss_torch.acquire.search.mix_baseband`); 8-bit I/Q captures as
their own bytes (``transfer_dtype`` "int8") or requantized to nibbles
("int4") or 2-bit codes ("int2"); complex arrays as int8 planes (the
default), nibbles, 2-bit codes or exact complex64 ("float32").  The
dequantization runs on the device.

Acquisition uses the fused-kernel engine of
:mod:`tpu_gnss_torch.acquire.folded` (``detections_refined_fast``) or,
with ``acq_engine="xla"`` or a transform length the kernel cannot factor,
the FFT grid engine.  Channel management, the power and probation
watchdogs, code-locked transmit time, Hatch smoothing, RAIM, the solve
cadence, the incremental NAV decode and the trimmed-history bookkeeping
are the reference's host code (numpy, float64).  With ``on_solution``
(live mode) NAV decode and PVT run in-stream at the solve cadence.  Warm
start takes a previous run's ephemerides (``warm_ephemerides``) and the
almanac-predicted PRNs (``search_prns``), which direct the cold search.

With ``mesh`` (a :class:`tpu_gnss_torch.dist.shard.Mesh` with a ``"dop"``
axis) the same loop runs its heavy stages on the mesh: cold and
re-acquisition Doppler-sharded through the fused kernel, the tracking
bank channel-sharded.  The link, the 1-bit mix, the channel state the
host edits and the fetches stay on ``device``.
"""

from __future__ import annotations

import bisect
import copy
import dataclasses
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from .acquire.folded import FoldedSearcher
from .acquire.search import mix_baseband
from .cli.nmea_out import sat_geometry
from .config import ReceiverConfig
from .constants import CHIP_RATE_HZ, CODE_LEN_CHIPS, CODES_PER_BIT, L1_HZ
from .device import full_precision_matmul, resolve_device
from .io import loaders
from .io.stream import ArraySource, Prefetcher
from .nav import almanac as nav_almanac
from .nav import bits as nav_bits
from .nav.ephemeris import Ephemeris, resolve_week
from .ops.onebit import mix_packed, words_to_tensor
from .pvt import solve as pvt
from .track import channel as tc
from .track.graph import GraphedTracker
from .track.quality import cn0_nwpr, pll_lock_metric
from .utils import xfer
from .utils.metrics import METRICS


_HIST_KEYS = ("ip", "qp", "cf", "caf", "chips")

#: link names of ``Receiver(transfer_dtype=)``, as the reference's
TRANSFER_DTYPES = ("int8", "int4", "int2", "float32")
ACQ_ENGINES = ("auto", "mxu", "xla")


# ChannelRecord and ReceiverResult: copied from tpu_gnss/receiver.py:55-257;
# append_hist keeps only the device-phase chip integral (the reference's
# command-integral fallback has no caller here)
@dataclasses.dataclass
class ChannelRecord:
    """Host-side per-channel bookkeeping (the CHANNEL struct analog).

    Histories are stored as per-chunk numpy arrays and concatenated
    lazily — O(total) work, no per-epoch python objects.  The unwrapped
    chip counter is integrated incrementally at append time (the fix for
    the old full-history cumsum per solve snapshot).
    """
    ch: int
    prn: int
    start_epoch: int
    code_phase0: float = 0.0      # chips at start_epoch
    bit_offset: Optional[int] = None
    bits: Optional[np.ndarray] = None
    eph: Ephemeris = dataclasses.field(default_factory=Ephemeris)
    subframes: list = dataclasses.field(default_factory=list)
    last_subframe_bit: Optional[int] = None   # bit index of last subframe
    last_tow: Optional[int] = None
    cn0_dbhz: Optional[float] = None
    code_lock: Optional[float] = None   # prompt/sides ratio, last chunk
    # (end_epoch, ratio) per drained chunk: the solver samples the
    # ratio at its snapshot epoch instead of gating an old snapshot on
    # the FINAL chunk's lock state (a channel that degraded late must
    # not retroactively veto earlier, healthy snapshots)
    code_lock_hist: list = dataclasses.field(default_factory=list)
    # hot-start TOW anchors from preamble+HOW pairs at the undecoded
    # stream tail (nav/bits.partial_anchors); rebuilt per decode pass
    partial_anchors: list = dataclasses.field(default_factory=list)
    lost: bool = False
    n_epochs: int = 0
    trim_epochs: int = 0          # epochs dropped from the history front
    _decoded_upto: int = 0        # absolute epoch the last NAV pass covered
    archived_subframes: list = dataclasses.field(default_factory=list)
    _chunks: dict = dataclasses.field(
        default_factory=lambda: {k: [] for k in _HIST_KEYS})
    _cat: dict = dataclasses.field(default_factory=dict)
    _chip_base: float = 0.0       # integrated chips before current chunk
    _cp_last: Optional[float] = None   # device code phase at last epoch
    _ref_pwr: Optional[float] = None   # watchdog reference power

    # ------------------------------------------------------------------
    def append_hist(self, ip: np.ndarray, qp: np.ndarray, cf: np.ndarray,
                    caf: np.ndarray, cp: np.ndarray) -> None:
        """Append one chunk of per-epoch correlator outputs.

        ``cf`` is the tracker's code-rate DEVIATION history (chips/s
        relative to CHIP_RATE_HZ, tpu_gnss_torch.track.channel.EpochOut).

        ``cp`` is the tracker's own per-epoch code PHASE (chips mod
        1023, EpochOut.code_phase).  The transmit-time chip integral is
        anchored to it: every 1 ms epoch advances exactly one code period
        plus the wrapped phase difference, so the count inherits the
        DLL's lock to the signal and per-epoch errors stay bounded at the
        float32 phase quantization (~6e-5 chips ≈ 2 cm) WITHOUT
        accumulating.  (A float64 integral of the commanded rates would
        drift by the device's accumulated float32 rounding, which the DLL
        absorbs by adjusting later commands.)
        """
        self._chunks["ip"].append(ip)
        self._chunks["qp"].append(qp)
        self._chunks["cf"].append(cf)
        self._chunks["caf"].append(caf)
        cp64 = np.asarray(cp, np.float64)
        wrap = lambda x: (x + 511.5) % CODE_LEN_CHIPS - 511.5
        if self._cp_last is None:
            # A[0] defined == code_phase0 (cp[0] is its mod-1023 image);
            # later epochs chain off the device phase
            d = wrap(np.diff(cp64))
            steps = np.concatenate([[0.0], CODE_LEN_CHIPS + d])
            chips = self.code_phase0 + np.cumsum(steps)
        else:
            d = wrap(np.diff(cp64, prepend=self._cp_last))
            chips = self._chip_base + np.cumsum(CODE_LEN_CHIPS + d)
        self._chip_base = float(chips[-1])
        self._cp_last = float(cp64[-1])
        self._chunks["chips"].append(chips)
        self.n_epochs += len(ip)
        self._cat.clear()

    def hist(self, key: str) -> np.ndarray:
        """Retained history (cached until the next append/trim).

        Index i holds epoch ``trim_epochs + i`` (channel-relative);
        use :meth:`abs_slice` for absolute-epoch windows.
        """
        got = self._cat.get(key)
        if got is None:
            parts = self._chunks[key]
            got = (np.concatenate(parts) if parts
                   else np.empty(0, np.float32))
            self._cat[key] = got
        return got

    def abs_slice(self, key: str, lo: int, hi: int) -> np.ndarray:
        """History window by ABSOLUTE channel epochs [lo, hi)."""
        t = self.trim_epochs
        return self.hist(key)[max(lo - t, 0): max(hi - t, 0)]

    def abs_at(self, key: str, e: int):
        """History value at absolute channel epoch ``e``."""
        return self.hist(key)[e - self.trim_epochs]

    def trim_to(self, keep_epochs: int) -> None:
        """Bound retained history to ~the last ``keep_epochs`` epochs.

        Whole leading chunks are dropped (no copies); the absolute
        epoch <-> array index mapping shifts by ``trim_epochs``.
        Transmit-time anchors survive trimming because a_edge is an
        ABSOLUTE chip count (period-grid bit sync) — anchors decoded
        from since-trimmed history are moved to ``archived_subframes``
        by the next NAV decode pass.
        """
        while self._chunks["ip"]:
            head = len(self._chunks["ip"][0])
            if self.n_epochs - (self.trim_epochs + head) < keep_epochs:
                break
            for k in _HIST_KEYS:
                self._chunks[k].pop(0)
            self.trim_epochs += head
            self._cat.clear()

    def tail(self, key: str, n: int) -> np.ndarray:
        """Last ``n`` epochs of one history without a full concat."""
        parts, have = [], 0
        for arr in reversed(self._chunks[key]):
            parts.append(arr)
            have += len(arr)
            if have >= n:
                break
        if not parts:
            return np.empty(0, np.float32)
        return np.concatenate(parts[::-1])[-n:]

    def code_lock_at(self, e_local: int) -> Optional[float]:
        """Code-lock ratio of the chunk containing channel epoch e_local.

        Returns None when no contemporaneous measurement exists (the
        snapshot predates the history or trails the last drained chunk
        by more than one chunk) — callers skip the gate then.
        """
        h = self.code_lock_hist
        if not h:
            return self.code_lock
        i = bisect.bisect_left(h, e_local, key=lambda t: t[0])
        if i < len(h):
            if i == 0 and len(h) > 1:
                # history head may have been trimmed: only trust the
                # first entry for epochs inside its own chunk
                span0 = h[1][0] - h[0][0]
                if e_local <= h[0][0] - span0:
                    return None
            return h[i][1]
        span = h[-1][0] - (h[-2][0] if len(h) > 1 else 0)
        return h[-1][1] if e_local - h[-1][0] <= max(span, 1) else None

    @property
    def ip_hist(self) -> np.ndarray:
        return self.hist("ip")

    @property
    def qp_hist(self) -> np.ndarray:
        return self.hist("qp")

    @property
    def code_freq_hist(self) -> np.ndarray:
        """Absolute code rate (chips/s); stored history is the deviation."""
        return self.hist("cf").astype(np.float64) + CHIP_RATE_HZ

    @property
    def carrier_freq_hist(self) -> np.ndarray:
        return self.hist("caf")


@dataclasses.dataclass
class ReceiverResult:
    detections: list
    channels: List[ChannelRecord]
    solutions: List[pvt.Solution]


class Receiver:
    """Full-chain receiver for complex-baseband, 8-bit I/Q or 1-bit captures.

    Takes every setting of :class:`tpu_gnss.receiver.Receiver`
    (tpu_gnss/receiver.py:263-389) with the same defaults; ``device`` says
    where the device stages run and is required.  ``transfer_dtype`` names
    the complex-capture link: "int8" (the default: int8 planes at a
    per-chunk 6-sigma scale, or an 8-bit capture's own bytes), "int4"
    (packed nibbles), "int2" (2-bit sign/magnitude codes) or "float32"
    (exact samples).  An unknown link or ``acq_engine`` raises
    ``ValueError``.  ``mesh``: a :class:`tpu_gnss_torch.dist.shard.Mesh`
    of this process with a ``"dop"`` axis, one of whose entries is
    ``device`` (tpu_gnss/receiver.py:382-401); anything else raises
    ``ValueError``, and so does a channel count that does not divide by
    ``mesh.shape["dop"]``.
    """

    def __init__(self, cfg: ReceiverConfig, pll_bn_hz: float = 18.0,
                 dll_bn_hz: float = 2.0, n_coherent: int = 4,
                 solve_interval_s: float = 4.0,
                 los_power_ratio: float = 0.05,
                 los_timeout_s: float = 2.0,
                 epochs_per_step: int = 10,
                 reacq_interval_s: float = 5.0,
                 fft_correlator: bool = True,
                 agc_thresholds: Optional[tuple] = None,
                 acq_engine: str = "auto",
                 weak_min_svs: int = 4,
                 weak_noncoherent: int = 8,
                 transfer_dtype: str = "int8",
                 quality_gate: bool = True,
                 cn0_gate_dbhz: float = 25.0,
                 lock_gate: float = 0.45,
                 raim_residual_m: float = 500.0,
                 max_history_s: Optional[float] = None,
                 probation_s: float = 30.0,
                 code_lock_gate: float = 1.3,
                 if_offset_hz="auto",
                 mesh=None, *, device):
        if transfer_dtype not in TRANSFER_DTYPES:
            raise ValueError(f"transfer_dtype must be one of "
                             f"{TRANSFER_DTYPES}, got {transfer_dtype!r}")
        if acq_engine not in ACQ_ENGINES:
            raise ValueError(f"acq_engine must be one of {ACQ_ENGINES}, "
                             f"got {acq_engine!r}")
        full_precision_matmul()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.searcher = FoldedSearcher(cfg, n_coherent=n_coherent,
                                       device=self.device)
        self._n_coherent = n_coherent
        # directed cold search (almanac warm start): a FoldedSearcher over
        # the predicted-visible PRN subset; falls back to the full sweep
        # when the directed set under-delivers (stale almanac)
        self._searcher_directed = None
        # almanac store: subframe 4/5 pages and reductions of every
        # validated ephemeris (tpu_gnss/receiver.py:292-298)
        self.almanac = {}
        t_s = epochs_per_step * 1e-3
        self.pll_gains = tc.second_order_gains(pll_bn_hz, t_s=t_s)
        self.dll_gains = tc.second_order_gains(dll_bn_hz, t_s=t_s)
        self.epochs_per_step = epochs_per_step
        self.solve_interval_s = solve_interval_s
        self.los_power_ratio = los_power_ratio
        self.los_timeout_s = los_timeout_s
        self.reacq_interval_s = reacq_interval_s
        # False: the reference-style gather correlator (code tables, no
        # spectra) in place of the FFT-dot taps of track_corr
        self.fft_correlator = fft_correlator
        # strong-signal Costas gain reduction, (lo, hi) on the running
        # prompt power (reference: c/channel.cpp:265-288)
        self.agc_thresholds = (tuple(agc_thresholds)
                               if agc_thresholds is not None else None)
        self.acq_engine = acq_engine
        # weak-signal escalation: a single-block search finding fewer than
        # weak_min_svs SVs retries with weak_noncoherent blocks summed
        # non-coherently (tpu_gnss/receiver.py:317-331)
        self.weak_min_svs = weak_min_svs
        self.weak_noncoherent = weak_noncoherent
        self.transfer_dtype = transfer_dtype
        # solver inclusion gates and C/N0 weighting (the probation
        # analog, reference: c/channel.cpp:39,343,363)
        self.quality_gate = quality_gate
        self.cn0_gate_dbhz = cn0_gate_dbhz
        self.lock_gate = lock_gate
        self.raim_residual_m = raim_residual_m
        self._resid_hist = deque(maxlen=32)
        # live streams: per-channel history bounded to this many seconds
        # (None keeps everything)
        self.max_history_s = max_history_s
        # seconds of decoded stream with no parity-valid subframe before a
        # channel is declared a false acquisition (in-stream decode only)
        self.probation_s = probation_s
        self.code_lock_gate = code_lock_gate
        # replay-capture oscillator offset: "auto" estimates it from the
        # cold-start Doppler median when that exceeds 10 kHz, a float pins
        # it, 0 disables (tpu_gnss/receiver.py:371-381)
        self._if_offset = (0.0 if if_offset_hz == "auto"
                           else float(if_offset_hz))
        self._if_offset_locked = if_offset_hz != "auto"
        self._tables_cache = None
        # mesh mode: Doppler-sharded searches and a channel-sharded bank
        # over the mesh's "dop" axis, NAV and PVT on the host
        self.mesh = mesh
        if mesh is not None:
            if "dop" not in getattr(mesh, "axis_names", ()):
                raise ValueError("receiver mesh needs a 'dop' axis (used for "
                                 "both the Doppler grid and the channel bank)")
            if not any(d == self.device for d in mesh.devices.flat):
                raise ValueError(f"device {self.device} is not an entry of "
                                 f"the mesh {mesh}")
            if len(mesh.local_positions()) != mesh.size:
                raise ValueError("the receiver runs in one process: its mesh "
                                 "must not span other ranks")
            from .dist import shard as dshard
            self._tracker = dshard.make_tracker_sharded(
                mesh=mesh, axis="dop", fs=cfg.fs, pll_gains=self.pll_gains,
                dll_gains=self.dll_gains, epochs_per_step=epochs_per_step,
                agc_thresholds=self.agc_thresholds)
        else:
            # one CUDA graph per chunk shape on a card (the reference's
            # jitted track_epochs), track_epochs on the CPU
            self._tracker = GraphedTracker(
                fs=cfg.fs, pll_gains=self.pll_gains,
                dll_gains=self.dll_gains, epochs_per_step=epochs_per_step,
                agc_thresholds=self.agc_thresholds, device=self.device)

    # ------------------------------------------------------------------
    def _resolve_engine(self, searcher) -> str:
        """Concrete acquisition engine (tpu_gnss/receiver.py:404-419):
        "auto" runs the fused kernel engine wherever the transform length
        factors for it (the CUDA kernel on a card, its plain version on
        the CPU), Doppler-sharded on a mesh, else the FFT grid engine.  An
        explicit engine is kept in mesh mode (tracking stays sharded)."""
        if self.acq_engine != "auto":
            return self.acq_engine
        if not searcher.mxu_supported():
            return "xla"
        return "mxu_sharded" if self.mesh is not None else "mxu"

    def _cold_detections(self, head, bits: bool = False,
                         skip_prns=frozenset()) -> list:
        """Refined detections for channel seeding
        (tpu_gnss/receiver.py:458-532, without the compile prewarm).

        ``head`` is a complex-baseband segment, or {0,1} samples when
        ``bits``.  A single-block search that comes up short escalates to
        non-coherent accumulation.  ``skip_prns`` (already tracked) are
        dropped and counted as found by that check.

        A directed searcher (almanac warm start, ``search_prns``) sweeps
        only the predicted-visible subset; when even the weak-signal
        escalation leaves it short of ``weak_min_svs``, the full sweep
        runs once as a fallback and the directed searcher is dropped.  A
        sweep that seeds channels retires it too: its job is the cold
        start, and later re-acquisition must reach SVs that rise beyond
        the prediction.
        """
        searcher = self._searcher_directed or self.searcher
        engine = self._resolve_engine(searcher)
        kw = dict(bits=head) if bits else dict(iq=head)

        def run(n_nc, searcher):
            if engine == "mxu_sharded":
                return searcher.detections_refined_sharded(
                    **kw, n_noncoherent=n_nc, skip_prns=skip_prns,
                    mesh=self.mesh)
            if engine == "mxu":
                return searcher.detections_refined_fast(
                    **kw, n_noncoherent=n_nc, skip_prns=skip_prns)
            pwr = searcher.power_grid(**kw, n_noncoherent=n_nc)
            return [d for d in searcher.detections_refined(pwr, n_nc)
                    if d["prn"] not in skip_prns]

        def sweep(searcher):
            dets = run(1, searcher)
            k = min(self.weak_noncoherent, len(head) // searcher.block_len)
            if len(dets) + len(skip_prns) < self.weak_min_svs and k > 1:
                weak = run(k, searcher)
                if len(weak) > len(dets):
                    dets = weak
            return dets

        dets = sweep(searcher)
        if searcher is not self.searcher:
            if len(dets) + len(skip_prns) < self.weak_min_svs:
                self._searcher_directed = None
                full = sweep(self.searcher)
                if len(full) > len(dets):
                    dets = full
            elif dets:
                self._searcher_directed = None
        return dets

    # ------------------------------------------------------------------
    def process_iq(self, iq: np.ndarray, max_channels: Optional[int] = None,
                   chunk_s: float = 2.0) -> "ReceiverResult":
        """Run the full chain over a host complex-baseband capture."""
        return self.process_source(ArraySource(iq, self.cfg.fs),
                                   max_channels=max_channels,
                                   chunk_s=chunk_s)

    # ------------------------------------------------------------------
    def process_source(self, source, max_duration_s: Optional[float] = None,
                       max_channels: Optional[int] = None,
                       chunk_s: float = 1.0,
                       warm_ephemerides: Optional[dict] = None,
                       search_prns=None,
                       on_solution=None) -> "ReceiverResult":
        """Streaming full chain over a :mod:`tpu_gnss_torch.io.stream`
        source (bounded memory: only per-epoch correlator outputs are
        kept).

        ``warm_ephemerides``: {prn: Ephemeris} from a previous run's
        checkpoint.  A warm channel only needs one TLM/HOW pair or
        subframe (any id) for its TOW anchor instead of decoding all of
        1-3 — first fix in ~7 s of capture instead of ~20 s.  The dict is
        copied, never changed.

        ``search_prns``: restrict the cold search to this PRN subset
        (typically ``nav.almanac.visible_prns`` from a checkpoint's
        almanac and last fix).  Only a non-empty proper subset of
        ``cfg.prns`` directs the sweep; the receiver falls back to the
        full sweep if the directed set under-delivers.

        ``on_solution``: live-mode fix sink.  When given, NAV decode and
        PVT run in-stream at the solve cadence (the reference's 4 s
        SolveTask loop, c/solve.cpp:297-317) and each fix is delivered as
        it is computed; fixes of the end-of-stream pass follow.
        """
        cfg = self.cfg
        self._searcher_directed = None
        if search_prns is not None:
            subset = tuple(sorted(set(int(x) for x in search_prns)
                                  & set(cfg.prns)))
            if subset and subset != tuple(cfg.prns):
                self._searcher_directed = FoldedSearcher(
                    dataclasses.replace(cfg, prns=subset),
                    n_coherent=self._n_coherent, device=self.device)
        p = round(cfg.fs * 1e-3)
        eps = self.epochs_per_step
        if round(chunk_s * 1000) % eps:
            raise ValueError("chunk_s must cover whole tracking steps")
        chunk_len = max(1, round(chunk_s * 1000)) * p
        # 1-bit sources: the capture's own packed words cross to the
        # device; sources with the reference's per-block LO restart keep
        # their own host mixing
        onebit_src = not getattr(source, "per_block_phase", False)
        use_packed = (onebit_src and hasattr(source, "packed_blocks")
                      and chunk_len % 32 == 0)
        use_bits = (onebit_src and hasattr(source, "bit_blocks")
                    and not use_packed)
        # 8-bit I/Q sources: the capture's own interleaved bytes cross
        # (or their int4/int2 requantization); the conversion runs on the
        # device
        use_rawiq = (not use_packed and not use_bits
                     and hasattr(source, "raw_blocks")
                     and getattr(source, "dtype", None) in ("int8", "uint8"))
        mode = ("packed" if use_packed else "bits" if use_bits
                else "rawiq" if use_rawiq else "iq")
        n_samples = ((lambda b: 32 * len(b)) if use_packed
                     else (lambda b: len(b) // 2) if use_rawiq else len)
        # running upload sample index (prefetch thread).  A follow
        # source's skip-ahead advances it by the skipped samples, so the
        # 1-bit LO mix phase stays that of the true file sample index
        # (tpu_gnss/receiver.py:621-643)
        xfer_state = {"sample0": 0, "skipped_bytes": 0}
        skip_reader = (getattr(source, "reader", None)
                       if (use_packed or use_bits) else None)
        if use_rawiq:
            raw_link = {"int2": xfer.to_device_iq2,
                        "int4": xfer.to_device_iq4}.get(
                            self.transfer_dtype, xfer.to_device_iq8)
            signed = source.dtype == "int8"
            remove_dc = getattr(source, "remove_dc", True)

        def upload(blk):
            n_samp = n_samples(blk)
            n_ep = (n_samp // p // eps) * eps
            if n_ep == 0:
                return (blk, None, 0, n_samp)
            if skip_reader is not None:
                sk = skip_reader.skipped_bytes
                if sk > xfer_state["skipped_bytes"]:
                    xfer_state["sample0"] += \
                        8 * (sk - xfer_state["skipped_bytes"])
                    xfer_state["skipped_bytes"] = sk
            s0 = xfer_state["sample0"]
            xfer_state["sample0"] = s0 + n_ep * p
            with METRICS.stage("receiver.transfer"):
                if use_packed and n_ep * p == n_samp:
                    seg = self._mix_chunk_packed(blk, s0)
                elif use_packed:
                    # final partial chunk: unpack on the host, trim to
                    # whole epochs, mix as bits
                    bits = loaders.unpack_1bit(blk.tobytes())[: n_ep * p]
                    seg = self._mix_bits(bits, s0)
                elif use_bits:
                    seg = self._mix_bits(blk[: n_ep * p], s0)
                elif use_rawiq:
                    seg = raw_link(blk[: 2 * n_ep * p], signed=signed,
                                   remove_dc=remove_dc, device=self.device)
                else:
                    seg = self._transfer(blk[: n_ep * p])
            return (blk, seg, n_ep, n_samp)

        prefetcher = Prefetcher(source, chunk_len, mode=mode,
                                transform=upload)
        try:
            return self._stream_loop(
                iter(prefetcher), source, n_samples, p,
                chunk_len=chunk_len, use_packed=use_packed,
                use_bits=use_bits, use_rawiq=use_rawiq,
                max_duration_s=max_duration_s, max_channels=max_channels,
                warm_ephemerides=warm_ephemerides, on_solution=on_solution)
        finally:
            prefetcher.stop()

    def _stream_loop(self, blocks, source, n_samples, p, *, chunk_len,
                     use_packed, use_bits, use_rawiq, max_duration_s,
                     max_channels, warm_ephemerides, on_solution):
        """Streaming body of :meth:`process_source` (the reference's
        tpu_gnss/receiver.py:765-1134)."""
        cfg = self.cfg
        with METRICS.stage("receiver.read"):
            first_item = next(blocks, None)
        if first_item is None:
            return ReceiverResult(detections=[], channels=[], solutions=[])
        first = first_item[0]
        if n_samples(first) < self.searcher.block_len:
            if chunk_len < self.searcher.block_len:
                raise ValueError("chunk_s too small for the acquisition block")
            return ReceiverResult(detections=[], channels=[], solutions=[])

        n_chan = max_channels or cfg.num_chans
        if self.mesh is not None and n_chan % self.mesh.shape["dop"]:
            raise ValueError(
                f"mesh mode: the channel count ({n_chan}) must divide by the "
                f"mesh's 'dop' shards ({self.mesh.shape['dop']}); pass "
                "max_channels")
        state = tc.init_state(n_chan, self.device)
        slot_prns = [None] * n_chan   # channel slot -> PRN (None = free)
        live: dict = {}      # channel slot -> active ChannelRecord
        recs: list = []      # every record ever started (incl. lost)
        acq_head_len = self.weak_noncoherent * self.searcher.block_len

        def head_of(blk):
            """Acquisition-ready head samples of a host chunk."""
            if use_packed:     # acquisition sees {0,1} samples
                words = blk[: (acq_head_len + 31) // 32]
                return loaders.unpack_1bit(words.tobytes())[:acq_head_len]
            if use_rawiq:      # convert just the head on the host
                return loaders.iq8_to_complex(
                    blk[: 2 * acq_head_len], signed=source.dtype == "int8",
                    remove_dc=getattr(source, "remove_dc", True))
            return blk[:acq_head_len]

        def start_detections(dets, epoch_searched, epoch_now):
            """Seed channels from detections into free slots, with the
            code phase propagated to ``epoch_now`` (the reference's
            code-creep correction, c/channel.cpp:156-163)."""
            nonlocal state
            if not self._if_offset_locked and dets:
                # one-shot oscillator-offset estimate: sky Doppler stays
                # within ~±5 kHz, so a large common part is the replay
                # TX/RX offset
                med = float(np.median([d["doppler_hz"] for d in dets]))
                if abs(med) > 10e3:
                    self._if_offset = med
                self._if_offset_locked = True
            dt = (epoch_now - epoch_searched) * 1e-3
            free = [ch for ch in range(n_chan) if ch not in live]
            tracked = {r.prn for r in live.values()}
            started, seeds = [], []
            for d in sorted(dets, key=lambda x: -x["snr"]):
                if d["prn"] in tracked or not free:
                    continue
                ch = free.pop(0)
                motion_dop = d["doppler_hz"] - self._if_offset
                rate = CHIP_RATE_HZ * (1.0 + motion_dop / L1_HZ)
                code_phase = (d["ca_shift"] * CHIP_RATE_HZ / cfg.fs
                              + rate * dt) % CODE_LEN_CHIPS
                seeds.append((ch, d["doppler_hz"], code_phase, motion_dop))
                slot_prns[ch] = d["prn"]
                rec = ChannelRecord(ch=ch, prn=d["prn"],
                                    start_epoch=epoch_now,
                                    code_phase0=code_phase)
                if warm_ephemerides and d["prn"] in warm_ephemerides:
                    # deep copy: NAV decode mutates the Ephemeris in place;
                    # the caller's dict must survive a partial new-IOD
                    # ingest, and a lost and re-acquired PRN must not
                    # alias one object
                    rec.eph = copy.deepcopy(warm_ephemerides[d["prn"]])
                live[ch] = rec
                recs.append(rec)
                tracked.add(d["prn"])
                started.append(d)
            if seeds:
                chs, dops_s, cps, mds = zip(*seeds)
                state = tc.start_channels(state, chs, dops_s, cps, mds)
            return started

        def try_acquire(blk, epoch_now):
            if all(ch in live for ch in range(n_chan)):
                return []
            tracked = frozenset(r.prn for r in live.values())
            dets = self._cold_detections(head_of(blk),
                                         bits=use_bits or use_packed,
                                         skip_prns=tracked)
            return start_detections(dets, epoch_now, epoch_now)

        with METRICS.stage("receiver.acquire"):
            first_dets = try_acquire(first, 0)
        reacq_base = int(self.reacq_interval_s * 1000)
        reacq_cooldown = reacq_base
        next_reacq = reacq_base
        n_dispatched = 0     # epochs sent to the tracker
        n_drained = 0        # epochs whose outputs reached the records
        loss_events = 0      # signal-loss count (re-arm bookkeeping)
        solutions: list = []
        step_ms = int(self.solve_interval_s * 1000)
        next_solve = step_ms

        def drain(pending):
            """Fetch an earlier chunk's outputs; bookkeeping, watchdog and
            history bounding."""
            nonlocal state, reacq_cooldown, next_reacq, loss_events
            nonlocal n_drained
            out_fut, snapshot, chunk_ep = pending
            with METRICS.stage("receiver.fetch"):
                arr, elp = out_fut.result()      # [5, n_ep, n_chan]
            with METRICS.stage("receiver.drain"):
                ip, qp, cf, caf, cp = arr
                # skip channels an earlier drain declared lost, and copy
                # the column slices (views would pin the chunk buffer)
                for r in snapshot:
                    if r.lost:
                        continue
                    r.append_hist(np.ascontiguousarray(ip[:, r.ch]),
                                  np.ascontiguousarray(qp[:, r.ch]),
                                  np.ascontiguousarray(cf[:, r.ch]),
                                  np.ascontiguousarray(caf[:, r.ch]),
                                  np.ascontiguousarray(cp[:, r.ch]))
                    # code-lock detector input: chunk-mean E/L/P mags
                    e_m, l_m, p_m = (float(elp[0, r.ch]),
                                     float(elp[1, r.ch]),
                                     float(elp[2, r.ch]))
                    side = max(0.5 * (e_m + l_m), 1e-30)
                    r.code_lock = p_m / side
                    r.code_lock_hist.append((r.n_epochs, r.code_lock))
                    if len(r.code_lock_hist) > 4096:
                        del r.code_lock_hist[:2048]
                self._watchdog([r for r in snapshot if not r.lost])
                stopped = False
                for ch in [c for c, r in live.items() if r.lost]:
                    state = tc.stop_channel(state, ch)
                    slot_prns[ch] = None
                    del live[ch]
                    stopped = True
                if stopped:     # a loss re-arms the search promptly
                    loss_events += 1
                    reacq_cooldown = reacq_base
                    next_reacq = min(next_reacq, n_dispatched + reacq_base)
                if self.max_history_s is not None:
                    # the window holds whole subframes with margin, so NAV
                    # decode inside it stays possible
                    keep = max(int(self.max_history_s * 1000), 12000)
                    for r in recs:
                        if r.lost and (n_dispatched
                                       - (r.start_epoch + r.n_epochs)
                                       > keep):
                            # beyond any future snapshot: drop the whole
                            # history (anchors and ephemeris stay)
                            r.trim_to(0)
                        elif r.n_epochs - r.trim_epochs > keep:
                            # decode before the window slides past
                            # undecoded bits (anchors survive archived)
                            with METRICS.stage("receiver.nav"):
                                self._decode_nav(r)
                            r.trim_to(keep)
                n_drained += chunk_ep

        def instream_solve():
            """Live-mode NAV decode and PVT at the solve cadence."""
            nonlocal next_solve
            while next_solve <= n_drained - 2:
                with METRICS.stage("receiver.nav"):
                    for r in recs:
                        if not r.lost:
                            self._decode_nav(r)
                with METRICS.stage("receiver.solve"):
                    sol = self._solve_at(recs, next_solve)
                if sol is not None:
                    sol.snap_epoch = next_solve
                    solutions.append(sol)
                    on_solution(sol)
                next_solve += step_ms

        # steady-state re-acquisition runs in a worker thread; results
        # are applied at the next chunk boundary with code-creep
        # propagation.  The blocking device->host copies run in the fetch
        # thread, so the main loop keeps enqueueing device work.
        fetch_pool = ThreadPoolExecutor(max_workers=1)
        reacq_job = None

        def launch_reacq(blk, epoch_now):
            tracked = frozenset(r.prn for r in live.values())
            job = {"done": threading.Event(), "dets": [], "error": None,
                   "epoch": epoch_now, "loss_mark": loss_events}

            def work():
                try:
                    with METRICS.stage("receiver.acquire"):
                        job["dets"] = self._cold_detections(
                            head_of(blk), bits=use_bits or use_packed,
                            skip_prns=tracked)
                except BaseException as exc:   # re-raised in the loop
                    job["error"] = exc
                finally:
                    job["done"].set()

            threading.Thread(target=work, daemon=True).start()
            return job

        def fetch(a, b):
            return a.cpu().numpy(), b.cpu().numpy()

        # chunks in flight before the host drains: live mode keeps one so
        # fixes and the watchdog lag the stream by at most one chunk
        depth = 1 if on_solution is not None else 2
        pendings: deque = deque()
        item = first_item
        try:
            while item is not None:
                blk, seg, n_ep, n_samp = item
                if n_ep == 0:
                    break
                tail_ep = n_samp // p - n_ep
                if reacq_job is not None:
                    # the search is applied at this boundary, the one after
                    # its launch, however fast the tracker ran the chunk:
                    # left to finish "when done", a search on a card that
                    # tracks at ~100x realtime lands many chunks later, at
                    # an epoch that depends on thread timing, and the
                    # code-creep propagation over that gap can miss lock
                    reacq_job["done"].wait()
                    if reacq_job["error"] is not None:
                        raise reacq_job["error"]
                    started = start_detections(reacq_job["dets"],
                                               reacq_job["epoch"],
                                               n_dispatched)
                    # fruitless searches back off exponentially; a hit or
                    # a fresh loss resets the cadence
                    reacq_cooldown = (reacq_base if started
                                      else min(2 * reacq_cooldown,
                                               8 * reacq_base))
                    if reacq_job["loss_mark"] == loss_events:
                        next_reacq = n_dispatched + reacq_cooldown
                    else:
                        next_reacq = min(next_reacq,
                                         n_dispatched + reacq_cooldown)
                    reacq_job = None
                if (reacq_job is None and n_dispatched >= next_reacq
                        and len(live) < n_chan
                        and n_samp >= self.searcher.block_len):
                    reacq_job = launch_reacq(blk, n_dispatched)
                tables, code_ffts = self._tables_for(tuple(slot_prns), n_chan)
                with METRICS.stage("receiver.track"):
                    state, out = self._tracker(seg, state, tables, code_ffts,
                                               float(self._if_offset))
                    out_dev, elp_dev = _pack_out(out)
                pendings.append((fetch_pool.submit(fetch, out_dev, elp_dev),
                                 list(live.values()), n_ep))
                n_dispatched += n_ep
                while len(pendings) > depth:
                    drain(pendings.popleft())
                    if on_solution is not None:
                        instream_solve()
                if (max_duration_s is not None
                        and n_dispatched * 1e-3 >= max_duration_s):
                    break
                if tail_ep:
                    break       # partial final chunk: nothing follows
                with METRICS.stage("receiver.read"):
                    item = next(blocks, None)
            while pendings:
                drain(pendings.popleft())
                if on_solution is not None:
                    instream_solve()
        finally:
            fetch_pool.shutdown(wait=True, cancel_futures=True)
            if reacq_job is not None:
                reacq_job["done"].wait()

        with METRICS.stage("receiver.nav"):
            for r in recs:
                self._decode_nav(r)
        done = {s.snap_epoch for s in solutions}
        snap_epochs = [e for e in range(step_ms, n_dispatched, step_ms)
                       if e not in done]
        if (n_dispatched > 2 and n_dispatched - 2 not in done
                and n_dispatched - 2 not in snap_epochs):
            snap_epochs.append(n_dispatched - 2)
        with METRICS.stage("receiver.solve"):
            for e_snap in snap_epochs:
                sol = self._solve_at(recs, e_snap)
                if sol is not None:
                    sol.snap_epoch = e_snap
                    solutions.append(sol)
                    if on_solution is not None:   # end-of-stream stragglers
                        on_solution(sol)
        solutions.sort(key=lambda s: s.snap_epoch)
        return ReceiverResult(detections=first_dets, channels=recs,
                              solutions=solutions)

    # ------------------------------------------------------------------
    def _transfer(self, blk: np.ndarray) -> torch.Tensor:
        """One complex chunk host -> device over the ``transfer_dtype``
        link (tpu_gnss/receiver.py:1137-1171).  A failed upload raises:
        there is no fallback to another link."""
        blk = np.ascontiguousarray(blk)
        if self.transfer_dtype == "int2":
            return xfer.to_device_complex_i2(blk, self.device)
        if self.transfer_dtype == "float32":
            return xfer.to_device_complex(blk, self.device)
        rms = float(np.sqrt(np.mean(np.abs(blk[:65536]) ** 2)))
        if self.transfer_dtype == "int4":
            scale = 7.0 / (3.0 * rms) if rms > 1e-12 else 1.0
            return xfer.to_device_complex_i4(blk, scale, self.device)
        # per-chunk 6-sigma scale: follows level drift and never pins a
        # degenerate scale from a quiet capture start
        scale = 127.0 / (6.0 * rms) if rms > 1e-12 else 1.0
        return xfer.to_device_complex_i8(blk, scale, self.device)

    def _mix_chunk_packed(self, words: np.ndarray, sample0: int):
        """Device unpack + mix of a packed uint32 word chunk.  The LO
        phase of the chunk's first sample is reduced on the host in
        float64 (exact for any capture length)."""
        p0 = float((sample0 * float(self.cfg.lo_rate)) % 4.0)
        return mix_packed(words_to_tensor(words, self.device),
                          n_bits=32 * len(words), lo_rate=self.cfg.lo_rate,
                          phase0_quarters=p0)

    def _mix_bits(self, bits: np.ndarray, sample0: int):
        """Device mix of a {0,1} chunk (final partial packed chunks and
        unpacked-bit sources)."""
        p0 = float((sample0 * float(self.cfg.lo_rate)) % 4.0)
        dev_bits = torch.from_numpy(
            np.ascontiguousarray(bits, np.uint8)).to(self.device)
        return mix_baseband(dev_bits, self.cfg.lo_rate, phase0_quarters=p0)

    # ------------------------------------------------------------------
    def _tables_for(self, slot_key: tuple, n_chan: int):
        """``(code_tables, code_ffts)`` on the device for the slot map:
        the ``[n_chan, NF]`` correlator spectra with ``fft_correlator``,
        else the ``[n_chan, 1023]`` code tables of the gather correlator
        (the other is None).  Uploaded only when the channel->PRN
        assignment changes."""
        cached = self._tables_cache
        if cached is not None and cached[0] == slot_key:
            return cached[1]
        prns = [prn if prn is not None else 1 for prn in slot_key]
        if self.fft_correlator:
            pair = (None, torch.from_numpy(
                tc.code_spectra_np(prns, n_chan, self.cfg.fs)).to(self.device))
        else:
            pair = (torch.from_numpy(
                tc.channel_code_tables(prns, n_chan)).to(self.device), None)
        self._tables_cache = (slot_key, pair)
        return pair

    # ------------------------------------------------------------------
    # host half, copied from tpu_gnss/receiver.py:1225-1537
    def _watchdog(self, recs) -> None:
        """Free channels whose prompt power collapsed (SignalLost analog)
        or that never produced a parity-valid subframe (probation,
        reference: c/channel.cpp:39,343,363 — a false acquisition tracks
        noise at stable power, so the power watchdog alone would let it
        occupy a slot and block its PRN forever)."""
        win = int(self.los_timeout_s * 1000)
        probation = int(self.probation_s * 1000)
        for r in recs:
            if r.lost or r.n_epochs < 2 * win:
                continue
            if (r._decoded_upto >= probation
                    and not r.subframes and not r.archived_subframes):
                r.lost = True
                continue
            if r._ref_pwr is None:
                ref = r.abs_slice("ip", win // 2, win)
                if len(ref) == 0:    # early history already trimmed
                    ref = r.tail("ip", win)
                r._ref_pwr = float(np.mean(np.square(ref)))
            cur = r.tail("ip", win)
            cur_pwr = float(np.mean(np.square(cur)))
            if r._ref_pwr > 0 and cur_pwr < self.los_power_ratio * r._ref_pwr:
                r.lost = True

    def _decode_nav(self, r: ChannelRecord) -> None:
        """(Re-)decode a channel's NAV stream from its prompt history.

        Idempotent: live mode re-runs it as history grows, so the
        subframe list is rebuilt from scratch each call.
        """
        ip = r.ip_hist
        # Incremental decode window: the first pass covers everything
        # retained; later passes re-cover a 12 s overlap (two subframes)
        # plus the new epochs, so repeated live-mode decodes cost
        # O(new), not O(total history).  Anchors older than the window
        # survive: a_edge and tow are absolute — archive them first.
        if r._decoded_upto == 0:
            start = r.trim_epochs
        else:
            start = max(r.trim_epochs, r._decoded_upto - 12000)
        skip_abs = max(start, 600)   # skip the pull-in transient
        if r.n_epochs - skip_abs < 40 * CODES_PER_BIT:
            return
        seen = {a["a_edge"] for a in r.archived_subframes}
        for s_old in r.subframes:
            if s_old.get("a_edge") is not None and s_old["a_edge"] not in seen:
                r.archived_subframes.append(s_old)
                seen.add(s_old["a_edge"])
        if len(r.archived_subframes) > 64:   # bound: the transmit-time
            # vote needs a handful of anchors, not a day's worth
            r.archived_subframes = r.archived_subframes[-64:]
        r.subframes = []
        r.last_subframe_bit = None
        r.last_tow = None
        qp = r.qp_hist
        r.cn0_dbhz = cn0_nwpr(ip[-2000:], qp[-2000:])
        # Bit sync on the CODE-PERIOD grid: the NAV bit grid is tied to
        # the tracked chip integral's period index, so every subframe
        # anchor carries an exact edge chip count (a_edge) — immune to
        # the epoch-grid creep that made epoch-based bit offsets slip by
        # a whole period over minutes (see nav/bits.bit_sync_periods).
        ip_s = r.abs_slice("ip", skip_abs, r.n_epochs)
        chips_s = r.abs_slice("chips", skip_abs, r.n_epochs)
        per_s = np.round(np.asarray(chips_s) / CODE_LEN_CHIPS
                         ).astype(np.int64)
        rph = nav_bits.bit_sync_periods(ip_s, per_s)
        r.bit_offset = rph
        bits, b_raw0 = nav_bits.bits_from_prompt_periods(ip_s, per_s, rph)
        r.bits = bits
        frames = nav_bits.frame_sync(bits)
        for f in frames:
            sid = r.eph.ingest(f["data"])
            if sid in (4, 5):
                # collect SV almanac pages (any channel broadcasts the
                # whole constellation's almanac; the reference discards
                # these pages — nav/almanac.py)
                alm = nav_almanac.ingest_page(f["data"])
                if alm is not None and alm.valid():
                    self.almanac[alm.prn] = alm
            # the subframe's first bit starts at this absolute period
            # index -> exact chip count on the channel's integral scale
            start_period = rph + CODES_PER_BIT * (b_raw0 + f["start"])
            a_edge = float(start_period) * CODE_LEN_CHIPS
            # receiver epoch where that bit begins (snapshot gating)
            bit_epoch = (skip_abs
                         + int(np.searchsorted(per_s, start_period)))
            r.subframes.append(dict(sid=sid, tow=r.eph.tow,
                                    bit_epoch=bit_epoch, a_edge=a_edge))
            r.last_subframe_bit = bit_epoch
            r.last_tow = r.eph.tow
        # Hot-start anchors: once the ephemeris is valid, a preamble +
        # parity-valid TLM/HOW pair at the stream tail yields a TOW
        # anchor ~4.8 s before the full subframe completes.  Same
        # (tow, a_edge) anchor convention as full subframes; the solver's
        # cluster vote and RAIM still gate it.
        r.partial_anchors = []
        if r.eph.valid():
            for pa in nav_bits.partial_anchors(bits):
                start_period = rph + CODES_PER_BIT * (b_raw0 + pa["start"])
                a_edge = float(start_period) * CODE_LEN_CHIPS
                bit_epoch = (skip_abs
                             + int(np.searchsorted(per_s, start_period)))
                r.partial_anchors.append(dict(
                    sid="how", tow=pa["tow"],
                    bit_epoch=bit_epoch, a_edge=a_edge))
        r._decoded_upto = r.n_epochs
        if r.eph.valid():
            # a validated ephemeris is strictly better almanac data than
            # the broadcast page
            self.almanac[r.prn] = nav_almanac.Almanac.from_ephemeris(
                r.prn, r.eph)

    def _carrier_smoothed_chips(self, r: ChannelRecord,
                                e_local: int, max_w: int = 20000,
                                settle: int = 1200) -> float:
        """Carrier-smoothed code phase at epoch ``e_local`` (chips).

        Hatch-style smoothing the reference never had: each epoch in a
        trailing window predicts the snapshot's code phase as its own
        tracked chips plus the carrier-implied advance to the snapshot
        (code and carrier are coherent, so the prediction is unbiased
        for any motion/clock dynamics — the advance integrates the
        ACTUAL per-epoch tracked carrier rates); averaging the
        predictions beats the instantaneous DLL estimate by the
        window's independent-sample count.  DLL noise is bandlimited by
        the ~2 Hz loop AND shows multi-second wander events on weak
        channels (r5 soak diagnosis: a lone ~10 m, ~8 s excursion on
        the weakest SV put a 5.9 m spike in an otherwise 1.5 m-median
        series).  The 20 s default window averages those too: swept on
        the 300 s soak scene, max fix error 5.91/3.93/2.58/2.07 m at
        4/10/20/40 s windows with the median flat at ~1.45 m — 20 s
        takes most of the win while keeping the window well under the
        ~100 s real receivers run before code-carrier iono divergence
        (<=~10 cm at typical rates, absent in synthetic scenes)
        matters.  The window skips the pull-in ``settle`` and never
        reaches before channel start (or the trimmed history's head); a
        channel that loses lock stops accumulating epochs, so post-loss
        garbage cannot enter.
        """
        w = min(e_local - settle, max_w, e_local - r.trim_epochs)
        if w < 100:
            return float(r.abs_at("chips", e_local))
        t_epoch = round(self.cfg.fs * 1e-3) / self.cfg.fs
        caf = np.asarray(r.abs_slice("caf", e_local - w, e_local),
                         np.float64)
        rate = (CHIP_RATE_HZ + caf * (CHIP_RATE_HZ / L1_HZ)) * t_epoch
        tail = np.cumsum(rate[::-1])[::-1]    # advance from epoch i to snap
        implied = (np.asarray(r.abs_slice("chips", e_local - w, e_local),
                              np.float64) + tail)
        return float(implied.mean())

    def _integrity_solve(self, t_tx, ephs, weights):
        """Hard + soft fault-gated position solve.

        Hard layer: :func:`pvt.solve_position_raim` at the gross gate
        (``raim_residual_m``, catches code-period slips ~300 km).  Soft
        layer, calibrated to the receiver's OWN noise: once a residual
        baseline exists (last 32 accepted fixes), a fix whose post-fit
        RMS exceeds 5x the recent median (>=1 m) re-solves with
        exclusion at that threshold — a single glitched pseudorange of
        ~10 m self-flags as a 5-10x residual spike long before the
        gross gate (BENCH_soak300 r4: one 8.5 m fix at resid 2.5 m vs
        a 0.4 m baseline).  The original fix is kept if no subset
        passes, so availability never drops below the hard-gate path.
        """
        sol, excl = pvt.solve_position_raim(
            np.asarray(t_tx), ephs, np.asarray(weights), apply_iono=True,
            residual_gate_m=self.raim_residual_m)
        if sol is None or not sol.converged:
            return None, None
        r_rms = sol.residual_rms_m
        if (excl is None and r_rms is not None
                and len(self._resid_hist) >= 8 and len(t_tx) >= 5):
            soft = max(5.0 * float(np.median(self._resid_hist)), 1.0)
            if r_rms > soft:
                sol2, excl2 = pvt.solve_position_raim(
                    np.asarray(t_tx), ephs, np.asarray(weights),
                    apply_iono=True, residual_gate_m=soft)
                if (sol2 is not None and sol2.converged
                        and excl2 is not None):
                    sol, excl = sol2, excl2
        if sol.residual_rms_m is not None:
            self._resid_hist.append(float(sol.residual_rms_m))
        return sol, excl

    def _solve_at(self, recs, e_snap: int) -> Optional[pvt.Solution]:
        """Assemble a consistent snapshot at epoch ``e_snap`` and solve.

        All channels are sampled at the same receiver epoch — the trivial
        array analog of the reference's spi_hog atomic multi-channel clock
        capture (reference: c/solve.cpp:62-85).

        Channel quality is load-bearing here: the Costas lock detector
        and C/N0 gate solver inclusion (the probation analog,
        reference: c/channel.cpp:39,343,363 — a channel must prove
        itself before the solver trusts it), and the WLS weights are
        C/N0-derived (1/sigma^2 of the DLL thermal noise is
        first-order proportional to linear C/N0) instead of raw prompt
        power.
        """
        t_tx, ephs, weights, dops, used = [], [], [], [], []
        for r in recs:
            e_local = e_snap - r.start_epoch  # records may start mid-run
            if (not r.eph.valid()
                    or e_local >= r.n_epochs
                    or e_local <= r.trim_epochs + 1):
                continue
            if self.quality_gate:
                ip_t = r.abs_slice("ip", e_local - 2000, e_local)
                qp_t = r.abs_slice("qp", e_local - 2000, e_local)
                lock = pll_lock_metric(ip_t, qp_t, window=200)
                cn0 = cn0_nwpr(ip_t, qp_t)
                if lock < self.lock_gate:
                    continue
                if cn0 == cn0 and cn0 < self.cn0_gate_dbhz:
                    continue
                cl = r.code_lock_at(e_local)
                if cl is not None and cl < self.code_lock_gate:
                    continue
            subs = {s["a_edge"]: s for s in r.partial_anchors
                    if s.get("a_edge") is not None}
            subs.update({s["a_edge"]: s for s in r.archived_subframes
                         if s.get("a_edge") is not None})
            subs.update({s["a_edge"]: s for s in r.subframes
                         if s.get("a_edge") is not None})
            anchors = [s for s in subs.values()
                       if s["tow"] is not None and s["bit_epoch"] < e_local]
            if not anchors:
                continue
            a_snap = self._carrier_smoothed_chips(r, e_local)
            t = _transmit_time(anchors, a_snap)
            t_tx.append(t)
            ephs.append(r.eph)
            if self.quality_gate:
                # C/N0-derived weight; None (short history) filled with
                # the median below so scales never mix
                weights.append(float(10.0 ** (cn0 / 10.0))
                               if cn0 == cn0 else None)
            else:   # gate off: the reference's prompt-power weighting
                ip = r.abs_slice("ip", e_local - 8, e_local)
                weights.append(float(np.mean(np.square(ip))))
            # carrier Doppler at the snapshot, smoothed over the last
            # 100 ms to average PLL jitter (the loop BW is ~18 Hz)
            cfh = r.abs_slice("caf", e_local - 100, e_local)
            dops.append(float(np.mean(cfh)) if len(cfh) else np.nan)
            used.append(r)
        if len(t_tx) < 4:
            return None
        known = [w for w in weights if w is not None]
        fill = float(np.median(known)) if known else 1.0
        weights = [fill if w is None else w for w in weights]
        # integrity: RAIM fault detection/exclusion — a channel with an
        # inconsistent pseudorange (e.g. a whole-code-period slip,
        # ~300 km) is excluded; with no consistent subset, NO fix is
        # reported rather than a wrong one
        sol, excl = self._integrity_solve(t_tx, ephs, weights)
        if sol is None or not sol.converged:
            return None
        excluded_rec = None
        if excl is not None:
            excluded_rec = (used[excl], t_tx[excl])
            for lst in (t_tx, ephs, weights, dops, used):
                del lst[excl]
        # calendar context for NMEA emission: the subframe-1 week (raw
        # mod-1024; cli.nmea_out resolves it) and the broadcast GPS-UTC
        # leap seconds when any used SV delivered page 18 — so live
        # bursts carry true UTC without the caller re-deriving either
        sol.week = int(ephs[0].week) if ephs else None
        utc_eph = next((e for e in ephs if e.has_utc), None)
        if utc_eph is not None and sol.week is not None:
            sol.leap_s = utc_eph.leap_seconds(
                resolve_week(sol.week), sol.t_rx)
        else:
            sol.leap_s = None
        # satellite view + DOPs for NMEA emission (cli.nmea_out)
        sv = np.array([e.get_xyz(t) for e, t in zip(ephs, t_tx)])
        elev, az, dop_d = sat_geometry(np.array([sol.x, sol.y, sol.z]), sv)
        sol.dops = dop_d
        sol.sats = [dict(prn=r.prn, elev_deg=float(el), az_deg=float(a),
                         cn0_dbhz=r.cn0_dbhz, used=True)
                    for r, el, a in zip(used, elev, az)]
        if excluded_rec is not None:
            # tracked but excluded by integrity: still in view (GSV),
            # marked unused (GSA filters on the flag)
            r_x, t_x = excluded_rec
            el_x, az_x, _ = sat_geometry(
                np.array([sol.x, sol.y, sol.z]),
                np.array([r_x.eph.get_xyz(t_x)]))
            sol.sats.append(dict(prn=r_x.prn, elev_deg=float(el_x[0]),
                                 az_deg=float(az_x[0]),
                                 cn0_dbhz=r_x.cn0_dbhz, used=False))
        # Doppler velocity solve at the converged position (VTG analog;
        # beyond the reference, which never computes velocity)
        # the tracked carrier frequency minus the receiver-applied IF
        # offset is the motion Doppler solve_velocity expects; residual
        # estimate error lands in its clock-drift unknown
        dops = np.asarray(dops) - self._if_offset
        if np.all(np.isfinite(dops)):
            try:
                sol.vel = pvt.solve_velocity(
                    np.array([sol.x, sol.y, sol.z]), sol.t_rx,
                    np.asarray(t_tx), ephs, dops, np.asarray(weights))
            except np.linalg.LinAlgError:
                pass
        return sol


# copied from tpu_gnss/receiver.py:1540-1566
def _transmit_time(anchors, a_snap: float) -> float:
    """Anchor-voted transmit time (SV seconds of week) at the snapshot.

    Each decoded subframe is an independent anchor: its TOW names an
    absolute transmit time, and the chip count at its first bit edge is
    (nearly) a whole number of code periods, so
    ``t = (tow-1)*6 + (a_snap - n_per*1023)/chip_rate``
    (reference transmit-time arithmetic, c/solve.cpp:118-133).

    Each anchor carries its exact edge chip count ``a_edge`` from the
    period-grid bit sync (nav/bits.bit_sync_periods) — no per-anchor
    rounding, so all anchors of a channel agree by construction.  The
    1 ms cluster vote is kept as a safety net (a bit-sync phase change
    between decode passes, an anchor decoded from a corrupted stretch),
    and the median inside the winning cluster averages per-anchor chip
    noise.  (The naive form — rounding the chip integral at the
    DETECTED EPOCH to a whole period — slipped by one period when code
    creep walked the epoch grid across the period grid: a ±300 km
    pseudorange error that only minutes-long soaks exposed.)
    """
    cands = np.array(
        [(s["tow"] - 1) * 6.0 + (a_snap - s["a_edge"]) / CHIP_RATE_HZ
         for s in anchors])
    ref = np.round((cands - cands[0]) / 1e-3)
    vals, counts = np.unique(ref, return_counts=True)
    pick = vals[np.argmax(counts)]
    return float(np.median(cands[ref == pick]))


def _pack_out(out: tc.EpochOut):
    """Per-epoch planes + per-chunk E/L/P magnitude means, on device.

    ``[5, n_ep, n_chan]`` (ip, qp, code_dev, carrier_freq, code_phase)
    for the host bookkeeping and ``[3, n_chan]`` chunk means of |early|,
    |late|, |prompt| for the code-lock detector: one device->host copy
    each per chunk (tpu_gnss/receiver.py:1590-1616).
    """
    planes = torch.stack([out.ip, out.qp, out.code_dev, out.carrier_freq,
                          out.code_phase]).to(torch.float32)
    p_mag = torch.sqrt(out.ip * out.ip + out.qp * out.qp)
    elp = torch.stack([out.e_mag.mean(0), out.l_mag.mean(0),
                       p_mag.mean(0)]).to(torch.float32)
    return planes, elp
