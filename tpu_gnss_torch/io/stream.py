# Copied from tpu_gnss/io/stream.py:1-678 (SampleSource, ArraySource,
# FileSource1Bit, IQFileSource, RtlTcpSource, SynthSource, _FollowReader,
# FollowSource1Bit, FollowIQSource and Prefetcher without its unused
# `bits` switch); the packed readers use the port's own word conversion.
"""Sample-stream sources: capture replay, live ingest and prefetch.

* :class:`FileSource1Bit` — bit-packed 1-bit capture replay (the offline
  path).
* :class:`IQFileSource` — int8/uint8 interleaved I/Q replay.
* :class:`RtlTcpSource` — live uint8 I/Q from an rtl_tcp server.
* :class:`SynthSource` — a live-signal simulator.
* :class:`FollowSource1Bit` / :class:`FollowIQSource` — tail a growing
  capture file or a FIFO (live mode).
* :class:`ArraySource` — a host complex-baseband array as a source.
* :class:`Prefetcher` — background-thread double buffering so host decode
  overlaps device compute (the SPI-pipelining analog,
  reference: c/spi.cpp:34-53).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Sequence

import numpy as np

from ..config import ReceiverConfig
from ..ops.onebit import packed_words_from_file_bytes
from ..utils.metrics import METRICS
from . import loaders


class SampleSource:
    """Iterator of complex64 baseband blocks of a fixed length."""

    fs: float

    def blocks(self, block_len: int) -> Iterator[np.ndarray]:
        raise NotImplementedError


class ArraySource(SampleSource):
    """Wrap a host complex-baseband array as a source (process_iq path).

    Unlike the file sources, the FINAL partial block (>= 1 ms) is also
    yielded so an array's trailing epochs are processed, matching the
    old whole-array semantics.
    """

    def __init__(self, data: np.ndarray, fs: float):
        self.data = np.asarray(data)
        self.fs = fs

    def blocks(self, block_len: int) -> Iterator[np.ndarray]:
        p = round(self.fs * 1e-3)
        for i in range(0, len(self.data), block_len):
            blk = self.data[i: i + block_len]
            if len(blk) < p:
                return
            yield blk


class FileSource1Bit(SampleSource):
    """Replay a bit-packed 1-bit IF capture as baseband blocks.

    Mixing uses the offline LO tables with per-block phase restart when
    ``per_block_phase`` (golden-compatible with the reference's Sample())
    or a continuous LO phase otherwise (better for tracking).
    """

    def __init__(self, path: str, cfg: ReceiverConfig,
                 per_block_phase: bool = False):
        self.path = path
        self.cfg = cfg
        self.fs = cfg.fs
        self.per_block_phase = per_block_phase

    def bit_blocks(self, block_len: int) -> Iterator[np.ndarray]:
        """Raw {0,1} sample blocks (uint8), for device-side mixing.

        8x the packed file size but 8x smaller than complex64.
        """
        assert block_len % 8 == 0
        with open(self.path, "rb") as f:
            while True:
                raw = f.read(block_len // 8)
                # the FINAL partial block is yielded too: a capture
                # whose length is not a chunk multiple must not lose its
                # tail — it can hold the last subframe a fix needs (the
                # receiver processes the whole epochs it contains)
                if raw:
                    yield loaders.unpack_1bit(raw)
                if len(raw) < block_len // 8:
                    return

    def packed_blocks(self, block_len: int) -> Iterator[np.ndarray]:
        """Packed uint32 word blocks — the file's own bytes, zero-copy.

        The fastest path of all: 1 bit/sample crosses the host->device
        link and the unpack+mix runs on device
        (tpu_gnss_torch.ops.onebit.mix_packed).  Requires
        ``block_len % 32 == 0`` so chunks stay word-aligned.
        """
        assert block_len % 32 == 0
        with open(self.path, "rb") as f:
            while True:
                raw = f.read(block_len // 8)
                if raw:
                    # final partial chunk included (see bit_blocks),
                    # trimmed to whole uint32 words: the word count must
                    # imply the EXACT sample count — zero-padding would
                    # fabricate up to 24 samples past the capture end
                    # and could extend the last tracked epoch over data
                    # that never existed.  <=3 tail bytes (<=24 samples,
                    # a fraction of one epoch) are dropped instead.
                    raw4 = raw[: 4 * (len(raw) // 4)]
                    if raw4:
                        yield packed_words_from_file_bytes(raw4)
                if len(raw) < block_len // 8:
                    return

    def blocks(self, block_len: int) -> Iterator[np.ndarray]:
        assert block_len % 8 == 0
        sample0 = 0
        with open(self.path, "rb") as f:
            while True:
                raw = f.read(block_len // 8)
                if raw:   # final partial chunk included (see bit_blocks)
                    bits = loaders.unpack_1bit(raw)
                    # one source of truth for the front-end mix (loaders);
                    # phase restarts per block or runs continuously
                    yield loaders.mix_1bit_block(
                        bits, self.cfg,
                        sample0=0 if self.per_block_phase else sample0)
                    sample0 += 8 * len(raw)
                if len(raw) < block_len // 8:
                    return


class IQFileSource(SampleSource):
    """Replay an interleaved I/Q capture (int8 HackRF / uint8 rtl-sdr)."""

    def __init__(self, path: str, fs: float, dtype: str = "int8",
                 remove_dc: bool = True):
        self.path = path
        self.fs = fs
        self.dtype = dtype
        self.remove_dc = remove_dc

    @property
    def _item(self) -> np.dtype:
        return np.dtype(np.int8 if self.dtype == "int8" else np.uint8)

    def raw_blocks(self, block_len: int) -> Iterator[np.ndarray]:
        """The file's own interleaved bytes, viewed as the native dtype.

        Zero host processing: deinterleave/recenter/DC removal happen on
        device (tpu_gnss_torch.utils.xfer.to_device_iq8) — the receiver's fast
        path for 8-bit captures.
        """
        item = self._item
        with open(self.path, "rb") as f:
            while True:
                raw = f.read(2 * block_len)
                if raw:   # final partial chunk included (see
                    # FileSource1Bit.bit_blocks); truncated to whole
                    # I/Q sample pairs
                    yield np.frombuffer(
                        raw[: 2 * (len(raw) // 2)], dtype=item)
                if len(raw) < 2 * block_len:
                    return

    def blocks(self, block_len: int) -> Iterator[np.ndarray]:
        for raw in self.raw_blocks(block_len):
            yield loaders.iq8_to_complex(raw,
                                         signed=self.dtype == "int8",
                                         remove_dc=self.remove_dc)


class RtlTcpSource(SampleSource):
    """Live SDR ingest over the rtl_tcp protocol (uint8 I/Q stream).

    The reference's rtl-sdr workflow is offline: capture with
    ``rtl_sdr``, convert with ``proc_rtl_bin_for_gps.m``, then run
    ``gps_test`` (README.md §2.2).  This source closes the live gap: it
    speaks the standard ``rtl_tcp`` server protocol (12-byte ``RTL0``
    greeting, 5-byte big-endian tune commands, then a raw uint8
    interleaved I/Q stream), so ``run_receiver rtltcp://host:port``
    produces fixes from a dongle in real time — the SDR analog of the
    reference's live SPI sampler (c/search.cpp:122-160).

    Exposes ``raw_blocks``/``dtype``/``remove_dc`` like
    :class:`IQFileSource`, so the receiver's 8-bit fast path applies:
    the socket's own bytes cross the host->device link and
    deinterleave/recenter/DC-removal run on device.

    Tune the server to the L1 center (1575.42 MHz) and give the
    receiver ``if_offset_hz="auto"`` / a wide ``max_fo``: dongle
    crystal error is exactly the replay-capture oscillator-offset
    problem the ±100 kHz grid exists for (README.md §2.1e).

    A receive gap longer than ``stall_timeout_s`` ends the stream with
    ``stalled=True`` (server died / USB stall), mirroring the follow
    sources' stall semantics.
    """

    CMD_FREQ = 0x01
    CMD_RATE = 0x02
    CMD_GAIN_MODE = 0x03
    CMD_GAIN = 0x04
    CMD_PPM = 0x05
    CMD_AGC = 0x08

    dtype = "uint8"
    remove_dc = True

    def __init__(self, host: str, port: int, fs: float,
                 freq_hz: float = 1575.42e6,
                 gain_db: Optional[float] = None, ppm: int = 0,
                 stall_timeout_s: float = 5.0,
                 _sock=None):
        import socket as _socket
        self.fs = fs
        self.stalled = False
        self.error: Optional[str] = None   # mid-stream socket failure
        self.stall_timeout_s = stall_timeout_s
        self.sock = (_sock if _sock is not None
                     else _socket.create_connection((host, port),
                                                    timeout=stall_timeout_s))
        try:
            self.sock.settimeout(stall_timeout_s)
            hdr = self._read_exact(12)
            if hdr is None or hdr[:4] != b"RTL0":
                got = "nothing" if hdr is None else repr(hdr[:4])
                raise ValueError(
                    f"not an rtl_tcp server at {host}:{port} "
                    f"(greeting {got}, want b'RTL0')")
            self.tuner_type = int.from_bytes(hdr[4:8], "big")
            self.tuner_gain_count = int.from_bytes(hdr[8:12], "big")
            self._cmd(self.CMD_RATE, int(round(fs)))
            self._cmd(self.CMD_FREQ, int(round(freq_hz)))
            if ppm:
                self._cmd(self.CMD_PPM, ppm)
            if gain_db is None:
                self._cmd(self.CMD_GAIN_MODE, 0)   # tuner AGC
                self._cmd(self.CMD_AGC, 1)
            else:
                self._cmd(self.CMD_GAIN_MODE, 1)
                self._cmd(self.CMD_GAIN, int(round(gain_db * 10)))
        except BaseException:
            self.sock.close()
            raise

    def _cmd(self, cmd: int, param: int) -> None:
        # uint32 big-endian; negatives (gain/ppm corrections) ride as
        # two's complement, matching the rtl_tcp wire format
        self.sock.sendall(bytes([cmd])
                          + (int(param) & 0xFFFFFFFF).to_bytes(4, "big"))

    def _read_exact(self, n: int) -> Optional[bytes]:
        """Read exactly n bytes; None on EOF/stall/error.

        A timeout sets ``stalled`` (hung server); a socket error sets
        ``error`` (crashed server / dropped network) — both are
        distinguishable from a clean end-of-stream by the caller.
        """
        import socket as _socket
        buf = bytearray()
        while len(buf) < n:
            try:
                chunk = self.sock.recv(n - len(buf))
            except (_socket.timeout, TimeoutError):
                self.stalled = True
                return None
            except OSError as e:
                self.error = str(e)
                return None
            if not chunk:        # orderly server close
                return None
            buf.extend(chunk)
        return bytes(buf)

    def raw_blocks(self, block_len: int) -> Iterator[np.ndarray]:
        """Interleaved uint8 I/Q straight off the socket."""
        try:
            while True:
                raw = self._read_exact(2 * block_len)
                if raw is None:
                    return
                yield np.frombuffer(raw, dtype=np.uint8)
        finally:
            self.close()

    def blocks(self, block_len: int) -> Iterator[np.ndarray]:
        for raw in self.raw_blocks(block_len):
            yield loaders.iq8_to_complex(raw, signed=False,
                                         remove_dc=self.remove_dc)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class SynthSource(SampleSource):
    """Live-signal simulator: generates baseband blocks on demand."""

    def __init__(self, svs: Sequence, fs: float, noise_std: float = 0.5,
                 seed: int = 0):
        from ..signal import synth
        self._synth = synth
        self.svs = list(svs)
        self.fs = fs
        self.noise_std = noise_std
        self.seed = seed

    def blocks(self, block_len: int) -> Iterator[np.ndarray]:
        # synthesize lazily in whole blocks with continuous phase by
        # offsetting each SV's code/carrier phase per block
        from ..constants import CHIP_RATE_HZ, L1_HZ
        import dataclasses
        n0 = 0
        rng = np.random.default_rng(self.seed)
        while True:
            svs_shifted = []
            t0 = n0 / self.fs
            for sv in self.svs:
                rate = CHIP_RATE_HZ * (1.0 + sv.doppler_hz / L1_HZ)
                svs_shifted.append(dataclasses.replace(
                    sv,
                    code_phase_chips=sv.code_phase_chips + rate * t0,
                    carrier_phase_cycles=(sv.carrier_phase_cycles
                                          + sv.doppler_hz * t0) % 1.0))
            blk = self._synth.synth_baseband(
                svs_shifted, self.fs, block_len, noise_std=0.0)
            if self.noise_std > 0:
                blk = blk + (self.noise_std / np.sqrt(2.0)) * (
                    rng.standard_normal(block_len)
                    + 1j * rng.standard_normal(block_len)).astype(np.complex64)
            yield blk.astype(np.complex64)
            n0 += block_len


class _FollowReader:
    """Tail a GROWING file: exact-size chunks, never past the frontier.

    The live-receiver ingest primitive (reference: c/search.cpp:122-160
    services samples as the FPGA produces them; c/main.cpp:66-75 keeps
    the task loop spinning forever).  The producer here is any process
    appending to ``path`` — an SDR capture pipe drain, a network fetch,
    a writer thread in tests.

    Semantics:
    * chunks are read only when the writer's frontier (``st_size``) is
      at least one whole chunk ahead — a partial tail is never returned
      and the read position never passes the frontier;
    * clean EOF: a sidecar ``<path>.done`` file marks end-of-stream —
      iteration ends once the remaining whole chunks are drained;
    * stall: no growth for ``stall_timeout_s`` ends iteration with
      ``stalled=True`` (distinguishable from clean EOF);
    * fall-behind: ``max_lag_bytes`` records the worst distance between
      the frontier and the read position.  With ``max_lag_bytes_limit``
      set, the reader SKIPS ahead (whole chunks) once the lag exceeds
      the limit, counting ``skipped_bytes`` — tracking channels glitch
      over a skip and the receiver's watchdog + re-acquisition recover,
      which is honest live-receiver fall-behind behavior.
    """

    def __init__(self, path: str, stall_timeout_s: float = 5.0,
                 poll_s: float = 0.02,
                 max_lag_bytes_limit: Optional[int] = None):
        self.path = path
        self.stall_timeout_s = stall_timeout_s
        self.poll_s = poll_s
        self.max_lag_bytes_limit = max_lag_bytes_limit
        self.stalled = False
        self.pos = 0                # bytes consumed (read or skipped)
        self.max_lag_bytes = 0
        self.skipped_bytes = 0
        self.waits = 0              # times the reader out-ran the writer

    def chunks(self, nbytes: int) -> Iterator[bytes]:
        import os
        import stat
        import time

        # the natural live ordering is receiver-before-writer: wait for
        # the capture file to APPEAR (same stall budget as for growth)
        waited = 0.0
        while not os.path.exists(self.path):
            if os.path.exists(self.path + ".done"):
                return
            if waited >= self.stall_timeout_s:
                self.stalled = True
                return
            self.waits += 1
            time.sleep(self.poll_s)
            waited += self.poll_s
        if stat.S_ISFIFO(os.stat(self.path).st_mode):
            yield from self._fifo_chunks(nbytes)
            return
        with open(self.path, "rb") as f:
            waited = 0.0
            while True:
                frontier = os.fstat(f.fileno()).st_size
                lag = frontier - self.pos
                if lag > self.max_lag_bytes:
                    self.max_lag_bytes = lag
                limit = self.max_lag_bytes_limit
                if limit is not None and lag > limit:
                    # skip whole chunks until within half the limit
                    n_skip = ((lag - limit // 2) // nbytes) * nbytes
                    if n_skip > 0:
                        f.seek(n_skip, 1)
                        self.pos += n_skip
                        self.skipped_bytes += n_skip
                        lag -= n_skip
                if lag >= nbytes:
                    raw = f.read(nbytes)
                    assert len(raw) == nbytes
                    self.pos += nbytes
                    waited = 0.0
                    yield raw
                    continue
                if os.path.exists(self.path + ".done"):
                    return              # clean end-of-stream
                if waited >= self.stall_timeout_s:
                    self.stalled = True
                    return
                self.waits += 1
                time.sleep(self.poll_s)
                waited += self.poll_s

    def _fifo_chunks(self, nbytes: int) -> Iterator[bytes]:
        """Named-pipe variant: the pipe buffer IS the flow control.

        A FIFO has no growing st_size to poll — the OS holds data until
        the reader drains it (the sample-upload backpressure the
        reference gets from its SPI BUSY flag, c/spi.cpp:34-53).
        Fall-behind cannot happen (the pipe buffer bounds the writer, so
        ``max_lag_bytes_limit`` is a no-op here), but a writer that
        HANGS without closing must still be detected: the fd is
        non-blocking and polled with the same ``stall_timeout_s`` budget
        as the growing-file path, ending iteration with ``stalled=True``.
        Writer closing the pipe -> EOF -> clean end-of-stream.
        """
        import os
        import select
        import time

        # O_NONBLOCK: open succeeds before any writer connects, and
        # reads never block the pump thread forever on a hung writer
        fd = os.open(self.path, os.O_RDONLY | os.O_NONBLOCK)
        try:
            buf = bytearray()
            seen_writer = False
            deadline = time.monotonic() + self.stall_timeout_s
            poller = select.poll()
            poller.register(fd, select.POLLIN)
            while True:
                ev = poller.poll(self.poll_s * 1000.0)
                hup = any(e & select.POLLHUP for _, e in ev)
                readable = any(e & select.POLLIN for _, e in ev)
                # POLLHUP distinguishes "no writer attached" from "a
                # writer connected but idle": a writer that connects and
                # closes WITHOUT writing flips hup off then back on —
                # observed as seen_writer + hup + no data = clean
                # zero-byte end-of-stream, not a stall
                if not hup:
                    seen_writer = True
                if readable:
                    try:
                        got = os.read(fd, nbytes - len(buf))
                    except BlockingIOError:
                        got = b""
                    if got:
                        seen_writer = True
                        deadline = time.monotonic() + self.stall_timeout_s
                        buf.extend(got)
                        if len(buf) == nbytes:
                            self.pos += nbytes
                            yield bytes(buf)
                            buf.clear()
                        continue
                if hup and seen_writer:
                    return   # writer closed: clean end of stream
                # idle or unconnected.  With HUP set poll() returns
                # immediately, so sleep explicitly to avoid a hot spin;
                # the stall budget is wall-clock either way.
                if hup:
                    time.sleep(self.poll_s)
                self.waits += 1
                if time.monotonic() >= deadline:
                    self.stalled = True
                    return
        finally:
            os.close(fd)


class FollowSource1Bit(FileSource1Bit):
    """Live personality: tail a growing bit-packed 1-bit capture.

    Drop-in for :class:`FileSource1Bit` (same block interfaces, so the
    receiver's packed-word fast path applies) but the file may still be
    being written: blocks are served as the writer produces them,
    realtime pacing implied by availability.  See :class:`_FollowReader`
    for EOF-vs-stall and fall-behind semantics.
    """

    def __init__(self, path: str, cfg: ReceiverConfig,
                 stall_timeout_s: float = 5.0, poll_s: float = 0.02,
                 max_lag_s: Optional[float] = None):
        super().__init__(path, cfg, per_block_phase=False)
        limit = (None if max_lag_s is None
                 else int(max_lag_s * cfg.fs / 8))
        self.reader = _FollowReader(path, stall_timeout_s, poll_s,
                                    max_lag_bytes_limit=limit)

    @property
    def stalled(self) -> bool:
        return self.reader.stalled

    @property
    def max_lag_s(self) -> float:
        return self.reader.max_lag_bytes * 8 / self.fs

    def bit_blocks(self, block_len: int) -> Iterator[np.ndarray]:
        assert block_len % 8 == 0
        for raw in self.reader.chunks(block_len // 8):
            yield loaders.unpack_1bit(raw)

    def packed_blocks(self, block_len: int) -> Iterator[np.ndarray]:
        assert block_len % 32 == 0
        for raw in self.reader.chunks(block_len // 8):
            yield packed_words_from_file_bytes(raw)

    def blocks(self, block_len: int) -> Iterator[np.ndarray]:
        assert block_len % 8 == 0
        for raw in self.reader.chunks(block_len // 8):
            bits = loaders.unpack_1bit(raw)
            sample0 = (self.reader.pos - len(raw)) * 8
            yield loaders.mix_1bit_block(bits, self.cfg, sample0=sample0)


class FollowIQSource(IQFileSource):
    """Live personality for interleaved 8-bit I/Q captures (tailing)."""

    def __init__(self, path: str, fs: float, dtype: str = "int8",
                 remove_dc: bool = True, stall_timeout_s: float = 5.0,
                 poll_s: float = 0.02, max_lag_s: Optional[float] = None):
        super().__init__(path, fs, dtype, remove_dc)
        limit = (None if max_lag_s is None else int(max_lag_s * fs * 2))
        self.reader = _FollowReader(path, stall_timeout_s, poll_s,
                                    max_lag_bytes_limit=limit)

    @property
    def stalled(self) -> bool:
        return self.reader.stalled

    @property
    def max_lag_s(self) -> float:
        return self.reader.max_lag_bytes / (2 * self.fs)

    def raw_blocks(self, block_len: int) -> Iterator[np.ndarray]:
        for raw in self.reader.chunks(2 * block_len):
            yield np.frombuffer(raw, dtype=self._item)

    def blocks(self, block_len: int) -> Iterator[np.ndarray]:
        for raw in self.reader.chunks(2 * block_len):
            yield loaders.iq8_to_complex(
                np.frombuffer(raw, dtype=self._item),
                signed=self.dtype == "int8", remove_dc=self.remove_dc)


class Prefetcher:
    """Background-thread block prefetch (double/triple buffering).

    ``mode``: "iq" (complex blocks), "bits" (unpacked {0,1} samples),
    "packed" (uint32 words, 1 bit/sample — the cheapest link format), or
    "rawiq" (the 8-bit capture's own interleaved bytes).

    ``transform``: optional callable applied to each block IN the pump
    thread.  The receiver passes its host->device upload here so
    transfers overlap device compute and output fetches instead of
    serializing with them.

    The pump runs in the creating thread's span and capture; each step of
    the source's reader is an ``io.read`` span.
    """

    def __init__(self, source: SampleSource, block_len: int, depth: int = 3,
                 mode: str = "iq", transform=None):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._src = source
        self._block_len = block_len
        self._mode = mode
        self._transform = transform
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._pump,
                                        args=(METRICS.handoff(),),
                                        daemon=True)
        self._thread.start()

    def _pump(self, handoff):
        with METRICS.adopted(handoff):
            self._pump_blocks()

    def _pump_blocks(self):
        it = None
        try:
            name = {"bits": "bit_blocks", "packed": "packed_blocks",
                    "rawiq": "raw_blocks", "iq": "blocks"}[self._mode]
            it = getattr(self._src, name)(self._block_len)
            while True:
                with METRICS.stage("io.read"):
                    blk = next(it, None)
                if blk is None:
                    break
                if self._stop.is_set():
                    return
                if self._transform is not None:
                    blk = self._transform(blk)
                while not self._stop.is_set():
                    try:
                        self._q.put(blk, timeout=0.1)
                        break
                    except queue.Full:
                        pass
                if self._stop.is_set():
                    return
        except BaseException as exc:  # re-raised in the consumer
            self._err = exc
        finally:
            # closing the generator here (in the pump thread, after the
            # loop exits) releases the open capture file
            if it is not None and hasattr(it, "close"):
                try:
                    it.close()
                except Exception:
                    pass
            # end-of-stream sentinel: must block until there is room
            # (a full queue just means the consumer is behind) but stay
            # interruptible so stop() can release an abandoned pump
            while not self._stop.is_set():
                try:
                    self._q.put(None, timeout=0.1)
                    break
                except queue.Full:
                    pass

    def stop(self, join_timeout_s: float = 5.0) -> None:
        """Terminate the pump thread and release its resources.

        Safe after any exit from the consuming loop (early break, an
        exception, end of stream).  Without this, an early-abandoned
        Prefetcher pins ~depth queued chunks (each a device-resident
        buffer when ``transform`` uploads), a daemon thread blocked on the
        queue, and the open capture file for the process lifetime.
        """
        self._stop.set()
        while self._thread.is_alive():
            # unblock a pump stuck in q.put; bounded by the put timeout
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.2)
            join_timeout_s -= 0.2
            if join_timeout_s <= 0:
                break   # reader blocked in I/O: the daemon thread dies
                        # with the process; the queue is empty

    def __iter__(self):
        while True:
            blk = self._q.get()
            if blk is None:
                # a reader failure must not masquerade as a clean EOF
                err = getattr(self, "_err", None)
                if err is not None:
                    raise err
                return
            yield blk
