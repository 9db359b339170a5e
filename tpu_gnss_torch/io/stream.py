# Copied from tpu_gnss/io/stream.py:1-140 and 580-678 (SampleSource,
# ArraySource, FileSource1Bit, Prefetcher without its unused `bits`
# switch); packed_blocks uses the port's own word conversion.
"""Sample-stream sources: capture replay and background prefetch.

* :class:`FileSource1Bit` — bit-packed 1-bit capture replay (the offline
  path).
* :class:`ArraySource` — a host complex-baseband array as a source.
* :class:`Prefetcher` — background-thread double buffering so host decode
  overlaps device compute (the SPI-pipelining analog,
  reference: c/spi.cpp:34-53).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from ..config import ReceiverConfig
from ..ops.onebit import packed_words_from_file_bytes
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


class Prefetcher:
    """Background-thread block prefetch (double/triple buffering).

    ``mode``: "iq" (complex blocks), "bits" (unpacked {0,1} samples) or
    "packed" (uint32 words, 1 bit/sample — the cheapest link format).

    ``transform``: optional callable applied to each block IN the pump
    thread.  The receiver passes its host->device upload here so
    transfers overlap device compute and output fetches instead of
    serializing with them.
    """

    def __init__(self, source: SampleSource, block_len: int, depth: int = 3,
                 mode: str = "iq", transform=None):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._src = source
        self._block_len = block_len
        self._mode = mode
        self._transform = transform
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    def _pump(self):
        it = None
        try:
            name = {"bits": "bit_blocks", "packed": "packed_blocks",
                    "iq": "blocks"}[self._mode]
            it = getattr(self._src, name)(self._block_len)
            for blk in it:
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
