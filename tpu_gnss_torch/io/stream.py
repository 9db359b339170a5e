"""Sample-stream sources for the port.

Reuses the jax-free sources of :mod:`tpu_gnss.io.stream`; only
:class:`FileSource1Bit` is subclassed, because the reference's
``packed_blocks`` imports its jax frontend for the word conversion.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from tpu_gnss.io import stream as _ref
from tpu_gnss.io.stream import ArraySource, Prefetcher

from ..ops.onebit import packed_words_from_file_bytes

__all__ = ["ArraySource", "FileSource1Bit", "Prefetcher"]


class FileSource1Bit(_ref.FileSource1Bit):
    """Bit-packed 1-bit IF capture replay with a jax-free packed reader."""

    def packed_blocks(self, block_len: int) -> Iterator[np.ndarray]:
        """Packed uint32 word blocks — the file's own bytes.

        Same semantics as the reference (tpu_gnss/io/stream.py:98-123): the
        final partial chunk is included, trimmed to whole words so the
        word count implies the exact sample count.
        """
        assert block_len % 32 == 0
        with open(self.path, "rb") as f:
            while True:
                raw = f.read(block_len // 8)
                if raw:
                    raw4 = raw[: 4 * (len(raw) // 4)]
                    if raw4:
                        yield packed_words_from_file_bytes(raw4)
                if len(raw) < block_len // 8:
                    return
