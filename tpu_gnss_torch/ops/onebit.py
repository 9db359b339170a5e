"""Device-side 1-bit frontend: packed-word unpack + quadrature mix.

Counterpart of :mod:`tpu_gnss.ops.onebit` (``unpack_bits``,
``mix_packed``, ``packed_words_from_file_bytes``).  Captures are
bit-packed LSB first; the packed words cross to the device (1 bit per
sample) and are unpacked and mixed there.  Words travel as int32 tensors
holding the uint32 bit patterns: an arithmetic right shift followed by
``& 1`` still yields bit k, and int32 has full operator support.
"""

from __future__ import annotations

import numpy as np
import torch

from ..acquire.search import mix_baseband


def packed_words_from_file_bytes(raw: bytes) -> np.ndarray:
    """Capture-file bytes -> uint32 words (same LSB-first bit order).

    Copied from tpu_gnss/ops/onebit.py:40-46.
    """
    buf = np.frombuffer(raw, dtype=np.uint8)
    pad = (-len(buf)) % 4
    if pad:
        buf = np.concatenate([buf, np.zeros(pad, np.uint8)])
    return buf.view(np.uint32)


def words_to_tensor(words: np.ndarray, device) -> torch.Tensor:
    """uint32 words -> int32 tensor of the same bit patterns on device."""
    w = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    if not w.flags.writeable:     # file bytes: torch wants owned memory
        w = w.copy()
    return torch.from_numpy(w).to(device)


def unpack_bits(words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """int32 words -> {0,1} int32 bit array (LSB first), length n_bits."""
    k = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[:, None] >> k[None, :]) & 1
    return bits.reshape(-1)[:n_bits]


def mix_packed(words: torch.Tensor, *, n_bits: int, lo_rate: float,
               phase0_quarters: float = 0.0) -> torch.Tensor:
    """Packed words -> complex64 baseband, bit-exact with
    :func:`tpu_gnss_torch.acquire.search.mix_baseband` on the same bits.

    ``phase0_quarters`` (LO phase of the first sample, reduced on the host
    in float64) keeps the LO continuous across streamed chunks.
    """
    return mix_baseband(unpack_bits(words, n_bits), lo_rate,
                        phase0_quarters=phase0_quarters)
