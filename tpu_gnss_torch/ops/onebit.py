"""Device-side 1-bit frontend: packed-word unpack + quadrature mix (kernel 3).

Counterpart of :mod:`tpu_gnss.ops.onebit` (``pack_bits_to_words``,
``unpack_bits``, ``mix_packed``, ``mix_packed_pallas``,
``packed_words_from_file_bytes``).  Captures are bit-packed LSB first;
the packed words cross to the device (1 bit per sample) and are unpacked
and mixed there.  Words travel as int32 tensors holding the uint32 bit
patterns: an arithmetic right shift followed by ``& 1`` still yields
bit k, and int32 has full operator support.

:func:`mix_packed` is the fused unpack + bipolar map + LO mix:

* On a CUDA tensor it launches the hand-written kernel in
  ``csrc/mix_packed.cu`` (one read of the words, one write of the
  complex64 samples), which takes the in-segment phase from
  :func:`part2_table`.
* On a CPU tensor it runs :func:`mix_packed_plain`.

The port takes plain LSB-first words; the TPU kernel's bit-plane layout
(``pack_bits_planes``, ``[n_rows, 128]`` words shaped for the TPU's 128
lanes) is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cache, kernels
from ..acquire.search import PHASE_SPLIT, mix_baseband
from ..io.loaders import LO_TABLES


def pack_bits_to_words(bits: np.ndarray) -> np.ndarray:
    """Host-side: {0,1} sample array -> little-endian uint32 words.

    Copied from tpu_gnss/ops/onebit.py:31-37.
    """
    bits = np.asarray(bits, dtype=np.uint8)
    pad = (-len(bits)) % 32
    if pad:
        bits = np.concatenate([bits, np.zeros(pad, np.uint8)])
    return np.packbits(bits, bitorder="little").view(np.uint32)


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


def mix_packed_plain(words: torch.Tensor, *, n_bits: int, lo_rate: float,
                     phase0_quarters: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of :func:`mix_packed`: unpack, then
    :func:`tpu_gnss_torch.acquire.search.mix_baseband`."""
    return mix_baseband(unpack_bits(words, n_bits), lo_rate,
                        phase0_quarters=phase0_quarters)


@cache.built_once(bound=16)
def part2_table(lo_rate: float, device: str) -> torch.Tensor:
    """``fmod(float32(r) * float32(lo_rate), 4)`` for r < 4096, a float32
    tensor on ``device`` built on the host with numpy: the in-segment part
    of the plain version's LO phase
    (:func:`tpu_gnss_torch.acquire.search._phase_mod4`), rounded as it
    rounds.  ``csrc/mix_packed.cu`` reads it instead of computing it."""
    r = np.arange(PHASE_SPLIT, dtype=np.float32)
    t = np.fmod(r * np.float32(lo_rate), np.float32(4.0))
    return torch.from_numpy(t).to(device)


def _sign_mask(tbl) -> int:
    """Bit p set where the LO table entry for phase p is 1 (sign -1)."""
    return sum(1 << p for p, v in enumerate(tbl) if v)


def mix_packed(words: torch.Tensor, *, n_bits: int, lo_rate: float,
               phase0_quarters: float = 0.0) -> torch.Tensor:
    """Packed words -> complex64 baseband ``[n_bits]``, bit-exact with
    :func:`tpu_gnss_torch.acquire.search.mix_baseband` on the same bits.

    ``words``: 1-D int32 tensor of LSB-first uint32 patterns
    (:func:`words_to_tensor`), at least ``n_bits`` bits long.
    ``phase0_quarters`` (LO phase of the first sample, reduced on the host
    in float64) keeps the LO continuous across streamed chunks.  A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel or
    raises.
    """
    dev = words.device
    if dev.type == "cpu":
        return mix_packed_plain(words, n_bits=n_bits, lo_rate=lo_rate,
                                phase0_quarters=phase0_quarters)
    if dev.type != "cuda":
        raise ValueError(f"mix_packed: unsupported device {dev}")
    if (words.ndim != 1 or words.dtype != torch.int32
            or not words.is_contiguous()):
        raise ValueError("mix_packed: words must be a contiguous 1-D int32 "
                         "tensor")
    if not 0 <= n_bits <= 32 * words.shape[0] or n_bits >= 2 ** 31:
        raise ValueError(f"mix_packed: n_bits={n_bits} does not fit "
                         f"{words.shape[0]} words")
    if lo_rate < 0 or not 0 <= phase0_quarters < 4:
        # the kernel's fmods equal the plain floor-mod only for
        # non-negative operands, and its compare-and-subtract reductions
        # need a phase below 4 (4.0 after float32 rounding at most)
        raise ValueError("mix_packed: need lo_rate >= 0 and "
                         "0 <= phase0_quarters < 4")
    # the float32 constants of mix_baseband / _phase_mod4, rounded once on
    # the host exactly as the plain version rounds them
    c1 = float(np.float32((PHASE_SPLIT * lo_rate) % 4.0))
    ph0 = float(np.float32(phase0_quarters))
    i_tbl, q_tbl = LO_TABLES["offline"]
    out = torch.empty(n_bits, dtype=torch.complex64, device=dev)
    if n_bits == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = kernels.lib().mix_packed_launch(
            words.data_ptr(), part2_table(lo_rate, str(dev)).data_ptr(),
            out.data_ptr(), n_bits, c1, ph0, _sign_mask(i_tbl),
            _sign_mask(q_tbl), stream)
    kernels.check("mix_packed", err)
    kernels.launched("mix_packed")
    return out
