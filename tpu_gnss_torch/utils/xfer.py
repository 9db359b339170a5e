# Copied from tpu_gnss/utils/xfer.py:1-267.  The host halves (the
# quantizers, the 256-entry byte LUTs, _pack_nibbles, _i2_code and
# _I2_RMS_DIV) are the reference's numpy code; the device halves
# (_combine_dequant, _unpack_iq4, _unpack_iq2, _deinterleave_iq8, _split)
# are torch ops on the device the caller names, and each upload takes it.
"""Host<->device links for complex baseband.

What crosses to the device is the small dtype, and the dequantization
runs there (float32 arithmetic, then complex64):

* ``to_device_complex_i8``: int8 planes, 2 B/sample;
* ``to_device_complex_i4`` / ``to_device_iq4``: packed nibbles, 1 B;
* ``to_device_complex_i2`` / ``to_device_iq2``: 2-bit sign/magnitude
  codes, 0.5 B;
* ``to_device_iq8``: an 8-bit capture's own interleaved bytes, 2 B;
* ``to_device_complex``: exact complex64, 8 B.

A CPU device runs the same torch ops on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """Host array -> tensor on ``device`` in its own dtype."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:     # file bytes: torch wants owned memory
        a = a.copy()
    return torch.from_numpy(a).to(device)


def to_device_complex(x: np.ndarray, device) -> torch.Tensor:
    """Transfer a host complex (or real) array as complex64."""
    return _upload(np.asarray(x).astype(np.complex64, copy=False), device)


def _combine_dequant(re_i8: torch.Tensor, im_i8: torch.Tensor,
                     inv_scale: float) -> torch.Tensor:
    re = re_i8.to(torch.float32) * inv_scale
    im = im_i8.to(torch.float32) * inv_scale
    return torch.complex(re, im)


def to_device_complex_i8(x: np.ndarray, scale: float, device
                         ) -> torch.Tensor:
    """Quantized transfer: complex host array -> int8 planes -> device.

    4x less host->device traffic than complex64.  The dequantize
    (x ~= i8 / scale) runs on device, so amplitudes (and everything
    downstream: correlator powers, AGC, watchdog ratios) are preserved up
    to the quantization step 1/scale.  Callers pick ``scale`` so the step
    is far below the noise floor (e.g. ``127 / (6 * rms)``).
    """
    x = np.asarray(x)
    q = lambda a: np.clip(np.rint(a * scale), -127, 127).astype(np.int8)
    return _combine_dequant(_upload(q(x.real), device),
                            _upload(q(x.imag), device),
                            float(np.float32(1.0 / scale)))


def _remove_dc(re: torch.Tensor, im: torch.Tensor) -> tuple:
    return re - re.mean(), im - im.mean()


def _unpack_iq4(packed: torch.Tensor, inv_scale: float,
                remove_dc: bool) -> torch.Tensor:
    """Packed int4 I/Q bytes (I = low nibble, Q = high) -> complex64.
    The sign extension stays in int32."""
    b = packed.to(torch.int32)
    lo = b & 0xF
    lo = lo - torch.where(lo >= 8, 16, 0).to(torch.int32)
    hi = (b >> 4) & 0xF
    hi = hi - torch.where(hi >= 8, 16, 0).to(torch.int32)
    re = lo.to(torch.float32) * inv_scale
    im = hi.to(torch.float32) * inv_scale
    if remove_dc:
        re, im = _remove_dc(re, im)
    return torch.complex(re, im)


def _pack_nibbles(qi: np.ndarray, qq: np.ndarray) -> np.ndarray:
    """Two int8 arrays in [-7, 7] -> one uint8 array of packed nibbles."""
    return ((qi & 0xF) | ((qq & 0xF) << 4)).astype(np.uint8)


def to_device_complex_i4(x: np.ndarray, scale: float, device
                         ) -> torch.Tensor:
    """4-bit quantized transfer: 1 byte/sample, half of the int8 planes.

    GPS signals are noise-dominated, so a ~3-sigma-scaled 4-bit uniform
    quantizer costs <0.1 dB of post-correlation SNR (vs ~2 dB for the
    1-bit capture format the reference itself uses everywhere).
    Callers pick ``scale`` ~ 7/(3*rms).
    """
    x = np.asarray(x)
    qi = np.clip(np.rint(x.real * scale), -7, 7).astype(np.int8)
    qq = np.clip(np.rint(x.imag * scale), -7, 7).astype(np.int8)
    return _unpack_iq4(_upload(_pack_nibbles(qi, qq), device),
                       float(np.float32(1.0 / scale)), False)


def to_device_iq4(raw: np.ndarray, signed: bool, remove_dc: bool = True,
                  *, device) -> torch.Tensor:
    """8-bit capture bytes requantized to packed int4 for the link.

    Same output contract as :func:`to_device_iq8` (complex64 baseband,
    device-side DC removal) at half the transfer size; amplitudes are
    preserved up to the 4-bit step (scale is divided back out).

    The quantizer is a 256-entry byte lookup (every input byte maps to
    one nibble for a given scale), so host repacking costs three uint8
    passes instead of six float32 passes.
    """
    raw = np.asarray(raw)
    assert raw.dtype.itemsize == 1, (
        f"to_device_iq4 takes 8-bit capture bytes, got {raw.dtype}")
    head = raw[:65536].astype(np.float32)
    if not signed:
        head = head - 128.0
    rms = float(np.sqrt(np.mean(np.square(head))))
    scale = 7.0 / (3.0 * rms) if rms > 1e-12 else 1.0
    v = np.arange(256, dtype=np.uint8)
    v = (v.view(np.int8).astype(np.float32) if signed
         else v.astype(np.float32) - 128.0)
    q = (np.clip(np.rint(v * scale), -7, 7).astype(np.int32)
         & 0xF).astype(np.uint8)
    u = raw.view(np.uint8) if raw.dtype != np.uint8 else raw
    packed = q[u[0::2]] | (q << 4)[u[1::2]]
    return _unpack_iq4(_upload(packed, device),
                       float(np.float32(1.0 / scale)), remove_dc)


#: 2-bit sign/magnitude dequant divisor: levels {±1, ±3}·(rms/_I2_RMS_DIV)
#: reproduce the input RMS (E[lvl²] = 0.68·1 + 0.32·9 = 3.56 at a ±1σ
#: threshold, sqrt = 1.887) — ONE constant shared by the byte-LUT and
#: host-complex quantizers so they can never drift apart.
_I2_RMS_DIV = 1.887


def _i2_code(v: np.ndarray, rms: float) -> np.ndarray:
    """2-bit sign/magnitude code: 2·negative + strong (levels ±1, ±3
    at a threshold of one RMS) — the single source of the mapping."""
    return (2 * (v < 0) + (np.abs(v) >= rms)).astype(np.uint8)


def _unpack_iq2(packed: torch.Tensor, step: float,
                remove_dc: bool) -> torch.Tensor:
    """Packed 2-bit sign/magnitude I/Q -> complex64, on device.

    Each byte holds FOUR components (I0,Q0,I1,Q1), two bits each:
    code = 2*negative + strong, i.e. levels [+1, +3, -1, -3] * step.
    """
    b = packed.to(torch.int64)
    levels = torch.tensor([1.0, 3.0, -1.0, -3.0], dtype=torch.float32,
                          device=packed.device) * step
    c = torch.stack([b & 3, (b >> 2) & 3, (b >> 4) & 3, (b >> 6) & 3],
                    dim=-1).reshape(-1)      # I0, Q0, I1, Q1, ...
    v = levels[c].reshape(-1, 2)
    re, im = v[:, 0], v[:, 1]
    if remove_dc:
        re, im = _remove_dc(re, im)
    return torch.complex(re, im)


def to_device_iq2(raw: np.ndarray, signed: bool, remove_dc: bool = True,
                  *, device) -> torch.Tensor:
    """8-bit capture bytes requantized to 2-bit sign/magnitude for the
    link: 4 components/byte = half a byte per complex sample — half of
    :func:`to_device_iq4`'s traffic, a quarter of the native int8 path.

    Sign + one magnitude bit with the threshold at the input RMS costs
    ~0.55 dB of post-correlation SNR (the classic 2-bit GNSS ADC).
    Dequantization maps codes to levels {±1, ±3}·step with step =
    rms/1.887 so the output RMS matches the input — AGC/watchdog power
    ratios downstream are preserved.  Host cost: one 256-entry LUT pass
    per component plus three ORs.
    """
    raw = np.asarray(raw)
    assert raw.dtype.itemsize == 1, (
        f"to_device_iq2 takes 8-bit capture bytes, got {raw.dtype}")
    assert len(raw) % 4 == 0, (
        "2-bit packing needs whole bytes of FOUR components: the "
        "complex sample count must be even")
    head = raw[:65536].astype(np.float32)
    if not signed:
        head = head - 128.0
    rms = float(np.sqrt(np.mean(np.square(head))))
    if rms <= 1e-12:
        rms = 1.0
    v = np.arange(256, dtype=np.uint8)
    v = (v.view(np.int8).astype(np.float32) if signed
         else v.astype(np.float32) - 128.0)
    code = _i2_code(v, rms)
    u = raw.view(np.uint8) if raw.dtype != np.uint8 else raw
    packed = (code[u[0::4]] | (code << 2)[u[1::4]]
              | (code << 4)[u[2::4]] | (code << 6)[u[3::4]])
    return _unpack_iq2(_upload(packed, device),
                       float(np.float32(rms / _I2_RMS_DIV)), remove_dc)


def to_device_complex_i2(x: np.ndarray, device) -> torch.Tensor:
    """2-bit sign/magnitude transfer of a host COMPLEX array: half a
    byte per sample (see :func:`to_device_iq2` for the quantizer)."""
    x = np.asarray(x)
    assert len(x) % 2 == 0, "2-bit packing needs an even sample count"
    comps = np.empty((len(x), 2), np.float32)
    comps[:, 0] = x.real
    comps[:, 1] = x.imag
    comps = comps.reshape(-1)
    rms = float(np.sqrt(np.mean(np.square(comps[:131072]))))
    if rms <= 1e-12:
        rms = 1.0
    c = _i2_code(comps, rms).reshape(-1, 4)
    packed = c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)
    return _unpack_iq2(_upload(packed, device),
                       float(np.float32(rms / _I2_RMS_DIV)), False)


def _deinterleave_iq8(raw: torch.Tensor, signed: bool,
                      remove_dc: bool) -> torch.Tensor:
    """Interleaved 8-bit I/Q bytes -> complex64 baseband, on device.

    ``raw`` is the capture file's own bytes (int8 HackRF / uint8 rtl-sdr
    order, reference: proc_hackrf_bin_for_gps.m:10-16,
    proc_rtl_bin_for_gps.m:20-27); deinterleave, recenter, and the
    per-chunk DC removal (reference: gps_8bit_proc.m:23-26) all run on
    device so the host touches nothing but the file read.
    """
    v = raw.to(torch.float32)
    if not signed:
        v = v - 128.0
    v = v.reshape(-1, 2)
    re, im = v[:, 0], v[:, 1]
    if remove_dc:
        re, im = _remove_dc(re, im)
    return torch.complex(re, im)


def to_device_iq8(raw: np.ndarray, signed: bool, remove_dc: bool = True,
                  *, device) -> torch.Tensor:
    """Upload native interleaved 8-bit I/Q bytes; convert on device.

    One transfer of the capture's own bytes (2 bytes/sample — no host
    quantize/deinterleave pass at all).  ``raw`` must already be viewed
    as the capture's dtype (int8 or uint8) so the upload preserves
    values exactly.
    """
    raw = np.asarray(raw)
    assert raw.dtype in (np.int8, np.uint8)
    return _deinterleave_iq8(_upload(raw, device), signed, remove_dc)


def _split(c: torch.Tensor):
    return c.real.to(torch.float32), c.imag.to(torch.float32)


def from_device_complex(c: torch.Tensor) -> np.ndarray:
    """Fetch a device complex tensor to host (complex128, as the
    reference returns it)."""
    re, im = _split(c)
    return re.cpu().numpy() + 1j * im.cpu().numpy()
