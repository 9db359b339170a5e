"""The port's capture converters, its native helper library and the
``cli.convert`` tool, against the JAX package's.

Each ``convert_*`` of ``tpu_gnss_torch.io.loaders`` writes the reference
converter's file byte for byte, through the native path and through the
numpy fallback; ``tpu_gnss_torch.io.native`` is called directly too, so a
broken build fails here instead of hiding behind the fallback, and its
functions equal numpy.  The port builds its library from its own copy of
``sdrio.cpp`` into ``build/tpu_gnss_torch/``, never into the reference's
``tpu_gnss/native/``.
"""

import contextlib
import io
import os
import subprocess
import time

import numpy as np
import pytest
from scipy.io import wavfile

from tpu_gnss.io import loaders as ref
from tpu_gnss.io import native as ref_native
from tpu_gnss_torch.io import loaders, native
from tpu_gnss_torch.signal import synth
from tests.torch_threads import one_torch_thread  # noqa: F401

REF_NATIVE_DIR = os.path.join(os.path.dirname(ref.__file__), os.pardir,
                              "native")


@pytest.fixture(scope="module", autouse=True)
def reference_library_complete():
    """Wait until the reference's native library loads.

    The reference builds ``tpu_gnss/native/libsdrio.so`` with an unlocked
    ``make`` that writes the file in place, so a test process running
    beside another that is still building can load a half-written file
    (``OSError: invalid ELF header``).  ``_load`` keeps no failure, so a
    later call finds the finished file: retry every 0.5 s for up to 60 s,
    then raise what the last attempt raised.
    """
    deadline = time.monotonic() + 60.0
    while True:
        try:
            ref_native._load()
            return
        except (OSError, subprocess.CalledProcessError):
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.5)


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    """Seeded captures of every input format."""
    d = tmp_path_factory.mktemp("convert")
    rng = np.random.default_rng(21)
    n = 40000
    paths = dict(
        rtl=d / "rtl.bin", hackrf=d / "hackrf.bin", one=d / "one.bin",
        wav=d / "cap.wav")
    paths["rtl"].write_bytes((rng.normal(30, 18, 2 * n) + 135).clip(
        0, 255).astype(np.uint8).tobytes())
    paths["hackrf"].write_bytes(rng.normal(0, 25, 2 * n).clip(
        -127, 127).astype(np.int8).tobytes())
    paths["one"].write_bytes(loaders.pack_1bit(
        rng.integers(0, 2, 8 * 5003).astype(np.uint8)))
    wavfile.write(paths["wav"], 2800000, rng.normal(
        3, 900, (n, 2)).astype(np.int16))
    return {k: str(v) for k, v in paths.items()}


CONVERTERS = [
    ("convert_rtlsdr_to_1bit", "rtl", {}),
    ("convert_rtlsdr_to_1bit", "rtl", dict(mix=False)),
    ("convert_rtlsdr_to_1bit", "rtl", dict(fc=0.3e6, fs=2.4e6)),
    ("convert_hackrf_to_1bit", "hackrf", {}),
    ("convert_hackrf_to_1bit", "hackrf", dict(fc=2.046e6, fs=8.184e6)),
    ("convert_1bit_to_iq8", "one", {}),
    ("convert_1bit_to_iq8", "one", dict(gain=60)),
    ("convert_1bit_to_iq8", "one", dict(gain=300, block=1 << 12)),
    ("convert_wav_to_1bit", "wav", {}),
]


def _no_toolchain(*_):
    raise RuntimeError("no toolchain")


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("name,src,kw", CONVERTERS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CONVERTERS)])
def test_converter_bytes_identical(captures, tmp_path, monkeypatch, path,
                                   name, src, kw):
    if path == "numpy":
        monkeypatch.setattr(native, "_load", _no_toolchain)
        monkeypatch.setattr(ref_native, "_load", _no_toolchain)
    a, b = str(tmp_path / "torch.bin"), str(tmp_path / "jax.bin")
    ra = getattr(loaders, name)(captures[src], a, **kw)
    rb = getattr(ref, name)(captures[src], b, **kw)
    assert ra == rb
    with open(a, "rb") as fa, open(b, "rb") as fb:
        got, want = fa.read(), fb.read()
    assert len(got) > 0 and got == want


@pytest.mark.parametrize("is_signed,src,mix,fc_over_fs", [
    (False, "rtl", True, 0.62 / 2.8), (False, "rtl", False, 0.0),
    (True, "hackrf", True, 0.26), (True, "hackrf", True, 0.25)])
def test_native_convert_iq_to_1bit_identical(captures, tmp_path, is_signed,
                                             src, mix, fc_over_fs):
    """The port's library called directly against the reference's, and
    within trig rounding of the numpy arithmetic (tests/test_loaders.py:100)."""
    a, b = str(tmp_path / "torch.bin"), str(tmp_path / "jax.bin")
    kw = dict(is_signed=is_signed, mix=mix, fc_over_fs=fc_over_fs)
    assert (native.convert_iq_to_1bit(captures[src], a, **kw)
            == ref_native.convert_iq_to_1bit(captures[src], b, **kw) == 40000)
    got = np.fromfile(a, np.uint8)
    np.testing.assert_array_equal(got, np.fromfile(b, np.uint8))
    y = (loaders.load_int8_iq if is_signed else loaders.load_uint8_iq)(
        captures[src])
    bits = (loaders.iq_to_real_1bit(y, fc_over_fs, 1.0) if mix
            else loaders.real_to_1bit(np.real(y)))
    want = np.frombuffer(loaders.pack_1bit(bits), np.uint8)
    assert np.unpackbits(got ^ want).sum() / 40000 < 1e-4


@pytest.mark.parametrize("gain", [100, 127, 1])
def test_native_convert_1bit_to_iq8_identical(captures, tmp_path, gain):
    a, b = str(tmp_path / "torch.bin"), str(tmp_path / "jax.bin")
    assert (native.convert_1bit_to_iq8(captures["one"], a, gain)
            == ref_native.convert_1bit_to_iq8(captures["one"], b, gain))
    got = np.fromfile(a, np.int8)
    np.testing.assert_array_equal(got, np.fromfile(b, np.int8))
    s = 1 - 2 * loaders.load_1bit(captures["one"]).astype(np.int32)
    lo_i = np.tile([1, 0, -1, 0], len(s) // 4)
    lo_q = np.tile([0, 1, 0, -1], len(s) // 4)
    np.testing.assert_array_equal(got[0::2], s * lo_i * gain)
    np.testing.assert_array_equal(got[1::2], s * lo_q * gain)


def test_native_missing_input_raises(tmp_path):
    with pytest.raises(OSError):
        native.convert_1bit_to_iq8(str(tmp_path / "nope.bin"),
                                   str(tmp_path / "x.bin"), 100)
    with pytest.raises(OSError):
        loaders.convert_hackrf_to_1bit(str(tmp_path / "nope.bin"),
                                       str(tmp_path / "x.bin"))


def test_native_helpers_equal_numpy():
    rng = np.random.default_rng(8)
    raw = rng.integers(0, 256, size=4099).astype(np.uint8)
    bits = np.unpackbits(raw, bitorder="little")
    np.testing.assert_array_equal(native.unpack_1bit(raw), bits)
    np.testing.assert_array_equal(native.unpack_1bit_bipolar(raw),
                                  1 - 2 * bits.astype(np.int8))
    np.testing.assert_array_equal(native.pack_1bit(bits[:8 * 257 + 3]),
                                  np.packbits(bits[:8 * 257 + 3],
                                              bitorder="little"))
    from tpu_gnss_torch.config import NOTTINGHAM
    i_tbl, q_tbl = loaders.LO_TABLES["offline"]
    out_i, out_q = native.unpack_mix_1bit(raw, i_tbl, q_tbl,
                                          NOTTINGHAM.lo_rate)
    want = loaders.mix_1bit_block(bits, NOTTINGHAM)
    np.testing.assert_array_equal(out_i, want.real.astype(np.int8))
    np.testing.assert_array_equal(out_q, want.imag.astype(np.int8))
    i8 = rng.integers(-128, 128, size=2 * 1001).astype(np.int8)
    di, dq = native.deinterleave_int8(i8)
    np.testing.assert_array_equal(di, i8[0::2].astype(np.float32))
    np.testing.assert_array_equal(dq, i8[1::2].astype(np.float32))
    u8 = rng.integers(0, 256, size=2 * 1001).astype(np.uint8)
    ui, uq = native.deinterleave_uint8(u8)
    np.testing.assert_array_equal(
        ui + 1j * uq, loaders.iq8_to_complex(u8, signed=False,
                                             remove_dc=False))


def test_loaders_equal_reference(captures, tmp_path):
    """``load_1bit`` (with offsets), ``load_wav_iq``, ``real_to_1bit`` and
    ``iq_to_real_1bit`` equal the reference's."""
    for kw in (dict(), dict(count=1001), dict(count=64, offset_samples=80)):
        np.testing.assert_array_equal(loaders.load_1bit(captures["one"], **kw),
                                      ref.load_1bit(captures["one"], **kw))
    for kw in (dict(), dict(count=777)):
        y, fs = loaders.load_wav_iq(captures["wav"], **kw)
        yr, fsr = ref.load_wav_iq(captures["wav"], **kw)
        np.testing.assert_array_equal(y, yr)
        assert fs == fsr == 2.8e6
    y = np.array([1.0, -1.0, 0.5, -0.5, 0.0])
    np.testing.assert_array_equal(loaders.real_to_1bit(y), [0, 1, 0, 1, 0])
    iq = loaders.load_int8_iq(captures["hackrf"])
    np.testing.assert_array_equal(loaders.iq_to_real_1bit(iq, 2.6e6, 10e6),
                                  ref.iq_to_real_1bit(iq, 2.6e6, 10e6))


def test_convert_cli_roundtrip(tmp_path):
    """tests/test_cli.py:77 on the port, on a synthesized PRN-8 capture
    (8.184 Msps, IF 2.046 MHz): 1bit -> iq8 -> hackrf-to-1bit detects
    PRN 8; a missing input is a clean error (rc 2).  Every step writes
    the JAX CLI's file and prints its text."""
    from tpu_gnss.cli.convert import main as ref_main
    from tpu_gnss_torch.acquire.search import Searcher
    from tpu_gnss_torch.cli.convert import main
    from tpu_gnss_torch.config import ReceiverConfig
    bits, _ = synth.synth_1bit_if(num_bits=6)
    src = tmp_path / "sig.bin"
    src.write_bytes(loaders.pack_1bit(bits))
    for pkg, cmain in (("torch", main), ("jax", ref_main)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cmain(["1bit-to-iq8", str(src),
                          str(tmp_path / f"{pkg}_tx.bin"), "--fs",
                          "8184000"]) == 0
            assert cmain(["hackrf-to-1bit", str(tmp_path / f"{pkg}_tx.bin"),
                          str(tmp_path / f"{pkg}_back.bin"), "--fc",
                          "2046000", "--fs", "8184000"]) == 0
        assert "wrote" in buf.getvalue()
    for name in ("tx", "back"):
        assert ((tmp_path / f"torch_{name}.bin").read_bytes()
                == (tmp_path / f"jax_{name}.bin").read_bytes())
    cfg = ReceiverConfig(fs=8.184e6, fc=2.046e6, max_fo=5000.0)
    back = loaders.load_1bit(str(tmp_path / "torch_back.bin"),
                             count=cfg.fft_len)
    s = Searcher(cfg, device="cpu")
    assert any(d["prn"] == 8 for d in s.detections(s.acquire_bits(back)))
    with contextlib.redirect_stderr(io.StringIO()):
        assert main(["wav-to-1bit", str(tmp_path / "nope.wav"),
                     str(tmp_path / "x.bin")]) == 2


def test_library_built_outside_the_reference(tmp_path, monkeypatch):
    """A fresh build compiles the port's own copy of ``sdrio.cpp`` into
    the port's build folder: no command names the reference's
    ``tpu_gnss/native/``, and nothing of the port's lands there."""
    ref_src = os.path.join(REF_NATIVE_DIR, "sdrio.cpp")
    with open(native.SOURCE) as f:
        ours = f.read().split("\n", 1)
    with open(ref_src) as f:
        assert ours[0].startswith("// Copied from tpu_gnss/native/sdrio.cpp")
        assert ours[1] == f.read()
    assert native.library_path().parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "tpu_gnss_torch")
    commands = []
    real_run = subprocess.run

    def spy(cmd, *a, **kw):
        commands.append(cmd)
        return real_run(cmd, *a, **kw)

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(subprocess, "run", spy)
    out = native.build()
    assert out.parent == tmp_path / "build" and out.exists()
    assert len(commands) == 1 and str(native.SOURCE) in commands[0]
    ref_dir = os.path.realpath(REF_NATIVE_DIR)
    assert not any(ref_dir in os.path.realpath(str(c)) for c in commands[0])
    assert not [n for n in os.listdir(REF_NATIVE_DIR)
                if n.startswith("libsdrio_")]
    raw = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(native.unpack_1bit(raw),
                                  np.unpackbits(raw, bitorder="little"))
