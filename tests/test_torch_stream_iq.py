"""The port's I/Q, live and rtl_tcp sources against the JAX reference's.

``tpu_gnss_torch.io.stream`` keeps its own copies of ``IQFileSource``,
``RtlTcpSource``, ``SynthSource``, ``_FollowReader``,
``FollowSource1Bit`` and ``FollowIQSource`` (tpu_gnss/io/stream.py:
143-578) and the loaders' 8-bit I/Q functions.  The same files and
seeds go through both packages and must give equal blocks; the follow
reader's growth, stall-against-done, skip-ahead, file-creation and FIFO
semantics and the rtl_tcp protocol (against the fake server of
tests/test_stream.py) are checked on the port's copy.
"""

import os
import threading
import time

import numpy as np
import pytest

from tests.test_stream import _rtltcp_server
from tpu_gnss.config import ReceiverConfig
from tpu_gnss.io import loaders as jld
from tpu_gnss.io import stream as jst
from tpu_gnss.signal import synth as jsy
from tpu_gnss_torch.io import loaders as tld
from tpu_gnss_torch.io import stream as tst
from tpu_gnss_torch.signal import synth as tsy
from tests.torch_threads import one_torch_thread  # noqa: F401

SMALL = ReceiverConfig(fs=2.048e6, fc=0.512e6, max_fo=5000.0, fft_len=4096)


def _iq_file(tmp_path, signed: bool, n: int = 5000 + 3):
    rng = np.random.default_rng(7 + signed)
    raw = (rng.integers(-100, 100, 2 * n).astype(np.int8) if signed
           else rng.integers(0, 256, 2 * n).astype(np.uint8))
    path = tmp_path / ("cap_iq8.bin" if signed else "cap_iqu8.bin")
    raw.tofile(path)
    return str(path), raw


@pytest.mark.parametrize("signed", [True, False], ids=["int8", "uint8"])
@pytest.mark.parametrize("remove_dc", [True, False], ids=["dc", "no-dc"])
def test_iq_file_source_matches_jax(tmp_path, signed, remove_dc):
    """``blocks`` and ``raw_blocks`` (final partial chunk included) and
    the whole-file loaders equal the reference's."""
    path, raw = _iq_file(tmp_path, signed)
    dtype = "int8" if signed else "uint8"
    for name in ("blocks", "raw_blocks"):
        want = list(getattr(jst.IQFileSource(path, SMALL.fs, dtype,
                                             remove_dc), name)(2048))
        got = list(getattr(tst.IQFileSource(path, SMALL.fs, dtype,
                                            remove_dc), name)(2048))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    load = "load_int8_iq" if signed else "load_uint8_iq"
    for count in (None, 1234):
        np.testing.assert_array_equal(
            getattr(tld, load)(path, count, remove_dc),
            getattr(jld, load)(path, count, remove_dc))
    np.testing.assert_array_equal(
        tld.iq8_to_complex(raw[:4000], signed, remove_dc),
        jld.iq8_to_complex(raw[:4000], signed, remove_dc))


def test_prefetcher_rawiq_mode(tmp_path):
    """The prefetcher's "rawiq" mode yields the capture's own bytes."""
    path, _ = _iq_file(tmp_path, True)
    want = list(jst.IQFileSource(path, SMALL.fs).raw_blocks(2048))
    pf = tst.Prefetcher(tst.IQFileSource(path, SMALL.fs), 2048,
                        mode="rawiq")
    got = list(pf)
    pf.stop()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_synth_source_matches_jax():
    svs = [(9, 500.0, 300.0), (17, -1200.0, 10.0)]
    want = jst.SynthSource([jsy.SvSignal(prn=p, doppler_hz=d,
                                         code_phase_chips=c)
                            for p, d, c in svs], SMALL.fs, noise_std=0.5,
                           seed=3).blocks(4096)
    got = tst.SynthSource([tsy.SvSignal(prn=p, doppler_hz=d,
                                        code_phase_chips=c)
                           for p, d, c in svs], SMALL.fs, noise_std=0.5,
                          seed=3).blocks(4096)
    for _ in range(3):
        np.testing.assert_array_equal(next(got), next(want))


def test_follow_sources_match_jax_on_a_done_file(tmp_path):
    """On a complete (``.done``) file, the follow sources equal the
    reference's follow sources and the port's batch sources."""
    bits = np.random.default_rng(1).integers(0, 2, 4096 * 4).astype(np.uint8)
    path = tmp_path / "cap.bin"
    path.write_bytes(tld.pack_1bit(bits))
    (tmp_path / "cap.bin.done").touch()
    for name in ("blocks", "bit_blocks", "packed_blocks"):
        a = list(getattr(tst.FollowSource1Bit(str(path), SMALL), name)(4096))
        b = list(getattr(jst.FollowSource1Bit(str(path), SMALL), name)(4096))
        c = list(getattr(tst.FileSource1Bit(str(path), SMALL), name)(4096))
        assert len(a) == len(b) == len(c) == 4
        for x, y, z in zip(a, b, c):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)
    ipath, _ = _iq_file(tmp_path, False, n=3 * 2048)
    open(ipath + ".done", "w").close()
    for name in ("blocks", "raw_blocks"):
        a = list(getattr(tst.FollowIQSource(ipath, SMALL.fs, "uint8"),
                         name)(2048))
        b = list(getattr(jst.FollowIQSource(ipath, SMALL.fs, "uint8"),
                         name)(2048))
        assert len(a) == len(b) == 3
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_follow_reader_tracks_growing_file(tmp_path):
    """Chunks are served as the writer appends, never past the frontier;
    a ``.done`` sidecar ends the stream cleanly."""
    path = tmp_path / "grow.bin"
    path.write_bytes(b"")
    total, chunk = 64 * 40, 64
    frontier = {"n": 0}

    def writer():
        with open(path, "ab") as f:
            for i in range(total // 32):
                f.write(bytes([i % 251] * 32))
                f.flush()
                frontier["n"] += 32
                time.sleep(0.002)
        (tmp_path / "grow.bin.done").touch()

    rd = tst._FollowReader(str(path), stall_timeout_s=5.0, poll_s=0.005)
    t = threading.Thread(target=writer)
    t.start()
    got = []
    for raw in rd.chunks(chunk):
        assert rd.pos <= frontier["n"] + 32
        got.append(raw)
    t.join()
    assert not rd.stalled and rd.waits > 0
    data = b"".join(got)
    assert len(data) == total and data == path.read_bytes()[:total]


def test_follow_reader_stall_done_skip_and_creation(tmp_path):
    """No growth and no ``.done`` -> ``stalled``; fall-behind beyond the
    lag limit skips whole chunks; a file that appears late is waited for,
    and one that never appears stalls."""
    path = tmp_path / "s.bin"
    path.write_bytes(bytes(100))
    rd = tst._FollowReader(str(path), stall_timeout_s=0.05, poll_s=0.01)
    assert len(list(rd.chunks(64))) == 1 and rd.stalled

    path = tmp_path / "f.bin"
    path.write_bytes(bytes(range(256)) * 8)
    (tmp_path / "f.bin.done").touch()
    rd = tst._FollowReader(str(path), max_lag_bytes_limit=256)
    got = list(rd.chunks(128))
    want = jst._FollowReader(str(path), max_lag_bytes_limit=256)
    assert got == list(want.chunks(128))
    assert rd.skipped_bytes == want.skipped_bytes > 0
    assert rd.skipped_bytes + sum(len(g) for g in got) == 2048
    assert got[0] == path.read_bytes()[rd.skipped_bytes:
                                       rd.skipped_bytes + 128]

    late = tmp_path / "notyet.bin"

    def writer():
        time.sleep(0.1)
        late.write_bytes(bytes(256))
        (tmp_path / "notyet.bin.done").touch()

    rd = tst._FollowReader(str(late), stall_timeout_s=5.0, poll_s=0.01)
    t = threading.Thread(target=writer)
    t.start()
    assert len(list(rd.chunks(128))) == 2
    t.join()
    assert not rd.stalled
    rd = tst._FollowReader(str(tmp_path / "never.bin"),
                           stall_timeout_s=0.05, poll_s=0.01)
    assert list(rd.chunks(64)) == [] and rd.stalled


def test_follow_source_reads_fifo(tmp_path):
    """A named pipe is drained with the pipe as flow control, ending on
    the writer's close; a writer that hangs open stalls out."""
    fifo = tmp_path / "pipe.bin"
    os.mkfifo(fifo)
    bits = np.random.default_rng(3).integers(0, 2, 4096 * 4).astype(np.uint8)
    payload = tld.pack_1bit(bits)

    def writer():
        with open(fifo, "wb") as f:
            for i in range(0, len(payload), 128):
                f.write(payload[i: i + 128])

    t = threading.Thread(target=writer)
    t.start()
    src = tst.FollowSource1Bit(str(fifo), SMALL)
    got = list(src.bit_blocks(4096))
    t.join()
    assert len(got) == 4 and not src.stalled
    np.testing.assert_array_equal(np.concatenate(got), bits)

    fifo2 = tmp_path / "pipe2.bin"
    os.mkfifo(fifo2)
    hold = threading.Event()

    def hung_writer():
        fd = os.open(fifo2, os.O_WRONLY)
        os.write(fd, b"\xAA" * 512)
        hold.wait(timeout=30)
        os.close(fd)

    th = threading.Thread(target=hung_writer, daemon=True)
    th.start()
    rd = tst._FollowReader(str(fifo2), stall_timeout_s=0.3, poll_s=0.02)
    got = list(rd.chunks(512))
    hold.set()
    th.join(timeout=5)
    assert got == [b"\xAA" * 512] and rd.stalled


def test_rtltcp_source_handshake_and_blocks():
    """The rtl_tcp handshake (rate, frequency, gain and ppm commands,
    big-endian, negative values as two's complement), then the server's
    exact bytes through ``raw_blocks`` and the reference's centering
    through ``blocks``."""
    raw = np.random.default_rng(4).integers(0, 256, 8192, dtype=np.uint8)
    port, t, cmds = _rtltcp_server(raw.tobytes())
    src = tst.RtlTcpSource("127.0.0.1", port, 2.048e6, freq_hz=1575.42e6,
                           gain_db=28.4, ppm=-5, stall_timeout_s=5.0)
    assert src.tuner_type == 5 and src.tuner_gain_count == 29
    assert (src.dtype, src.remove_dc) == ("uint8", True)
    got = list(src.blocks(2048))
    t.join(timeout=10)
    assert len(got) == 2 and not src.stalled and src.error is None
    np.testing.assert_array_equal(
        got[0], jld.iq8_to_complex(raw[:4096], signed=False))
    d = dict(cmds)
    C = tst.RtlTcpSource
    assert d[C.CMD_RATE] == 2048000 and d[C.CMD_FREQ] == 1575420000
    assert d[C.CMD_GAIN_MODE] == 1 and d[C.CMD_GAIN] == 284
    assert d[C.CMD_PPM] == (-5) & 0xFFFFFFFF

    port, t, _ = _rtltcp_server(raw.tobytes())
    src = tst.RtlTcpSource("127.0.0.1", port, 2.048e6, stall_timeout_s=5.0)
    got = list(src.raw_blocks(2048))
    t.join(timeout=10)
    assert b"".join(g.tobytes() for g in got) == raw.tobytes()


def test_rtltcp_rejects_non_rtl_server_and_reports_stall():
    port, t, _ = _rtltcp_server(b"", greeting=b"HTTP/1.1 400\r\n\r\n")
    with pytest.raises(ValueError, match="RTL0"):
        tst.RtlTcpSource("127.0.0.1", port, 2.048e6)
    t.join(timeout=10)
    raw = np.random.default_rng(5).integers(0, 256, 4096, dtype=np.uint8)
    port, t, _ = _rtltcp_server(raw.tobytes(), stall_after=3000)
    src = tst.RtlTcpSource("127.0.0.1", port, 2.048e6, stall_timeout_s=0.5)
    assert list(src.raw_blocks(2048)) == [] and src.stalled
