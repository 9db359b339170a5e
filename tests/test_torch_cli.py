"""The port's receiver CLI, run in-process on short captures.

Mirrors tests/test_run_receiver_cli.py::test_preset_flag_parses and the
dashboard part of its smoke test, and tests/test_stream.py:1107-1116 (the
rtltcp URL check), with the device stages on the CPU.
"""

import pytest

from tpu_gnss_torch.cli import run_receiver
from tpu_gnss_torch.signal import scene
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def baseband():
    """2 s of the e2e scene recipe, 4 SVs."""
    return scene.build_scene(duration=2.0, n_sv=4, seed=5)[0]


def test_cli_runs_on_a_short_capture(tmp_path, capsys, baseband):
    iq = baseband
    fc = scene.FS / 4
    cap = tmp_path / "cap.bin"
    scene.write_1bit_capture(iq, fc, scene.FS, cap)
    rc = run_receiver.main([
        str(cap), str(fc), str(scene.FS), "5000", "--fft-len", "4096",
        "--threshold", "17", "--channels", "6", "--duration", "2",
        "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "acquired 4 SVs" in out
    # one dashboard line per started channel, none lost in 2 s
    assert out.count("[track]") == 4, out
    # 2 s of signal holds no complete subframe: no fix, said cleanly
    assert "no position fix" in out


def test_cli_missing_file_and_preset(tmp_path, capsys):
    rc = run_receiver.main([str(tmp_path / "nope.bin"),
                            "--preset", "synthetic", "--device", "cpu"])
    assert rc == 2
    assert "not found" in capsys.readouterr().err


def test_cli_iq8_capture_with_link_nmea_and_iq_log(tmp_path, capsys,
                                                  baseband):
    """An int8 I/Q capture through ``--format iq8 --link int4``, with the
    NMEA and I/Q-log outputs asked for."""
    import numpy as np
    iq = baseband
    scale = 100.0 / max(np.abs(iq.real).max(), np.abs(iq.imag).max())
    raw = np.empty(2 * len(iq), np.int8)
    raw[0::2] = np.clip(np.rint(iq.real * scale), -127, 127)
    raw[1::2] = np.clip(np.rint(iq.imag * scale), -127, 127)
    cap = tmp_path / "cap_iq8.bin"
    raw.tofile(cap)
    log, nmea = tmp_path / "iq.npz", tmp_path / "fix.nmea"
    rc = run_receiver.main([
        str(cap), "0", str(scene.FS), "5000", "--format", "iq8", "--link",
        "int4", "--fft-len", "4096", "--threshold", "17", "--channels", "6",
        "--iq-log", str(log), "--nmea-out", str(nmea), "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "acquired 4 SVs" in out and out.count("[track]") == 4, out
    assert "IQ log (4 channels)" in out and "0 NMEA sentences" in out
    assert len(np.load(log).files) == 12 and nmea.read_text() == ""


def test_cli_follow_on_a_finished_capture(tmp_path, capsys, baseband):
    """``--follow`` on a capture whose ``.done`` sidecar exists drains it
    and reports a clean end of stream."""
    iq = baseband
    fc = scene.FS / 4
    cap = tmp_path / "cap.bin"
    scene.write_1bit_capture(iq, fc, scene.FS, cap)
    (tmp_path / "cap.bin.done").touch()
    rc = run_receiver.main([
        str(cap), str(fc), str(scene.FS), "5000", "--fft-len", "4096",
        "--threshold", "17", "--channels", "6", "--follow",
        "--stall-timeout", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "follow ended: end of stream" in out and "acquired 4 SVs" in out


def test_cli_rtltcp_url_validation(capsys):
    for url in ("rtltcp://myhost", "rtltcp://myhost:abc"):
        assert run_receiver.main([url, "--device", "cpu"]) == 2
        assert "needs host:port" in capsys.readouterr().err


@pytest.mark.parametrize("flag", ["--checkpoint=x.npz", "--warm-start=x.npz",
                                  "--no-directed", "--tow=1",
                                  "--mesh-devices=4"])
def test_cli_rejects_unported_flags(tmp_path, flag, capsys):
    """Warm start and the device mesh are not ported: argparse refuses
    their flags instead of ignoring them."""
    with pytest.raises(SystemExit) as e:
        run_receiver.main([str(tmp_path / "cap.bin"), "--device", "cpu",
                           flag])
    assert e.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err
