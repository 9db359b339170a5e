"""The port's receiver CLI, run in-process on a short 1-bit capture.

Mirrors tests/test_run_receiver_cli.py::test_preset_flag_parses and the
dashboard part of its smoke test, with the device stages on the CPU.
"""

from tpu_gnss_torch.cli import run_receiver
from tpu_gnss_torch.signal import scene


def test_cli_runs_on_a_short_capture(tmp_path, capsys):
    iq, _, _ = scene.build_scene(duration=2.0, n_sv=4, seed=5)
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
