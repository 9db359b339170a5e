"""The port's receiver CLI, run in-process on short captures.

Mirrors tests/test_run_receiver_cli.py::test_preset_flag_parses and the
dashboard part of its smoke test, and tests/test_stream.py:1107-1116 (the
rtltcp URL check), with the device stages on the CPU.  Both CLIs' ``main``
print the same report on one capture; the warm-start flags read and
write checkpoints the JAX package reads and writes.
"""

import re

import numpy as np
import pytest
import torch

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
    # one dashboard bar per started channel, none lost in 2 s: tracking,
    # no subframe yet, with its C/N0
    assert out.count("[track ") == 4 and out.count("dBHz]") == 4, out
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
    assert "acquired 4 SVs" in out and out.count("[track ") == 4, out
    assert "IQ log (4 channels)" in out and "0 NMEA sentences" in out
    assert "prompt constellation:" in out
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


@pytest.mark.parametrize("flag", ["--mesh-devices=4"])
def test_cli_rejects_unported_flags(tmp_path, flag, capsys, baseband):
    """``--mesh-devices`` runs the receiver on a mesh: 2 and 4 CPU entries
    print the single-device run's report on a short 1-bit capture (the
    JAX CLI's ``--mesh-devices`` cannot be the oracle here: on a 1-bit
    capture its sharded tracker refuses the chunk, which sits on one
    device).  On a machine without a card, a mesh of cards raises."""
    cap = tmp_path / "cap.bin"
    scene.write_1bit_capture(baseband, scene.FS / 4, scene.FS, cap)
    argv = [str(cap), str(scene.FS / 4), str(scene.FS), "5000", "--fft-len",
            "4096", "--threshold", "17", "--channels", "8", "--device", "cpu"]
    assert run_receiver.main(argv) == 0
    want = capsys.readouterr().out
    for mesh_flag in (flag, "--mesh-devices=2"):
        assert run_receiver.main(argv + [mesh_flag]) == 0
        got = capsys.readouterr().out
        assert "acquired 4 SVs" in got and got.count("[track ") == 4, got
        assert_same_report(_until_report(got), _until_report(want))
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="cards"):
            run_receiver.main(argv + ["--mesh-devices", "2", "--device",
                                      "cuda"])


# ---------------------------------------------------------------------------
# warm start, checkpoints, and the report against the JAX CLI
# ---------------------------------------------------------------------------

WARM_TOW = scene.T_OE + 90.0


@pytest.fixture(scope="module")
def warm_capture(tmp_path_factory):
    """3.5 s of the 6-SV e2e scene as a 1-bit capture, and a checkpoint
    the JAX package wrote: the scene's ephemerides, the almanac they imply
    and the last fix at the scene's position (as
    tests/test_run_receiver_cli.py:94)."""
    from tpu_gnss.nav.almanac import Almanac
    from tpu_gnss.nav.ephemeris import Ephemeris
    from tpu_gnss.utils.checkpoint import save_state
    d = tmp_path_factory.mktemp("torch_cli_warm")
    iq, ephs, rx = scene.build_scene(duration=3.5)
    cap = d / "cap.bin"
    scene.write_1bit_capture(iq, scene.FS / 4, scene.FS, cap)
    jeph = {scene.eph_prn(k): Ephemeris(**{
        f: getattr(e, f) for f in e.__dataclass_fields__})
        for k, e in enumerate(ephs)}
    ckpt = d / "prev.npz"
    save_state(str(ckpt), ephemerides=jeph,
               almanac={p: Almanac.from_ephemeris(p, e)
                        for p, e in jeph.items()},
               meta=dict(last_fix=dict(ecef=list(map(float, rx)),
                                       tow=WARM_TOW)))
    return cap, ckpt, rx


def _argv(cap, *extra):
    fc = scene.FS / 4
    return [str(cap), str(fc), str(scene.FS), "5000", "--fft-len", "4096",
            "--threshold", "17", "--channels", "6", *extra]


def _until_report(out: str) -> list:
    """stdout up to the timing report (its rows are a stage or span name,
    then ``n=``)."""
    lines = out.splitlines()
    end = next(i for i, ln in enumerate(lines) if _ROW.match(ln))
    return lines[:end]


_ROW = re.compile(r"^[a-z_.]+ +n= *\d+ total=")


_NUM = re.compile(r"[-+]?\d+(?:\.\d+)?")


def assert_same_report(got: list, want: list, noise_bars=()) -> None:
    """Line by line: the text equal once numbers are masked, every integer
    equal, every decimal within 3 units of its last printed digit plus
    1e-3 of its value (the fix rows' float32 pipelines differ by
    centimetres, e.g. alt 49.55 against 49.53 m).  The channel bars of the
    PRNs in ``noise_bars`` (seeded on noise, so their rssi and C/N0 follow
    the noise) are held to their PRN and status word only."""
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        head = g.split("|")[0].split()
        if head[:1] == ["PRN"] and "|" in g and int(head[1]) in noise_bars:
            assert (g.split("|")[0], g.split("[")[-1].split()[0]) == \
                (w.split("|")[0], w.split("[")[-1].split()[0]), (g, w)
            continue
        assert _NUM.sub("#", g) == _NUM.sub("#", w), (g, w)
        for a, b in zip(_NUM.findall(g), _NUM.findall(w)):
            if "." not in b:
                assert a == b, (g, w)
                continue
            unit = 10.0 ** -len(b.split(".")[1])
            assert abs(float(a) - float(b)) <= 3 * unit + 1e-3 * abs(
                float(b)), (g, w)


def test_cli_report_matches_jax(warm_capture, tmp_path, capsys):
    """Both CLIs' ``main`` on one capture with ``--warm-start``,
    ``--checkpoint`` and ``--iq-log``: the same stdout up to the timing
    report — detections, channel bars, fixes with the DMS and GPS
    day-time pages, the constellation, the saved-state line — numbers
    within :func:`assert_same_report`'s bounds."""
    from tpu_gnss.cli import run_receiver as jax_cli
    from tpu_gnss.utils.checkpoint import load_state
    cap, ckpt, rx = warm_capture
    out_ck, iq_log = tmp_path / "next.npz", tmp_path / "iq.npz"
    argv = _argv(cap, "--warm-start", str(ckpt), "--checkpoint", str(out_ck),
                 "--iq-log", str(iq_log))
    assert run_receiver.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    mine = load_state(str(out_ck))          # the JAX package reads it
    assert jax_cli.main(argv) == 0
    want = capsys.readouterr().out
    assert_same_report(_until_report(got), _until_report(want))
    assert "directed search: almanac predicts PRNs" in got
    assert "fixes (n_sats, iters, t_bias, lat, lon, alt):" in got, got
    assert "week 900 " in got and "prompt constellation:" in got
    assert "state saved to" in got and "almanac entries" in got
    last = mine["meta"]["last_fix"]
    assert np.linalg.norm(np.array(last["ecef"]) - np.array(rx)) < 150.0
    assert sorted(mine["ephemerides"]) == [2, 3, 4, 5, 6, 7]
    assert sorted(mine["almanac"]) == [2, 3, 4, 5, 6, 7]
    assert [d["prn"] for d in mine["detections"]] == \
        [d["prn"] for d in load_state(str(out_ck))["detections"]]


@pytest.mark.parametrize("flags", [["--no-directed"],
                                   ["--tow", str(WARM_TOW + 7200.0)]])
def test_cli_warm_start_flags(warm_capture, tmp_path, capsys, flags):
    """``--no-directed`` skips the prediction; ``--tow`` sets its time (the
    printed set is the JAX package's ``visible_prns`` at that time)."""
    from tpu_gnss.nav.almanac import visible_prns
    from tpu_gnss.utils.checkpoint import load_state
    cap, ckpt, _ = warm_capture
    out_ck = tmp_path / "next.npz"
    assert run_receiver.main(_argv(cap, "--duration", "1", "--warm-start",
                                   str(ckpt), "--checkpoint", str(out_ck),
                                   "--device", "cpu", *flags)) == 0
    out = capsys.readouterr().out
    assert "warm start: ephemerides for PRNs [2, 3, 4, 5, 6, 7]" in out
    back = load_state(str(out_ck))
    assert "last_fix" not in back["meta"] and back["meta"]["fs"] == scene.FS
    if flags == ["--no-directed"]:
        assert "directed search" not in out and "almanac present" not in out
        return
    st = load_state(str(ckpt))
    pred = visible_prns(st["almanac"], st["meta"]["last_fix"]["ecef"],
                        float(flags[1]), mask_deg=5.0, margin_s=1800.0)
    if pred and set(pred) < set(range(1, 33)):
        assert f"directed search: almanac predicts PRNs {pred} " in out
    else:
        assert "almanac present but" in out


def test_cli_missing_warm_start_file(tmp_path, warm_capture):
    cap, _, _ = warm_capture
    with pytest.raises(FileNotFoundError):
        run_receiver.main(_argv(cap, "--warm-start",
                                str(tmp_path / "none.npz"), "--device",
                                "cpu"))


# ---------------------------------------------------------------------------
# slow: the reference's warm-start CLI oracles, both CLIs on one capture
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_run_receiver_cli_directed_warm_start(tmp_path, capsys):
    """tests/test_run_receiver_cli.py:94: ``--warm-start`` with a
    checkpoint holding almanac + last fix prints and applies the directed
    search on 8 s of capture; both CLIs print the same report."""
    from tpu_gnss.cli import run_receiver as jax_cli
    from tpu_gnss.nav.almanac import Almanac
    from tpu_gnss.utils.checkpoint import save_state
    from tests.test_e2e import build_scene
    iq, ephs, rx = build_scene(duration=8.0)
    cap = tmp_path / "cap.bin"
    scene.write_1bit_capture(iq, scene.FS / 4, scene.FS, cap)
    ckpt = tmp_path / "prev.npz"
    save_state(str(ckpt),
               ephemerides={k + 2: e for k, e in enumerate(ephs)},
               almanac={k + 2: Almanac.from_ephemeris(k + 2, e)
                        for k, e in enumerate(ephs)},
               meta=dict(last_fix=dict(ecef=list(map(float, rx)),
                                       tow=302400.0 + 90.0)))
    argv = [str(cap), str(scene.FS / 4), str(scene.FS), "5000",
            "--fft-len", "4096", "--threshold", "17", "--warm-start",
            str(ckpt)]
    assert run_receiver.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert jax_cli.main(argv) == 0
    want = capsys.readouterr().out
    assert "directed search: almanac predicts PRNs" in got
    assert "acquired" in got and "fixes (" in got
    # PRNs absent from the scene (2-7) that re-acquisition seeded on noise
    assert_same_report(_until_report(got), _until_report(want),
                       noise_bars=set(range(1, 33)) - set(range(2, 8)))


@pytest.mark.slow
def test_cli_rtltcp_warm_start_full_loop(tmp_path, capsys):
    """tests/test_run_receiver_cli.py:132 through both CLIs: a previous
    session's checkpoint directs the warm start, the capture arrives over
    rtl_tcp (the fake server of tests/test_stream.py) with a 50 kHz
    oscillator offset, fixes stream live into the NMEA file, and the next
    checkpoint carries the aged fix and the almanac.  Both CLIs make the
    same prediction and the same number of live fixes, and their tracks
    parse back to the truth."""
    import time

    from tests.test_e2e import T_OE, TRUTH_LLA, build_scene
    from tests.test_stream import _rtltcp_server
    from tpu_gnss.cli import nmea as nmea_mod
    from tpu_gnss.cli import run_receiver as jax_cli
    from tpu_gnss.nav.almanac import Almanac
    from tpu_gnss.signal import rfchannel
    from tpu_gnss.utils.checkpoint import load_state, save_state

    iq, ephs, rx = build_scene(duration=26.0, noise=0.5, leap_s=18)
    rxed = rfchannel.apply_channel(iq, scene.FS, freq_offset_hz=50e3,
                                   delay_samples=99.0, gain=1.1)
    s = 100.0 / max(np.abs(rxed.real).max(), np.abs(rxed.imag).max())
    raw = np.empty(2 * len(rxed), np.uint8)
    raw[0::2] = np.clip(np.rint(rxed.real * s), -127, 127) + 128
    raw[1::2] = np.clip(np.rint(rxed.imag * s), -127, 127) + 128
    ckpt = tmp_path / "prev.npz"
    save_state(str(ckpt),
               ephemerides={k + 2: e for k, e in enumerate(ephs)},
               almanac={k + 2: Almanac.from_ephemeris(k + 2, e)
                        for k, e in enumerate(ephs)},
               meta=dict(last_fix=dict(ecef=list(np.asarray(rx)),
                                       tow=float(T_OE + 60.0),
                                       wall=time.time())))
    outs = {}
    for name, main, extra in (("port", run_receiver.main,
                               ["--device", "cpu"]),
                              ("jax", jax_cli.main, [])):
        port, t, _ = _rtltcp_server(raw.tobytes(), send_timeout_s=600.0)
        nmea_path = tmp_path / f"{name}.nmea"
        out_ckpt = tmp_path / f"{name}_next.npz"
        rc = main([f"rtltcp://127.0.0.1:{port}", str(scene.FS / 4),
                   str(scene.FS), "100000", "--fft-len", "4096",
                   "--threshold", "17", "--warm-start", str(ckpt),
                   "--tow", str(T_OE + 90.0), "--nmea-out", str(nmea_path),
                   "--checkpoint", str(out_ckpt), "--stall-timeout", "30",
                   *extra])
        t.join(timeout=10)
        out = capsys.readouterr().out
        assert rc == 0 and "rtl_tcp: connected" in out
        st = nmea_mod.NmeaState()
        for line in nmea_mod.read_sentences(str(nmea_path)):
            assert nmea_mod.checksum_ok(line), line
            st.feed(line)
        assert abs(st.lat - TRUTH_LLA[0]) < 0.01
        assert abs(st.lon - TRUTH_LLA[1]) < 0.01
        nxt = load_state(str(out_ckpt))
        assert "wall" in nxt["meta"]["last_fix"] and nxt.get("almanac")
        outs[name] = out
    pick = lambda out: [ln for ln in out.splitlines()
                        if ln.startswith(("warm start:", "directed search",
                                          "almanac present"))]
    assert pick(outs["port"]) == pick(outs["jax"]) != []
    n_fix = lambda out: out.count("[fix t=")
    assert n_fix(outs["port"]) == n_fix(outs["jax"]) > 0
