"""The port's replay CLI (``tpu_gnss_torch.cli.playback``) against the
JAX package's (``tpu_gnss.cli.playback``).

Both CLIs' ``main`` run on the same arguments: ``plan`` prints the same
text and ``--grc`` writes the same flowgraph, ``loopback`` writes the
same 1-bit capture byte for byte, ``loopback --acquire --device cpu``
prints the same detection table row for row, and ``adsb-gen --verify``
writes the same waveform and prints the same text.  The reference's
checks of tests/test_playback.py run on the port.
"""

import numpy as np
import pytest
import torch

from tpu_gnss.cli import playback as ref
from tpu_gnss_torch.cli import playback
from tpu_gnss_torch.io import loaders
from tpu_gnss_torch.signal import synth
from tests.torch_threads import one_torch_thread  # noqa: F401

FS = 8.184e6
FC = 2.046e6


@pytest.fixture(scope="module")
def tx_file(tmp_path_factory):
    """tests/test_playback.py:22: the synthetic PRN-8 TX file as int8 I/Q."""
    d = tmp_path_factory.mktemp("playback")
    bits, _ = synth.synth_1bit_if(num_bits=6)
    one = d / "tx_1bit.bin"
    one.write_bytes(loaders.pack_1bit(bits))
    tx = d / "tx_iq8.bin"
    loaders.convert_1bit_to_iq8(str(one), str(tx), fs=FS)
    return tx


def run_main(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("argv", [
    ["plan", "gps_sig_tmp_for_hackrf_tx.bin", "--profile", "synthetic"],
    ["plan", "x.bin", "--profile", "wav"],
    ["plan", "adsb_for_hackrf.bin", "--profile", "adsb"],
    ["plan", "tx.bin", "--profile", "nottingham", "--fs", "5e6",
     "--freq", "1575.4e6"],
], ids=["synthetic", "wav", "adsb", "override"])
def test_plan_text_identical(argv, capsys):
    got = run_main(playback.main, argv, capsys)
    assert got == run_main(ref.main, argv, capsys)
    assert got[0] == 0 and "hackrf_transfer -s" in got[1]


def test_plan_grc_identical(tmp_path, capsys):
    a, b = tmp_path / "torch.grc", tmp_path / "jax.grc"
    ta = run_main(playback.main, ["plan", "tx.bin", "--profile",
                                  "nottingham", "--grc", str(a)], capsys)
    tb = run_main(ref.main, ["plan", "tx.bin", "--profile", "nottingham",
                             "--grc", str(b)], capsys)
    assert ta[1].replace(str(a), "G") == tb[1].replace(str(b), "G")
    assert a.read_text() == b.read_text()
    text = a.read_text()
    assert "id: osmosdr_sink" in text and "center_freq0: '1575420000'" in text


LOOP = ["--fs-tx", str(FS), "--fc-rx", str(FC), "--freq-offset", "8000",
        "--delay", "1234", "--noise", "0.3"]


@pytest.mark.parametrize("extra", [[], ["--fs-rx", "4.092e6", "--fc-rx",
                                        "1.023e6", "--duration", "0.004",
                                        "--gain", "0.7", "--seed", "3"]],
                         ids=["same-rate", "resampled"])
def test_loopback_file_identical(tx_file, tmp_path, capsys, extra):
    a, b = tmp_path / "torch.bin", tmp_path / "jax.bin"
    ta = run_main(playback.main, ["loopback", str(tx_file), str(a)] + LOOP
                  + extra, capsys)
    tb = run_main(ref.main, ["loopback", str(tx_file), str(b)] + LOOP
                  + extra, capsys)
    assert ta[0] == tb[0] == 0
    assert ta[1].replace(str(a), "F") == tb[1].replace(str(b), "F")
    assert a.read_bytes() == b.read_bytes()


def test_loopback_acquire_table_identical(tx_file, tmp_path, capsys):
    """tests/test_playback.py:51 through both CLIs: the replayed PRN 8
    is re-acquired with the 8 kHz offset in its Doppler, and the port's
    table (``--device cpu``) matches the JAX CLI's row for row."""
    a, b = tmp_path / "torch.bin", tmp_path / "jax.bin"
    acq = ["--acquire", "--max-fo", "20000"]
    _, got, _ = run_main(playback.main, ["loopback", str(tx_file), str(a)]
                         + LOOP + acq + ["--device", "cpu"], capsys)
    _, want, _ = run_main(ref.main, ["loopback", str(tx_file), str(b)]
                          + LOOP + acq, capsys)
    rows = lambda t: [ln.split() for ln in t.splitlines()[2:]]
    g, w = rows(got), rows(want)
    assert len(g) == len(w) >= 1
    for rg, rw in zip(g, w):
        assert [rg[0], rg[2], rg[3]] == [rw[0], rw[2], rw[3]]  # PRN, shifts
        assert abs(float(rg[1]) - float(rw[1])) <= 0.1 + 2e-3 * float(rw[1])
        assert abs(float(rg[4]) - float(rw[4])) <= 0.1
    top = g[0]
    assert top[0] == "8" and abs(abs(float(top[4])) - 8000.0) < 2 * 250.0


def test_loopback_acquire_defaults_to_the_card(tx_file, tmp_path):
    args = playback.build_parser().parse_args(
        ["loopback", str(tx_file), str(tmp_path / "x.bin"), "--acquire"])
    assert args.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        playback.main(["loopback", str(tx_file), str(tmp_path / "x.bin"),
                       "--acquire", "--duration", "0.005"])


def test_adsb_gen_verify_identical(tmp_path, capsys):
    """tests/test_playback.py:178 through both CLIs."""
    a, b = tmp_path / "torch.bin", tmp_path / "jax.bin"
    args = ["--icao", "ABCDEF", "--callsign", "TPUGNSS1", "--lat", "52.25",
            "--lon", "4.0", "--alt-ft", "38000", "--repeat", "2", "--verify"]
    ta = run_main(playback.main, ["adsb-gen", str(a)] + args, capsys)
    tb = run_main(ref.main, ["adsb-gen", str(b)] + args, capsys)
    assert ta[0] == tb[0] == 0
    assert ta[1].replace(str(a), "F") == tb[1].replace(str(b), "F")
    assert a.read_bytes() == b.read_bytes()
    assert "6 CRC-valid frames" in ta[1] and "lat=52.25" in ta[1]
    raw = np.fromfile(a, dtype=np.int8)
    assert np.abs(raw).max() == 100 and np.all(raw[1::2] == 0)


def test_adsb_gen_input_validation(tmp_path, capsys):
    """tests/test_playback.py:195: a bad callsign is a clean error (rc 2)."""
    for main in (playback.main, ref.main):
        rc, _, err = run_main(main, ["adsb-gen", str(tmp_path / "x.bin"),
                                     "--callsign", "AIR-25"], capsys)
        assert rc == 2 and "callsign" in err
