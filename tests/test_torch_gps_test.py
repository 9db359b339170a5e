"""Both ``gps_test`` mains on one 1-bit capture, the port's on the CPU.

The capture stands in for the reference's PRN 8 synthetic recording
(8.184 Msps, 2.046 MHz IF; tests/test_cli.py): PRN 8 dominant plus two
weaker SVs, synthesized here from a seed.  The tables are parsed and
compared: the satellite, lo_shift and ca_shift rows equal, every SNR
within rtol 2e-3 (tests/test_acquire.py:47) plus half a printed unit.
With this seed every SNR lies far from the threshold of 25 (noise peaks
below 17, the weakest SV near 70), so no detection hangs on rounding; the
test checks that margin (1%) too.
"""

import contextlib
import io
import re

import numpy as np
import pytest

from chip_smoke import parse_tables
from tpu_gnss_torch.cli import gps_test as tgt
from tpu_gnss_torch.config import SYNTHETIC as CFG
from tpu_gnss_torch.signal import synth
from tests.torch_threads import one_torch_thread  # noqa: F401

THRESHOLD = 25.0
SNR_RTOL = 2e-3
# (prn, Doppler Hz, code phase chips, amplitude)
SVS = ((8, 0.0, 37.3, 1.0), (14, 1000.0, 512.6, 0.45),
       (27, -2000.0, 901.2, 0.4))


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """One compat run (32 packet-strided blocks of 40960 samples) and a
    little more."""
    from tpu_gnss_torch.io import loaders
    n = 32 * 40960 + 8192
    iq = synth.synth_baseband(
        [synth.SvSignal(prn=p, doppler_hz=d, code_phase_chips=c,
                        amplitude=a) for p, d, c, a in SVS],
        CFG.fs, n, noise_std=3.0, seed=1)
    path = tmp_path_factory.mktemp("gps_test") / "sig_1bit.bin"
    path.write_bytes(loaders.pack_1bit(
        synth.baseband_to_1bit_if(iq, CFG.fc, CFG.fs)))
    return str(path)


def _run(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _tables_text(out: str) -> list:
    """The table lines (from the first run on) with numbers masked."""
    lines = out.splitlines()
    first = next(i for i, ln in enumerate(lines) if "satellite:" in ln)
    return [re.sub(r"[-+]?\d+(\.\d+)?", "#", ln) for ln in lines[first:]]


def assert_tables_agree(got: str, want: str, n_runs: int) -> list[dict]:
    assert _tables_text(got) == _tables_text(want)
    g, w = parse_tables(got), parse_tables(want)
    assert len(g) == len(w) == n_runs, (got, want)
    for a, b in zip(g, w):
        assert (a["sv"], a["lo"], a["ca"]) == (b["sv"], b["lo"], b["ca"])
        # %5.1f and %2.0f rows: rtol 2e-3 plus half a printed unit
        np.testing.assert_allclose(a["snr"], b["snr"], rtol=SNR_RTOL,
                                   atol=0.05 + 1e-9)
        np.testing.assert_allclose(a["all_snr"], b["all_snr"], rtol=SNR_RTOL,
                                   atol=0.5 + 1e-9)
        assert len(a["all_snr"]) == 32
        # the seed keeps every SNR 1% clear of the threshold
        assert not any(abs(s - THRESHOLD) < 0.01 * THRESHOLD
                       for s in a["snr"] + a["all_snr"])
    return g


@pytest.mark.parametrize("mode,runs", [("compat", 1), ("native", 2),
                                       ("folded", 2)])
def test_tables_match_jax(capture, mode, runs):
    from tpu_gnss.cli import gps_test as jgt
    argv = [capture, "2.046e6", "8.184e6", "5000", "--mode", mode,
            "--max-runs", str(runs)]
    got = _run(tgt.main, argv + ["--device", "cpu"])
    want = _run(jgt.main, argv)
    tables = assert_tables_agree(got, want, runs)
    for t in tables:
        assert 7 in t["sv"], "PRN 8 (sv 7) must be detected"
    if mode != "compat":
        # all PRNs searched per block: the two weaker SVs too
        assert {7, 13, 26} <= set(tables[0]["sv"])
    assert f"mode={mode}" in got


def test_quirk_ignore_max_fo(capture):
    from tpu_gnss.cli import gps_test as jgt
    argv = [capture, "2.046e6", "8.184e6", "999999",
            "--quirk-ignore-max-fo", "--mode", "native", "--max-runs", "1"]
    got = _run(tgt.main, argv + ["--device", "cpu"])
    assert "max_fo=5000" in got
    assert_tables_agree(got, _run(jgt.main, argv), 1)


def test_format_run_tables_is_the_reference():
    from tpu_gnss.cli import gps_test as jgt
    hits = [dict(sv=7, snr=476.01, lo_shift=0, ca_shift=8149),
            dict(sv=13, snr=80.4, lo_shift=-2, ca_shift=17)]
    snr = np.linspace(3.0, 476.0, 32)
    assert tgt.format_run_tables(3, hits, snr) == \
        jgt.format_run_tables(3, hits, snr)


def test_folded_engine_by_device():
    """The folded mode runs the fused kernel on a CUDA device or raises
    there; the grid engine never runs on the card in the kernel's place."""
    import types
    import torch
    from tpu_gnss_torch.cli.search_runner import folded_engine
    ok = types.SimpleNamespace(nf=8192, mxu_supported=lambda: True)
    bad = types.SimpleNamespace(nf=8191, mxu_supported=lambda: False)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert folded_engine(ok, cuda) == "mxu"
    assert folded_engine(ok, cpu) == folded_engine(bad, cpu) == "xla"
    with pytest.raises(ValueError, match="8191"):
        folded_engine(bad, cuda)


def test_missing_file_and_cuda_without_card(tmp_path, capsys):
    import torch
    assert tgt.main([str(tmp_path / "nope.bin"), "--device", "cpu"]) == 2
    assert "can not open file" in capsys.readouterr().err
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cap = tmp_path / "z.bin"
    cap.write_bytes(bytes(8192))
    with pytest.raises(RuntimeError):
        tgt.main([str(cap), "--mode", "folded", "--device", "cuda"])
