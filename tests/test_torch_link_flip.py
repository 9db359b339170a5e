"""Does the JAX receiver's Costas loop settle at the other half-cycle on
chip_smoke.py's phase-9 scene too?  (slow, CPU)

Phase 9 of ``chip_smoke.py`` runs a 4 s, 6-SV int8 I/Q scene at the
hackrf preset (10 Msps, +25 kHz common offset; ``signal/scene.py``,
sample-identical to ``tests.test_e2e.build_scene``) once per link, and
reads the int4 / int2 prompt histories against int8 after the 200-epoch
pull-in and up to the Costas loop's sign, because on the card one link's
loop settled at the other half-cycle.  The reference's own bars
(tests/test_stream.py:494-537) take the whole history with no sign
allowance.  This test puts the same scene through both packages over
int8, int4 and int2 and prints, per link and PRN, whether each package's
loop settles at the other half-cycle against its int8 run.

Cut to fit the CPU: the scene keeps phase 9's 4 s (PRN 6's pull-in
difference between links builds up after 2 s), and the Doppler grid is
narrowed from +-100 kHz to +-32 kHz, which holds +25 kHz plus the sky
Dopplers; at both widths the port detects and tracks the same channels
with the same figures (PERF.md §6).
"""

import dataclasses

import numpy as np
import pytest

from tpu_gnss_torch import PRESETS
from tpu_gnss_torch.signal import scene
from tests.torch_threads import one_torch_thread  # noqa: F401

CFG = dataclasses.replace(PRESETS["hackrf"], max_fo=32000.0)
LINKS = ("int8", "int4", "int2")
BARS = {"int4": 0.05, "int2": 0.25}     # tests/test_stream.py:494-537
DURATION = 4.0
OFFSET_HZ = 25e3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import chip_smoke
    from tpu_gnss.config import ReceiverConfig as JaxConfig
    from tpu_gnss.io.stream import IQFileSource as JaxIQFileSource
    from tpu_gnss.receiver import Receiver as JaxReceiver
    from tpu_gnss_torch.io.stream import IQFileSource
    from tpu_gnss_torch.receiver import Receiver
    iq, _, _ = scene.build_scene(duration=DURATION, fs=CFG.fs)
    path = str(tmp_path_factory.mktemp("flip") / "hackrf_iq8.bin")
    chip_smoke.write_iq8(iq, path, signed=True, offset_hz=OFFSET_HZ,
                         fs=CFG.fs)
    del iq
    jcfg = JaxConfig(**dataclasses.asdict(CFG))
    out = {}
    for link in LINKS:
        out["port", link] = Receiver(
            CFG, transfer_dtype=link, device="cpu").process_source(
                IQFileSource(path, CFG.fs, "int8"))
        out["jax", link] = JaxReceiver(
            jcfg, transfer_dtype=link).process_source(
                JaxIQFileSource(path, CFG.fs, "int8"))
    return out


def _flip_and_rel(a, b):
    """(settled at the other half-cycle?, whole-history rel, sign
    agreement after epoch 200) of prompt history ``a`` against ``b``."""
    ia, ib = a.ip_hist[200:], b.ip_hist[200:]
    flipped = float(np.dot(ia, ib)) < 0
    rel = float(np.linalg.norm(a.ip_hist - b.ip_hist)
                / np.linalg.norm(b.ip_hist))
    return flipped, rel, float(np.mean(np.sign(ia) == np.sign(ib)))


@pytest.mark.slow
def test_costas_phase_per_link_in_both_packages(runs):
    """Each package against its own int8 run: the reference's whole-history
    bars, no sign allowance.  Prints the half-cycle verdict per link and
    PRN."""
    verdict = {}
    for pkg in ("jax", "port"):
        base = runs[pkg, "int8"]
        assert len(base.detections) >= 4
        for link in ("int4", "int2"):
            res = runs[pkg, link]
            assert ([d["prn"] for d in res.detections]
                    == [d["prn"] for d in base.detections])
            for a, b in zip(res.channels, base.channels):
                assert (a.prn, a.start_epoch) == (b.prn, b.start_epoch)
                flipped, rel, sign = _flip_and_rel(a, b)
                verdict[pkg, link, a.prn] = flipped
                print(f"{pkg} {link} PRN {a.prn}: "
                      f"{'other half-cycle' if flipped else 'same phase'} "
                      f"as int8, whole-history rel {rel:.4f} "
                      f"(bar {BARS[link]}), sign agreement {sign:.4f}")
                assert not flipped and rel < BARS[link]
                if link == "int2":
                    assert sign > 0.98
    # the port settles where the reference settles, link by link
    assert {k[1:]: v for k, v in verdict.items() if k[0] == "port"} == \
        {k[1:]: v for k, v in verdict.items() if k[0] == "jax"}


@pytest.mark.slow
def test_port_tracks_like_the_reference_on_every_link(runs):
    """Link by link, the port's channels against the JAX receiver's: the
    same channels at the same phase, prompt histories within 1e-3."""
    for link in LINKS:
        got, want = runs["port", link], runs["jax", link]
        assert ([d["prn"] for d in got.detections]
                == [d["prn"] for d in want.detections])
        for a, b in zip(got.channels, want.channels):
            assert (a.ch, a.prn, a.start_epoch) == (b.ch, b.prn,
                                                    b.start_epoch)
            flipped, rel, _ = _flip_and_rel(a, b)
            print(f"port against jax, {link} PRN {a.prn}: rel {rel:.2e}")
            assert not flipped and rel < 1e-3
