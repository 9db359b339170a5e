"""Warm start in the port's receiver against the JAX receiver, on the CPU.

A short e2e-recipe scene (3 s, 6 SVs at PRNs 2-7, 2.048 Msps) goes through
``process_source(warm_ephemerides=, search_prns=)`` of both packages
(tpu_gnss/receiver.py:458-532, 544-586, 855-861):

- a proper subset of PRNs directs the cold search: detections stay inside
  it, and the directed searcher is retired once it has seeded channels;
- a junk subset (PRNs absent from the scene) falls back to the full sweep
  and is retired too;
- the detections (PRN, Doppler bin, code-phase lag) equal the JAX
  receiver's for the same arguments, acquisition engine included (each
  package's "auto" picks its kernel engine only on its own accelerator);
- the warm ephemerides are deep-copied into the channel records, and the
  caller's dict is unchanged by the run.
"""

import copy
import dataclasses

import numpy as np
import pytest

from tpu_gnss.config import ReceiverConfig
from tpu_gnss_torch.io.stream import ArraySource
from tpu_gnss_torch.receiver import Receiver
from tpu_gnss_torch.signal import scene
from tests.torch_threads import one_torch_thread  # noqa: F401

FS = scene.FS
CFG = ReceiverConfig(fs=FS, fc=FS / 4, max_fo=5000.0, fft_len=4096,
                     snr_threshold=20.0)
VISIBLE = [2, 3, 4, 5, 6]       # PRN 7 left out, as tests/test_e2e.py:503


@pytest.fixture(scope="module")
def short_scene():
    iq, ephs, rx = scene.build_scene(duration=3.0, n_sv=6, seed=42)
    return iq, {scene.eph_prn(k): e for k, e in enumerate(ephs)}


def _port(iq, warm, prns, engine="mxu"):
    recv = Receiver(CFG, acq_engine=engine, device="cpu")
    res = recv.process_source(ArraySource(iq, FS), warm_ephemerides=warm,
                              search_prns=prns)
    return recv, res


def _jax(iq, warm, prns, engine="mxu"):
    from tpu_gnss.io.stream import ArraySource as JaxArraySource
    from tpu_gnss.nav.ephemeris import Ephemeris as JaxEphemeris
    from tpu_gnss.receiver import Receiver as JaxReceiver
    jwarm = {p: JaxEphemeris(**{f.name: getattr(e, f.name)
                                for f in dataclasses.fields(e)})
             for p, e in warm.items()}
    recv = JaxReceiver(CFG, acq_engine=engine)
    res = recv.process_source(JaxArraySource(iq, FS), warm_ephemerides=jwarm,
                              search_prns=prns)
    return recv, res


def _keys(res):
    """(PRN, Doppler bin, lag) per detection, in the receiver's order."""
    return [(d["prn"], int(d["lo_shift"]), int(round(d["ca_shift"])))
            for d in res.detections]


@pytest.mark.parametrize("engine", ["mxu", "xla"])
def test_directed_subset_confines_and_retires(short_scene, engine):
    iq, warm = short_scene
    recv, res = _port(iq, warm, VISIBLE, engine)
    assert recv._searcher_directed is None     # retired after its sweep
    det = [d["prn"] for d in res.detections]
    assert len(det) >= 4 and set(det) <= set(VISIBLE), det
    jrecv, jres = _jax(iq, warm, VISIBLE, engine)
    assert jrecv._searcher_directed is None
    assert _keys(res) == _keys(jres)


@pytest.mark.parametrize("engine", ["mxu", "xla"])
def test_junk_subset_falls_back_to_the_full_sweep(short_scene, engine):
    """With the kernel engine the junk sweep finds nothing and the full
    sweep runs.  The grid engine's 8-block weak search over the four junk
    PRNs reports four noise peaks (SNR ~5, over the false-alarm-equalized
    threshold) in both packages alike, so that sweep counts as a success;
    the decisions still agree."""
    iq, warm = short_scene
    recv, res = _port(iq, warm, [25, 26, 27, 28], engine)
    assert recv._searcher_directed is None, "junk directed set kept"
    assert len(res.detections) >= 4, res.detections
    _, jres = _jax(iq, warm, [25, 26, 27, 28], engine)
    assert _keys(res) == _keys(jres)
    if engine == "mxu":
        # the fallback finds what an undirected search finds
        _, full = _port(iq, warm, None, engine)
        assert _keys(res) == _keys(full)


@pytest.mark.parametrize("prns", [None, [], list(range(1, 33)), [2, 99]])
def test_only_a_proper_subset_directs(short_scene, prns):
    """None, an empty set and the whole constellation build no directed
    searcher; a set with unknown PRNs is cut to the known ones."""
    recv = Receiver(CFG, device="cpu")
    iq, _ = short_scene
    seen = []
    real = recv._cold_detections

    def spy(*a, **kw):
        seen.append(recv._searcher_directed)
        return real(*a, **kw)

    recv._cold_detections = spy
    recv.process_source(ArraySource(iq[: int(1.0 * FS)], FS),
                        search_prns=prns)
    first = seen[0]
    if prns == [2, 99]:
        assert first is not None and first.cfg.prns == (2,)
    else:
        assert first is None


def test_warm_ephemerides_are_copied(short_scene):
    iq, warm = short_scene
    before = copy.deepcopy(warm)
    recv, res = _port(iq, warm, None)
    assert res.channels
    for r in res.channels:
        assert r.eph is not warm[r.prn]
        assert dataclasses.asdict(r.eph) == dataclasses.asdict(warm[r.prn])
    assert {p: dataclasses.asdict(e) for p, e in warm.items()} == \
        {p: dataclasses.asdict(e) for p, e in before.items()}
    # a cold run leaves the records without an ephemeris
    _, cold = _port(iq, None, None)
    assert not any(r.eph.valid() for r in cold.channels)
    assert all(r.eph.valid() for r in res.channels)


# ---------------------------------------------------------------------------
# slow: the reference's warm-start oracles, both packages on one scene
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene20():
    """The 20 s e2e scene of tests/test_e2e.py:62-65 (sample-identical)."""
    iq, ephs, rx = scene.build_scene(duration=20.0)
    return iq, {scene.eph_prn(k): e for k, e in enumerate(ephs)}, rx


def _fix_err(res, rx):
    sol = res.solutions[-1]
    return float(np.linalg.norm(np.array([sol.x, sol.y, sol.z])
                                - np.array(rx)))


def _same_decisions(got, want, rx, limit=150.0):
    """Same detections (PRN, Doppler bin, lag), the same fix epochs, each
    package's last fix within ``limit`` m of the truth."""
    assert _keys(got) == _keys(want)
    assert [s.snap_epoch for s in got.solutions] == \
        [s.snap_epoch for s in want.solutions]
    if got.solutions:
        assert _fix_err(got, rx) < limit and _fix_err(want, rx) < limit


@pytest.mark.slow
@pytest.mark.parametrize("seconds", [8.0, 6.0])
def test_warm_start_short_capture(scene20, seconds):
    """tests/test_e2e.py:235 (8 s: cold cannot fix, warm fixes within
    150 m) and :465 (6 s: the fix comes from a TLM/HOW anchor before the
    first full subframe ends)."""
    iq, warm, rx = scene20
    short = iq[: int(seconds * FS)]
    _, cold = _port(short, None, None, "xla")
    assert not cold.solutions, "cold start cannot fix this early"
    _, got = _port(short, warm, None, "xla")
    _, want = _jax(short, warm, None, "xla")
    assert got.solutions, f"warm start must fix within {seconds:g} s"
    _same_decisions(got, want, rx)


@pytest.mark.slow
def test_almanac_directed_warm_search(scene20):
    """tests/test_e2e.py:489: the directed 5-PRN warm start fixes within
    8 s with detections inside the subset, collects its own almanac, and
    a junk set falls back; both packages decide alike."""
    iq, warm, rx = scene20
    short = iq[: int(8.0 * FS)]
    recv, got = _port(short, warm, VISIBLE, "xla")
    jrecv, want = _jax(short, warm, VISIBLE, "xla")
    assert recv._searcher_directed is None
    assert got.detections and all(d["prn"] in VISIBLE
                                  for d in got.detections)
    assert got.solutions, "directed warm start must fix within 8 s"
    _same_decisions(got, want, rx)
    assert set(recv.almanac) >= {d["prn"] for d in got.detections}
    assert sorted(recv.almanac) == sorted(jrecv.almanac)
    recv2, got2 = _port(short, warm, [25, 26, 27, 28], "xla")
    _, want2 = _jax(short, warm, [25, 26, 27, 28], "xla")
    assert recv2._searcher_directed is None
    assert len(got2.detections) >= 4, got2.detections
    _same_decisions(got2, want2, rx)
