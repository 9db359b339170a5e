"""The receiver's prewarm and the process's shared trackers.

On the CPU the prewarm bodies return at once (there is nothing to build),
so these tests hold what surrounds them: ``shared_tracker``'s keys, two
receivers of one process against the JAX receiver, the waits and the
errors (their spans: tests/test_torch_spans.py).  ``chip_smoke.py``
phase 18e runs the bodies on the card.
"""

import threading
import time

import numpy as np
import pytest
import torch

from tpu_gnss.config import ReceiverConfig
from tpu_gnss_torch.acquire.folded import FoldedSearcher
from tpu_gnss_torch.dist.shard import make_mesh
from tpu_gnss_torch.io.stream import FileSource1Bit
from tpu_gnss_torch.receiver import Receiver
from tpu_gnss_torch.signal import scene
from tpu_gnss_torch.track import channel as tc
from tpu_gnss_torch.track import graph
from tpu_gnss_torch.track.quality import pll_lock_metric
from tests.torch_threads import one_torch_thread  # noqa: F401

FS = scene.FS
CFG = ReceiverConfig(fs=FS, fc=FS / 4, max_fo=5000.0, fft_len=4096,
                     snr_threshold=17.0)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """4 s of the e2e scene recipe (6 SVs at 2.048 Msps) as 1-bit IF."""
    iq, _, _ = scene.build_scene(duration=4.0)
    path = tmp_path_factory.mktemp("torch_prewarm") / "cap_1bit.bin"
    scene.write_1bit_capture(iq, CFG.fc, FS, path)
    return str(path)


def _run(capture, seconds=1.0, **kw):
    recv = Receiver(CFG, device="cpu", **kw)
    return recv, recv.process_source(FileSource1Bit(capture, CFG),
                                     max_duration_s=seconds)


def _tracker_opts(**change):
    opts = dict(device="cpu", fs=FS,
                pll_gains=tc.second_order_gains(18.0, t_s=0.01),
                dll_gains=tc.second_order_gains(2.0, t_s=0.01),
                fll_bn_hz=3.0, corr_spacing=0.5, carrier_aiding=True,
                epochs_per_step=10, agc_thresholds=None)
    opts.update(change)
    return opts


# each static option of the tracker, changed
_CHANGED = {"fs": 4.096e6, "pll_gains": tc.second_order_gains(15.0, 0.01),
            "dll_gains": tc.second_order_gains(1.0, 0.01),
            "fll_bn_hz": 2.0, "corr_spacing": 0.25, "carrier_aiding": False,
            "epochs_per_step": 5, "agc_thresholds": (1e5, 4e5),
            "device": "cuda:1"}


@pytest.mark.parametrize("option", sorted(_CHANGED))
def test_shared_tracker_keys_on_every_option(option, monkeypatch):
    """Equal options and device give one tracker; changing any one option
    gives another, itself shared.  (The device case resolves devices as
    ``torch.device`` does, since this machine has no card.)"""
    monkeypatch.setattr(graph, "resolve_device", torch.device)
    base = (dict(device="cuda:0") if option == "device" else {})
    a = graph.shared_tracker(**_tracker_opts(**base))
    assert graph.shared_tracker(**_tracker_opts(**base)) is a
    b = graph.shared_tracker(**_tracker_opts(**{option: _CHANGED[option]}))
    assert b is not a
    assert graph.shared_tracker(
        **_tracker_opts(**{option: _CHANGED[option]})) is b


def test_receivers_share_the_tracker():
    """Receivers with the same options and device share one tracker; a
    mesh receiver keeps its own."""
    a, b = Receiver(CFG, device="cpu"), Receiver(CFG, device=torch.device(
        "cpu"))
    assert a._tracker is b._tracker
    assert isinstance(a._tracker, graph.GraphedTracker)
    assert Receiver(CFG, pll_bn_hz=15.0, device="cpu")._tracker \
        is not a._tracker
    mesh = make_mesh(2, ("dop",), device="cpu")
    assert not isinstance(Receiver(CFG, mesh=mesh, device="cpu")._tracker,
                          graph.GraphedTracker)


def _locked(res):
    return {(r.ch, r.prn) for r in res.channels
            if not r.lost and r.n_epochs >= 2000
            and pll_lock_metric(r.ip_hist, r.qp_hist, window=1000) > 0.45}


def test_two_receivers_match_jax(capture):
    """Two receivers of one process, one after the other on the same 4 s
    capture, against the JAX receiver, with tests/test_torch_receiver.py's
    bars: the same PRNs, Doppler within one 250 Hz bin, code phase within
    one sample, the same locked channels and the same fixes (none in 4 s).
    The two port runs agree bit for bit."""
    from tpu_gnss.io.stream import FileSource1Bit as JaxFileSource1Bit
    from tpu_gnss.receiver import Receiver as JaxReceiver
    want = JaxReceiver(CFG).process_source(JaxFileSource1Bit(capture, CFG))
    (ra, a), (rb, b) = (_run(capture, seconds=None) for _ in range(2))
    assert ra._tracker is rb._tracker
    w = {d["prn"]: d for d in want.detections}
    p = FS / 1000
    for got in (a, b):
        g = {d["prn"]: d for d in got.detections}
        assert len(g) >= 4 and set(g) == set(w)
        for prn in g:
            assert abs(g[prn]["doppler_hz"] - w[prn]["doppler_hz"]) < 250.0
            dca = (g[prn]["ca_shift"] - w[prn]["ca_shift"] + p / 2) % p \
                - p / 2
            assert abs(dca) < 1.0
        assert len(_locked(got)) >= 4 and _locked(got) == _locked(want)
        assert ([(r.ch, r.prn, r.start_epoch) for r in got.channels]
                == [(r.ch, r.prn, r.start_epoch) for r in want.channels])
        assert len(got.solutions) == len(want.solutions)
    assert a.detections == b.detections
    for x, y in zip(a.channels, b.channels, strict=True):
        assert (x.ch, x.prn, x.n_epochs, x.lost) == (y.ch, y.prn, y.n_epochs,
                                                     y.lost)
        for key in ("ip", "qp", "cf", "caf", "chips"):
            np.testing.assert_array_equal(x.hist(key), y.hist(key))


class _Boom(RuntimeError):
    pass


@pytest.mark.parametrize("body", ["_prewarm_acq", "_prewarm_track",
                                  "_prewarm_seeder"])
def test_a_prewarm_error_is_raised(capture, monkeypatch, body):
    """A failing prewarm body fails ``process_source`` with its own error,
    for the search, the tracker and the channel seeder."""
    def boom(self, *args, **kw):
        raise _Boom(body)

    monkeypatch.setattr(Receiver, body, boom)
    with pytest.raises(_Boom, match=body):
        _run(capture)


def test_the_search_waits_for_its_prewarm(capture, monkeypatch):
    """A search prewarm that ends well after the prefetch thread read and
    uploaded the first chunk holds the cold search back until it is done,
    and the detections are those of a run without it."""
    _, want = _run(capture)
    order, uploaded = [], threading.Event()
    upload = Receiver._mix_chunk_packed
    search = FoldedSearcher.detections_refined_fast

    def mix(self, *args, **kw):
        out = upload(self, *args, **kw)
        uploaded.set()
        return out

    def slow_prewarm(self, head_len, bits):
        assert uploaded.wait(timeout=60)
        time.sleep(0.3)
        order.append("prewarm")

    def spy(self, *args, **kw):
        order.append("search")
        return search(self, *args, **kw)

    monkeypatch.setattr(Receiver, "_mix_chunk_packed", mix)
    monkeypatch.setattr(Receiver, "_prewarm_acq", slow_prewarm)
    monkeypatch.setattr(FoldedSearcher, "detections_refined_fast", spy)
    _, got = _run(capture)
    assert order[:2] == ["prewarm", "search"]
    assert got.detections == want.detections


@pytest.mark.parametrize("engine", ["mxu", "xla"])
@pytest.mark.parametrize("bits", [True, False], ids=["bits", "iq"])
def test_search_prewarm_changes_no_receiver_state(engine, bits):
    """The search prewarm's body, run as on a card (the receiver's device
    read as CUDA, the searchers on the CPU): the all-zero head gives the
    engine no detections, a second prewarm of the same search in the
    process does not search again, and the directed searcher and the
    table cache are left as they were."""
    recv = Receiver(CFG, acq_engine=engine, device="cpu")
    head_len = 8 * recv.searcher.block_len
    head = np.zeros(head_len, np.uint8 if bits else np.complex64)
    kw = dict(bits=head) if bits else dict(iq=head)
    s = recv.searcher
    got = (s.detections_refined_fast(**kw) if engine == "mxu"
           else s.detections_refined(s.power_grid(**kw), 1))
    assert got == []
    directed = FoldedSearcher(ReceiverConfig(
        fs=FS, fc=FS / 4, max_fo=5000.0, fft_len=4096, snr_threshold=17.0,
        prns=(2, 3, 4, 5)), device="cpu")
    tables = recv._tables_for((2, 3, None), 3)
    recv._searcher_directed = directed
    recv.device = torch.device("cuda")
    recv._prewarm_acq(head_len, bits)
    assert recv.prewarm_stats["acq_searched"] is True
    recv._prewarm_acq(head_len, bits)       # the process has run it
    assert recv.prewarm_stats["acq_searched"] is False
    assert recv._searcher_directed is directed
    assert recv._tables_cache[0] == (2, 3, None)
    assert recv._tables_cache[1] is tables
