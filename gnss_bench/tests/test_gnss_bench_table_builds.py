"""The reader of ``acquire.table_builds_per_capture``: on the program's
own records of two captures (a build in the first, none in the second),
and on a program that does not count table builds."""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

from gnss_bench import run
from tpu_gnss_torch.acquire import folded
from tpu_gnss_torch.config import ReceiverConfig
from tpu_gnss_torch.utils import metrics
from tpu_gnss_torch.utils.metrics import METRICS

NAME = "acquire.table_builds_per_capture"
CTX = dict(stages={}, signal_s=8.0, n_captures=2, trace=None, cfg={},
           loop={}, kind="")
CFG = ReceiverConfig(fs=2.048e6, fc=0.512e6, max_fo=5000.0)


def test_builds_per_capture(monkeypatch):
    """Two searchers of one key, each in a capture: the first capture
    builds the spectra and the planes, the second nothing; a build
    outside the captures is not theirs."""
    monkeypatch.setattr(folded, "_TABLES", OrderedDict())
    METRICS.drain()
    with METRICS.recording():
        for _ in range(2):
            with METRICS.stage("receiver.capture", root=True):
                s = folded.FoldedSearcher(CFG, device="cpu")
                s.code_ffts_p, s.mxu_code_planes()
        folded.FoldedSearcher(dataclasses.replace(CFG, prns=(1, 2)),
                              device="cpu").code_ffts_p
        assert run.reader(NAME)(CTX) == 1.0
    METRICS.drain()


def test_no_number_without_the_counter(monkeypatch):
    """The parent program registers no ``acquire.table_builds``: the
    reader gives nothing, and does not raise."""
    monkeypatch.setattr(metrics, "COUNTERS", tuple(
        c for c in metrics.COUNTERS if c[0] != "acquire.table_builds"))
    METRICS.drain()
    with METRICS.recording():
        with METRICS.stage("receiver.capture", root=True):
            pass
        assert run.reader(NAME)(CTX) is None
    METRICS.drain()
