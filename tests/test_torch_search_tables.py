"""The search's device tables, built once per process and key.

``FoldedSearcher.code_ffts_p`` and ``mxu_code_planes()`` return the
process's tables (``acquire.folded.replica_spectra`` / ``code_planes``):
two searchers of one configuration share the tensors, the tables are
bit-identical to a fresh float64 build, each key is built once (counted
in ``acquire.table_builds``) even when threads ask at once, a search
writes nothing into them, and a second receiver of the process builds
nothing.
"""

import dataclasses
import threading
import time
from collections import OrderedDict

import numpy as np
import pytest
import torch

from tpu_gnss.config import ReceiverConfig
from tpu_gnss_torch.acquire import folded
from tpu_gnss_torch.acquire.folded import FoldedSearcher
from tpu_gnss_torch.dist.shard import make_mesh
from tpu_gnss_torch.io.stream import FileSource1Bit
from tpu_gnss_torch.ops.mxu_corr import fold_code_planes_T
from tpu_gnss_torch.receiver import Receiver
from tpu_gnss_torch.signal import scene
from tpu_gnss_torch.utils.metrics import METRICS
from tests.torch_threads import one_torch_thread  # noqa: F401

FS = scene.FS
CFG = ReceiverConfig(fs=FS, fc=FS / 4, max_fo=5000.0, fft_len=4096,
                     snr_threshold=17.0)
#: the benchmark's two formats: 1-bit at 5.456 Msps (NF 16384, padded) and
#: int8 I/Q at 10 Msps (NF = P = 10000)
FORMATS = {
    "e2e": CFG,
    "nottingham": ReceiverConfig(fs=5.456e6, fc=4.092e6, max_fo=5000.0),
    "hackrf": ReceiverConfig(fs=10e6, fc=0.0, max_fo=100e3),
}


@pytest.fixture
def fresh_tables(monkeypatch):
    """An empty table cache for the test (the process's is restored)."""
    monkeypatch.setattr(folded, "_TABLES", OrderedDict())


def _builds(block) -> float:
    """``acquire.table_builds`` counted while ``block()`` runs."""
    METRICS.drain()
    with METRICS.recording():
        block()
    _, counts, _ = METRICS.drain()
    return sum(c.value for c in counts if c.name == "acquire.table_builds")


def _fresh_build(cfg, nf, period):
    """The per-searcher build: float64 spectra of fresh replicas, then
    complex64 and the kernel's planes."""
    reps = folded.cacode.resample(
        folded.cacode.code_table()[np.array(cfg.prns) - 1], cfg.fs, period)
    spec = np.fft.fft(reps.astype(np.float64), n=nf, axis=-1)
    return spec.astype(np.complex64), fold_code_planes_T(spec, period)


def _tables(s):
    return (s.code_ffts_p, *s.mxu_code_planes())


def test_searchers_share_the_tables(fresh_tables):
    """Two searchers of one configuration get the same tensor objects."""
    a, b = (FoldedSearcher(CFG, device="cpu") for _ in range(2))
    for x, y in zip(_tables(a), _tables(b), strict=True):
        assert x is y


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_tables_are_bit_identical_to_a_fresh_build(fmt, fresh_tables):
    cfg = FORMATS[fmt]
    s = FoldedSearcher(cfg, device="cpu")
    spec, (cr, ci) = _fresh_build(cfg, s.nf, s.period)
    got = _tables(s)
    assert [t.dtype for t in got] == [torch.complex64, torch.float32,
                                      torch.float32]
    for t, want in zip(got, (spec, cr, ci), strict=True):
        assert t.is_contiguous() and t.shape == want.shape
        np.testing.assert_array_equal(t.numpy(), want)


def test_a_key_is_built_once(fresh_tables):
    """The first searcher builds the two tables; a second builds none."""
    assert _builds(lambda: _tables(FoldedSearcher(CFG, device="cpu"))) == 2
    assert _builds(lambda: _tables(FoldedSearcher(CFG, device="cpu"))) == 0


def test_a_prn_subset_has_its_own_key(fresh_tables):
    """A directed searcher's PRN subset builds its own tables, those of
    a fresh build of the subset, and leaves the full set's in place."""
    full = _tables(FoldedSearcher(CFG, device="cpu"))
    sub_cfg = dataclasses.replace(CFG, prns=(2, 5, 7))
    sub = FoldedSearcher(sub_cfg, device="cpu")
    assert _builds(lambda: _tables(sub)) == 2
    got = _tables(sub)
    assert got[0].shape == (3, sub.nf)
    spec, (cr, ci) = _fresh_build(sub_cfg, sub.nf, sub.period)
    for t, want in zip(got, (spec, cr, ci), strict=True):
        np.testing.assert_array_equal(t.numpy(), want)
    for x, y in zip(full, _tables(FoldedSearcher(CFG, device="cpu")),
                    strict=True):
        assert x is y


def test_threads_asking_at_once_build_once(fresh_tables, monkeypatch):
    """Four threads that ask for one new key together (the build slowed,
    so that they overlap) get one tensor, built once."""
    spectra_np = folded.replica_spectra_np

    def slow(*args):
        time.sleep(0.05)
        return spectra_np(*args)
    monkeypatch.setattr(folded, "replica_spectra_np", slow)
    start = threading.Barrier(4)
    got = []

    def ask():
        start.wait()
        got.append(FoldedSearcher(CFG, device="cpu").code_ffts_p)

    def block():
        threads = [threading.Thread(target=ask) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert _builds(block) == 1
    assert len(got) == 4 and all(t is got[0] for t in got)


def test_searches_leave_the_tables_unchanged(fresh_tables):
    """Every engine of the searcher, the mesh's included, reads the
    shared tables and writes nothing into them."""
    s = FoldedSearcher(CFG, device="cpu")
    before = [t.clone() for t in _tables(s)]
    bits = np.random.default_rng(7).integers(0, 2, 2 * s.block_len,
                                             dtype=np.uint8)
    s.detections_refined_fast(bits=bits, n_noncoherent=2)
    s.detections_refined_sharded(bits=bits,
                                 mesh=make_mesh(2, ("dop",), device="cpu"))
    s.acquire(bits=bits, engine="mxu")
    s.detections_refined(s.power_grid(bits=bits), 1)
    s.acquire_packed(bits)
    for t, want in zip(_tables(s), before, strict=True):
        assert torch.equal(t, want)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """1 s of the e2e scene recipe (6 SVs at 2.048 Msps) as 1-bit IF."""
    iq, _, _ = scene.build_scene(duration=1.0)
    path = tmp_path_factory.mktemp("torch_search_tables") / "cap_1bit.bin"
    scene.write_1bit_capture(iq, CFG.fc, FS, path)
    return str(path)


@pytest.mark.parametrize("engine", ["mxu", "xla"])
def test_a_second_receiver_builds_no_table(capture, engine, fresh_tables):
    """Two receivers of one process, one after the other: the first
    capture builds the tables its engine reads, the second none, and
    both detect the same PRNs, Dopplers and code phases, bit for bit."""
    runs = []

    def run():
        recv = Receiver(CFG, acq_engine=engine, device="cpu")
        runs.append(recv.process_source(FileSource1Bit(capture, CFG),
                                        max_duration_s=1.0))
    assert _builds(run) == {"mxu": 2, "xla": 1}[engine]
    assert _builds(run) == 0
    a, b = runs
    assert len(a.detections) >= 4
    key = lambda r: [(d["prn"], d["doppler_hz"], d["ca_shift"])
                     for d in r.detections]
    assert key(a) == key(b)
