"""``tpu_gnss_torch.cache``: what the port builds once per process.

The contract of ``cache.once``, run against each registry that uses it
(the prewarms' record, the shared trackers, the search tables and a
kernel device table): threads that ask for one new key together build it
once and share it, a slow build holds up no other key, a failed build
stores nothing, a bounded store drops its least recently used key, and
``cache.clear()`` empties every store, so that the process builds anew.
"""

import threading
import time

import pytest
import torch

from tpu_gnss.config import ReceiverConfig
from tpu_gnss_torch import cache, receiver
from tpu_gnss_torch.acquire import folded
from tpu_gnss_torch.acquire.folded import FoldedSearcher
from tpu_gnss_torch.ops import mxu_corr, mxu_track, onebit
from tpu_gnss_torch.track import channel as tc
from tpu_gnss_torch.track import graph
from tpu_gnss_torch.utils.metrics import METRICS
from tests.torch_threads import one_torch_thread  # noqa: F401

CFG = ReceiverConfig(fs=2.048e6, fc=0.512e6, max_fo=5000.0)
TRACKER = dict(fs=2.048e6, pll_gains=tc.second_order_gains(18.0, 0.01),
               dll_gains=tc.second_order_gains(2.0, 0.01), device="cpu")
# each registry, read from its module at call time
STORES = {
    "prewarms": lambda: receiver._WARMED,
    "trackers": lambda: graph._SHARED,
    "search_tables": lambda: folded._TABLES,
    "part2_table": lambda: onebit.part2_table.store,
}
DEVICE_TABLES = [onebit.part2_table, mxu_corr.idft_tables,
                 mxu_corr.fused_tables, mxu_corr.mma_tables,
                 mxu_track.track_tables, mxu_track.tap_factors,
                 tc._gather_tables]
KEY, OTHER = ("test_torch_cache", 1), ("test_torch_cache", 2)


@pytest.fixture(autouse=True)
def saved_stores():
    """Every registered store as it was before the test, restored after."""
    saved = [(s, list(s.items())) for s in cache._STORES]
    yield
    for s, items in saved:
        s.clear()
        s.update(items)


def _threads(targets):
    threads = [threading.Thread(target=t) for t in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


@pytest.mark.parametrize("name", sorted(STORES))
def test_threads_asking_for_a_new_key_build_it_once(name):
    """Four threads that ask together (the build slowed, so that they
    overlap) get one object, built once and counted once."""
    store = STORES[name]()
    builds, got = [], []
    start = threading.Barrier(4)

    def build():
        builds.append(1)
        time.sleep(0.05)
        return object()

    def ask():
        start.wait()
        got.append(cache.once(store, KEY, build,
                              counter="acquire.table_builds"))
    before = METRICS.counters["acquire.table_builds"]
    _threads([ask] * 4)
    assert len(builds) == 1
    assert METRICS.counters["acquire.table_builds"] - before == 1
    assert len(got) == 4 and all(g is got[0] for g in got)
    assert store[KEY] is got[0]


@pytest.mark.parametrize("name", sorted(STORES))
def test_a_slow_build_holds_up_no_other_key(name):
    """While one key's build waits to be released, another key is built
    and read; only then is the first build released."""
    store = STORES[name]()
    started, release = threading.Event(), threading.Event()
    released = []

    def slow():
        started.set()
        released.append(release.wait(10))
        return "slow"
    t = threading.Thread(target=lambda: cache.once(store, KEY, slow))
    t.start()
    try:
        assert started.wait(10)
        assert cache.once(store, OTHER, lambda: "fast") == "fast"
        assert cache.once(store, OTHER, lambda: "again") == "fast"
    finally:
        release.set()
        t.join()
    assert released == [True]
    assert store[KEY] == "slow"


@pytest.mark.parametrize("name", sorted(STORES))
def test_a_failed_build_stores_nothing(name):
    """A build that raises raises to its caller and leaves no entry; the
    next caller builds again."""
    store = STORES[name]()

    def fail():
        raise ValueError("build failed")
    with pytest.raises(ValueError, match="build failed"):
        cache.once(store, KEY, fail)
    assert KEY not in store
    assert cache.once(store, KEY, lambda: "built") == "built"
    assert store[KEY] == "built"


@pytest.mark.parametrize("name", sorted(STORES))
def test_a_bounded_store_drops_its_least_recently_used_key(name):
    """With a bound of 2: a hit makes its key the newest, so a third key
    drops the other one."""
    store = STORES[name]()
    store.clear()
    for k in ("a", "b"):
        cache.once(store, k, lambda k=k: k.upper(), bound=2)
    assert cache.once(store, "a", lambda: "new", bound=2) == "A"
    cache.once(store, "c", lambda: "C", bound=2)
    assert list(store.items()) == [("a", "A"), ("c", "C")]


@pytest.mark.parametrize("name", sorted(STORES))
def test_clear_empties_the_store(name):
    store = STORES[name]()
    cache.once(store, KEY, object)
    cache.clear()
    assert len(store) == 0


@pytest.mark.parametrize("fn", DEVICE_TABLES, ids=lambda f: f.__name__)
def test_device_tables_are_built_once(fn):
    """Each kernel device table goes through ``cache.once``, in a store
    that ``cache.clear()`` empties."""
    assert fn.__wrapped__ is not None
    assert any(s is fn.store for s in cache._STORES)


def test_after_clear_the_process_builds_anew():
    """After ``cache.clear()`` a searcher builds its spectra again (one
    ``acquire.table_builds``), ``shared_tracker`` gives a new tracker and
    a device table is a new tensor, equal to the old."""
    def builds(block):
        before = METRICS.counters["acquire.table_builds"]
        got = block()
        return METRICS.counters["acquire.table_builds"] - before, got
    _, spectra = builds(lambda: FoldedSearcher(CFG, device="cpu").code_ffts_p)
    assert builds(lambda: FoldedSearcher(CFG, device="cpu").code_ffts_p) == (
        0, spectra)
    tracker = graph.shared_tracker(**TRACKER)
    table = onebit.part2_table(0.25, "cpu")
    cache.clear()
    n, fresh = builds(lambda: FoldedSearcher(CFG, device="cpu").code_ffts_p)
    assert n == 1 and fresh is not spectra and torch.equal(fresh, spectra)
    assert graph.shared_tracker(**TRACKER) is not tracker
    assert graph.shared_tracker(**TRACKER) is graph.shared_tracker(**TRACKER)
    again = onebit.part2_table(0.25, "cpu")
    assert again is not table and torch.equal(again, table)


def test_receivers_prewarming_together_run_the_seeder_once(monkeypatch):
    """Two receivers whose seeder prewarms (run as on a card) overlap:
    one runs it, the other waits for it and reports that it did not."""
    runs = []

    def slow_start(*args):
        runs.append(1)
        time.sleep(0.1)
    monkeypatch.setattr(tc, "init_state", lambda n, dev: None)
    monkeypatch.setattr(tc, "start_channels", slow_start)
    receiver._WARMED.clear()
    recvs = [receiver.Receiver(CFG, device="cpu") for _ in range(2)]
    for r in recvs:
        r.device = torch.device("cuda")
    start = threading.Barrier(2)
    _threads([lambda r=r: (start.wait(), r._prewarm_seeder(12))
              for r in recvs])
    assert len(runs) == 1
    assert sorted(r.prewarm_stats["seeder_ran"] for r in recvs) == [False,
                                                                    True]
