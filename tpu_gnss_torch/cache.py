"""State that the port builds once per process and hands to every later
caller.

The record of the prewarms that ran (:mod:`tpu_gnss_torch.receiver`),
the shared trackers (:func:`tpu_gnss_torch.track.graph.shared_tracker`),
the search's tables (:mod:`tpu_gnss_torch.acquire.folded`) and the
kernels' device tables (the :func:`built_once` functions of ``ops/`` and
``track/``) are each a :func:`store` read through :func:`once`, and
:func:`clear` empties them all: the one reset to a fresh process.  Host
memos, which hold no device memory, keep ``functools.lru_cache``.
"""

from __future__ import annotations

import functools
import threading
from collections import OrderedDict
from typing import Optional

from .utils.metrics import METRICS

_LOCK = threading.Lock()
_STORES: list = []
# the builds running now, by (id of the store, key): the event their
# waiters wait for
_BUILDING: dict = {}


def store() -> OrderedDict:
    """A new empty store, registered for :func:`clear`."""
    s = OrderedDict()
    with _LOCK:
        _STORES.append(s)
    return s


def clear() -> None:
    """Empty every registered store, as in a fresh process (a build
    running meanwhile stores its value when it ends).  Only for a point
    after which nothing built before runs again: a CUDA graph captured
    before reads device tables that the stores no longer keep alive."""
    with _LOCK:
        for s in _STORES:
            s.clear()


def once(store: OrderedDict, key, build, *, bound: Optional[int] = None,
         counter: Optional[str] = None):
    """The value of ``key`` in ``store``, made by ``build()`` on a miss.

    Exactly one caller builds a key, and holds no lock while it does;
    other callers of that key wait for the build and get its value, and
    callers of other keys do not wait.  A build that raises stores
    nothing and raises to its own caller; a waiting or later caller then
    builds again.  A hit makes the key the newest; with ``bound``, an
    insert beyond ``bound`` keys drops the oldest.  Each build adds 1 to
    the ``METRICS`` counter ``counter``, when given.
    """
    while True:
        with _LOCK:
            if key in store:
                store.move_to_end(key)
                return store[key]
            done = _BUILDING.get((id(store), key))
            if done is None:
                done = _BUILDING[id(store), key] = threading.Event()
                break
        done.wait()
    try:
        value = build()
        with _LOCK:
            store[key] = value
            while bound is not None and len(store) > bound:
                store.popitem(last=False)
    finally:
        with _LOCK:
            del _BUILDING[id(store), key]
        done.set()
    if counter is not None:
        METRICS.add(counter)
    return value


def built_once(bound: int):
    """Decorator: the function's value for each tuple of positional
    arguments, made through :func:`once` in a store of its own (the
    wrapper's ``store``) of at most ``bound`` keys."""
    def wrap(fn):
        s = store()

        @functools.wraps(fn)
        def get(*args):
            return once(s, args, lambda: fn(*args), bound=bound)
        get.store = s
        return get
    return wrap
