"""Shared pieces of the benchmark's CPU tests: a test-size cell that the
harness drives on the CPU (the port's plain paths), and the ``chip``
marker for tests that need the card."""

from __future__ import annotations

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA card; skips without one")


def tiny_cell(fmt: str = "1bit", capture_s: float = 4.0, sample: int = 1,
              start: str = "cold", streams: int = 1, distinct: int = 1,
              warm_captures: int = 0, sky: str = "e2e"):
    """A test-size cell: the configuration's own file at 2.048 Msps (an
    e2e-width search), by default one 4 s capture of the e2e sky from a
    cold start in one stream, compared whole.  A warm start is held to a
    fix, as a capture of 20 s or more is."""
    name = "nottingham_1bit" if fmt == "1bit" else "hackrf_iq8"
    with open(os.path.join(ROOT, "gnss_bench", "configs",
                           name + ".json")) as f:
        cfg = json.load(f)
    cfg.update(fs=2.048e6, fc=0.512e6, fft_len=4096)
    if fmt == "iq8":
        cfg.update(max_fo=20000.0)
        cfg["scene"] = dict(cfg["scene"], offset_hz=[12000.0, 15000.0])
    traffic = dict(capture_s=capture_s, distinct=distinct,
                   max_written_mb=100, warm_captures=warm_captures,
                   sample=sample, fix=capture_s >= 20.0 or start == "warm",
                   traced_captures=1, start=start, streams=streams,
                   sky=sky)
    return dict(name="test." + fmt, chips=1), cfg, traffic


@pytest.fixture
def cpu_run(tmp_path, monkeypatch):
    """``run.run_cell`` of a test-size cell on the CPU, captures under
    ``tmp_path``."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import torch
    torch.set_num_threads(2)
    from gnss_bench import run

    def go(fmt="1bit", seed=20251017, controls=(), **kw):
        cell, cfg, traffic = tiny_cell(fmt, **kw)
        return run.run_cell(cell, cfg, traffic, seed, 0.05, False, "cpu",
                            controls=controls)
    return go
