"""``BENCHMARK.json`` against the contract's names, units and limits, and
every file that it names."""

from __future__ import annotations

import json
import os
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.fixture(scope="module")
def m():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_command(m):
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["gnss_bench"]
    assert all(PATH.match(p) and not p.endswith("_torch")
               for p in m["paths"])
    assert m["command"] == ["python3", "gnss_bench/run.py"]
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    cells = len(m["workloads"])
    # a full check: 2 + 14 runs a cell, each allowed run_seconds + 60,
    # 2 x 90 s a cell to compile, 1200 s spare, for 24 cells
    assert (2 + 14 * 24) * (m["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 65536
    assert 1 <= cells <= 24


def test_configs(m):
    names = set()
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert line(c["source"]) and c["source"].startswith("https://")
        assert line(c["why"])
        assert c["file"].startswith("gnss_bench/") and PATH.match(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and k in cfg for k in c["reduced"])
        assert "limits" in cfg and "gates" in cfg
    assert len({c["file"] for c in m["configs"]}) == len(m["configs"])
    used = {w["config"] for w in m["workloads"]}
    assert used == names


def test_workloads(m):
    seen, pairs = set(), set()
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["name"] not in seen
        seen.add(w["name"])
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert line(w["why"])
        assert os.path.exists(os.path.join(
            ROOT, "gnss_bench", "traffic", w["traffic"] + ".json"))
    four = sum(w["chips"] == 4 for w in m["workloads"])
    assert four <= max(1, len(m["workloads"]) // 4)


def test_metrics(m):
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert {"realtime_x", "capture_p90_ms", "setup_s"} <= set(e2e)
    cells = {w["name"] for w in m["workloads"]}
    for w in cells:
        # every cell reports setup_s and another end-to-end metric
        has = {x["name"] for x in m["end_to_end"]
               if w in x.get("workloads", cells)}
        assert "setup_s" in has and len(has) >= 2, w
    for x in m["end_to_end"] + m["per_layer"]:
        assert set(x.get("workloads", cells)) <= cells
    for x in m["end_to_end"]:
        assert set(x) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    assert e2e["setup_s"]["bound"] <= 0.25
    names = set(e2e)
    layers = {}
    for x in m["per_layer"]:
        assert set(x) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(x["name"]) and x["name"] not in names
        names.add(x["name"])
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
        assert x["source"] in SOURCES and line(x["layer"])
        assert x["moves"] in e2e
        assert os.path.exists(os.path.join(
            ROOT, "gnss_bench", "metrics", x["name"] + ".py"))
        if x["name"].endswith("_roofline") or "roofline" in x["name"]:
            assert x["unit"] == "%"
        layers.setdefault(x["name"].split(".")[0], set()).add(x["layer"])
    assert all(len(v) == 1 for v in layers.values())
    # every entry has its reader, and every reader its entry
    readers = {f[:-3] for f in os.listdir(os.path.join(
        ROOT, "gnss_bench", "metrics")) if f.endswith(".py")}
    assert readers == {x["name"] for x in m["per_layer"]}


def test_every_key_of_a_mix_and_a_loop_is_read(m):
    from gnss_bench import run
    for w in m["workloads"]:
        _, cfg, traffic, _ = run.cell_spec(w["name"])
        assert set(traffic) == run.TRAFFIC_KEYS
        assert set(cfg["loop"]) == run.LOOP_KEYS
        assert cfg["transfer"] in ("int8", "int4", "int2", "float32")


@pytest.mark.parametrize("where, key", [("traffic", "arrival_hz"),
                                        ("configs", "loop_kind")])
def test_a_key_the_harness_does_not_read_is_refused(monkeypatch, where,
                                                    key):
    from gnss_bench import run
    orig = run.load_json

    def extra(*parts):
        d = orig(*parts)
        if where in parts[-1] or where in parts:
            if where == "configs":
                d = dict(d, loop=dict(d["loop"], **{key: 1}))
            else:
                d = dict(d, **{key: 8})
        return d
    monkeypatch.setattr(run, "load_json", extra)
    with pytest.raises(SystemExit, match=key):
        run.cell_spec("nottingham_1bit.replay20")


def test_a_loop_setting_the_program_fixes_is_refused_where_it_differs():
    from types import SimpleNamespace

    from gnss_bench import run
    recv = SimpleNamespace(_tracker=SimpleNamespace(
        _kw=dict(fll_bn_hz=3.0, corr_spacing=0.5)))
    loop = dict(fll_bn_hz=3.0, corr_spacing=0.5)
    assert run.unheeded(recv, loop) == []
    assert run.unheeded(recv, dict(loop, corr_spacing=0.25)) == [
        "corr_spacing: configuration 0.25, program 0.5"]


@pytest.mark.parametrize("fmt", ["1bit", "iq8"])
def test_the_program_runs_each_configurations_fixed_loop_settings(fmt):
    # the check reads a real receiver's tracker, and both files agree
    from conftest import tiny_cell

    from gnss_bench import run
    from tpu_gnss_torch.receiver import Receiver
    _, cfg, _ = tiny_cell(fmt)
    lp = cfg["loop"]
    recv = Receiver(run.receiver_config(cfg), pll_bn_hz=lp["pll_bn_hz"],
                    dll_bn_hz=lp["dll_bn_hz"], n_coherent=cfg["n_coherent"],
                    epochs_per_step=lp["epochs_per_step"],
                    transfer_dtype=cfg["transfer"], device="cpu")
    assert {"fll_bn_hz", "corr_spacing"} <= set(recv._tracker._kw)
    assert run.unheeded(recv, lp) == []
    assert run.unheeded(recv, dict(lp, fll_bn_hz=5.0)) != []
