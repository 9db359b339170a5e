"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference side imports nothing of the program; compared by whole
top-level names, since ``tpu_gnss_torch`` begins with ``tpu_gnss``."""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys

from conftest import ROOT
from gnss_bench import run

BENCH = os.path.join(ROOT, "gnss_bench")


def imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(BENCH, sub)):
        if os.sep + "tests" in dirpath:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_jax_anywhere():
    for path in sources():
        assert not set(imports(path)) & set(run.FORBIDDEN), path


def test_reference_side_imports_nothing_of_the_program():
    for sub in ("gen", "ref", "roofline", "metrics"):
        for path in sources(sub):
            assert "tpu_gnss_torch" not in set(imports(path)), path
    assert "tpu_gnss_torch" not in set(imports(os.path.join(BENCH,
                                                            "trace.py")))


def test_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpu_gnss_torch_fake", sys)
    for name in run.FORBIDDEN:
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tpu_gnss.receiver", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert run.forbidden_modules() == ["jaxlib", "tpu_gnss"]


def test_fails_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "gnss_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run(
        [sys.executable, "gnss_bench/run.py", "--workload",
         "nottingham_1bit.cold4", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120, env=dict(os.environ, PYTHONPATH=""))
    assert r.returncode != 0
    assert not r.stdout.strip()
