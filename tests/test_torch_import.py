"""The port imports torch and never jax nor the JAX package ``tpu_gnss``,
in a fresh interpreter."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, importlib.util, pkgutil, sys
import tpu_gnss_torch
names = ["tpu_gnss_torch"] + [
    m.name for m in pkgutil.walk_packages(tpu_gnss_torch.__path__,
                                          "tpu_gnss_torch.")]
for n in names:
    importlib.import_module(n)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m in ("jax", "tpu_gnss") or m.startswith(("jax.", "tpu_gnss.")))
missing = {"tpu_gnss_torch.utils.xfer", "tpu_gnss_torch.cli.nmea_out",
           "tpu_gnss_torch.io.stream", "tpu_gnss_torch.io.loaders"} - set(names)
assert not missing, missing
print(len(names), bad)
assert not bad, bad
assert "torch" in sys.modules
"""


def test_port_never_imports_jax():
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH",)}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 30


def test_no_import_statement_names_the_reference():
    """No import statement of the port or of chip_smoke.py names
    ``tpu_gnss`` or a ``tpu_gnss.*`` module (lazy imports included)."""
    import ast
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "tpu_gnss_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    bad = []
    for f in files:
        with open(f) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    and node.level == 0 else [])
            bad += [f"{f}:{node.lineno} {m}" for m in mods
                    if m == "tpu_gnss" or m.startswith("tpu_gnss.")]
    assert len(files) >= 30 and not bad, bad
