"""The port's boot warmup (``tpu_gnss_torch.cli.warmup``) and the kernel
library's cache root, on the CPU: no nvcc, no card.

The warmup runs with the arguments of the reference's own test
(tests/test_cli.py:102-128) plus ``--device cpu``; its noise pass gives
the JAX ``Receiver``'s detections on the same seed-0 noise file.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_gnss.config import ReceiverConfig as JaxConfig
from tpu_gnss.io import loaders as jloaders
from tpu_gnss.io import stream as jstream
from tpu_gnss.receiver import Receiver as JaxReceiver
from tpu_gnss_torch import kernels
from tpu_gnss_torch.cli import warmup
from tpu_gnss_torch.config import ReceiverConfig
from tpu_gnss_torch.io.stream import FileSource1Bit, IQFileSource
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_cli.py:116-118
REF_ARGS = ["0.512e6", "2.048e6", "5000", "--fft-len", "4096",
            "--chunk-s", "1", "--channels", "4"]
CFG = dict(fs=2.048e6, fc=0.512e6, max_fo=5000.0, fft_len=4096,
           snr_threshold=25.0, num_chans=4)


def _reference_noise(path, fmt, n):
    """The reference warmup's noise recipe (tpu_gnss/cli/warmup.py:
    85-101), written with the reference's packer."""
    rng = np.random.default_rng(0)
    if fmt == "1bit":
        bits = rng.integers(0, 2, n, dtype=np.uint8)
        with open(path, "wb") as f:
            f.write(jloaders.pack_1bit(bits))
        return
    raw = rng.integers(0, 256, 2 * n).astype(np.uint8)
    if fmt == "iq8":
        raw = raw.view(np.int8)
    raw.tofile(path)


@pytest.mark.parametrize("fmt, kind", [("1bit", FileSource1Bit),
                                       ("iq8", IQFileSource),
                                       ("iqu8", IQFileSource)])
def test_noise_file_is_the_reference_recipe(tmp_path, fmt, kind):
    cfg = ReceiverConfig(**CFG)
    n = 100_000
    src = warmup.write_noise(str(tmp_path / "port.bin"), fmt, n, cfg)
    _reference_noise(str(tmp_path / "ref.bin"), fmt, n)
    assert isinstance(src, kind)
    if kind is IQFileSource:
        assert src.dtype == ("int8" if fmt == "iq8" else "uint8")
    assert ((tmp_path / "port.bin").read_bytes()
            == (tmp_path / "ref.bin").read_bytes())


def test_warmup_cpu_matches_jax_receiver(tmp_path, monkeypatch, capsys):
    """The reference test's arguments plus ``--device cpu``: exit 0, the
    report line, ``--cache-dir`` as the cache root of this process, no
    build; the pass gives the JAX receiver's detections (none at
    threshold 25) on the same noise."""
    monkeypatch.setenv(kernels.CACHE_ENV, str(tmp_path / "other"))
    root = tmp_path / "cache"
    passes = []
    real = warmup.noise_pass

    def spy(*a, **kw):
        passes.append(real(*a, **kw))
        return passes[-1]

    monkeypatch.setattr(warmup, "noise_pass", spy)
    assert warmup.main(REF_ARGS + ["--cache-dir", str(root),
                                   "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and out[0].startswith("warmup: pipeline pass ")
    assert "on cpu; no kernel library built" in out[0]
    assert out[0].endswith(
        "launches fold_corr_reduce=0 track_corr=0 mix_packed=0 "
        "loop_update=0")
    assert os.environ[kernels.CACHE_ENV] == str(root)
    assert kernels.library_path().parent == root
    assert not root.exists() and kernels._lib is None
    (res,) = passes

    cfg = JaxConfig(**CFG)
    path = str(tmp_path / "noise.bin")
    _reference_noise(path, "1bit", int(2 * 1.0 * cfg.fs))
    want = JaxReceiver(cfg).process_source(
        jstream.FileSource1Bit(path, cfg), chunk_s=1.0)
    got = [(d["prn"], d["lo_shift"], d["ca_shift"]) for d in res.detections]
    assert got == [(d["prn"], d["lo_shift"], d["ca_shift"])
                   for d in want.detections] == []
    assert res.solutions == [] and want.solutions == []


def test_warmup_cuda_without_a_card_fails(tmp_path):
    """``--device cuda`` on a machine without a card exits non-zero with
    ``resolve_device``'s error, before anything is built or run."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run(
        [sys.executable, "-m", "tpu_gnss_torch.cli.warmup", *REF_ARGS,
         "--cache-dir", str(tmp_path / "cache"), "--device", "cuda"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr
    assert "warmup:" not in r.stdout
    assert not (tmp_path / "cache").exists()


def test_library_path_follows_the_cache_root(tmp_path, monkeypatch):
    """The library lies under ``$TPU_GNSS_TORCH_CACHE_DIR``, read at each
    call, and under ``build/tpu_gnss_torch/`` when it is unset; the name
    (the hash of the sources and flags) is the same in both."""
    monkeypatch.setenv(kernels.CACHE_ENV, str(tmp_path))
    in_root = kernels.library_path()
    assert in_root.parent == tmp_path
    monkeypatch.delenv(kernels.CACHE_ENV)
    default = kernels.library_path()
    assert default.parent == kernels.BUILD_DIR
    assert kernels.BUILD_DIR.parts[-2:] == ("build", "tpu_gnss_torch")
    assert kernels.BUILD_DIR.parent.parent == kernels.CSRC.parent.parent
    assert in_root.name == default.name
    assert list(tmp_path.iterdir()) == []
