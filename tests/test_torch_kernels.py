"""Kernel build/launch plumbing of the port, as far as a CPU can check it.

The CUDA kernels themselves run only on the card (``chip_smoke.py``);
here: the wrappers' device dispatch, the build's source hashing and its
error without nvcc, and the thread-safe launch counter.
"""

import os
import shutil
import sys
import threading

import pytest
import torch

from tpu_gnss_torch import kernels
from tpu_gnss_torch.ops import mxu_corr, mxu_track, onebit
from tests.torch_threads import one_torch_thread  # noqa: F401


def _calls(device):
    """One call of each kernel wrapper at a small shape on ``device``."""
    nf = period = 2048
    n1, n2 = mxu_corr.split_nf(nf)
    u_rows = mxu_corr.four_step_np(nf, period)["u_rows"]
    z = lambda *shape: torch.zeros(*shape, device=device)
    return {
        "fold_corr_reduce": lambda: mxu_corr.fold_corr_reduce(
            z(2, 1, u_rows, n1), z(2, 1, u_rows, n1), z(n2, n1), z(n2, n1),
            period=period, nf=nf),
        "track_corr": lambda: mxu_track.track_corr(
            z(1, u_rows, n1), z(1, u_rows, n1), z(1, 1, 5), z(n2, n1),
            z(n2, n1), period=period, nf=nf),
        "mix_packed": lambda: onebit.mix_packed(
            torch.zeros(4, dtype=torch.int32, device=device), n_bits=100,
            lo_rate=1.0),
        "corr_reduce": lambda: mxu_corr.corr_reduce(
            z(2, n1, n2), z(2, n1, n2), z(1, n1, n2), z(1, n1, n2),
            period=period),
    }


KERNELS = ["fold_corr_reduce", "track_corr", "mix_packed", "corr_reduce"]


@pytest.mark.parametrize("name", KERNELS)
def test_wrappers_reject_other_devices(name):
    with pytest.raises(ValueError):
        _calls("meta")[name]()


@pytest.mark.parametrize("name", KERNELS)
def test_cpu_tensors_never_touch_the_library(name):
    """The plain path runs and counts no launch on CPU tensors."""
    kernels.LAUNCHES.reset()
    _calls("cpu")[name]()
    assert kernels.LAUNCHES.get(name) == 0
    assert kernels._lib is None


def test_library_path_hashes_sources():
    p = kernels.library_path()
    assert p.parent == kernels.BUILD_DIR
    assert p.name.startswith("libtpu_gnss_torch_") and p.suffix == ".so"
    assert p == kernels.library_path()
    names = {s.name for s in kernels._sources()}
    assert {"fold_corr_reduce.cu", "track_corr.cu", "mix_packed.cu",
            "corr_reduce.cu", "common.cuh"} <= names


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed here")
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build()


def test_launch_counter_threads():
    """Concurrent adds from more threads than cores lose no update."""
    counter = kernels.LaunchCounter()
    n_threads, n_adds = 2 * (os.cpu_count() or 2), 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(
            target=lambda: [counter.add("k") for _ in range(n_adds)])
            for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert counter.get("k") == n_threads * n_adds
    counter.reset()
    assert counter.get("k") == 0
