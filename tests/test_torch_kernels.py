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
from tpu_gnss_torch.ops import mxu_corr, mxu_track


def test_wrappers_reject_other_devices():
    nf = period = 2048
    n1, n2 = mxu_corr.split_nf(nf)
    u_rows = mxu_corr.four_step_np(nf, period)["u_rows"]
    x = torch.zeros(1, 1, u_rows, n1, device="meta")
    cw = torch.zeros(n2, n1, device="meta")
    with pytest.raises(ValueError):
        mxu_corr.fold_corr_reduce(x, x, cw, cw, period=period, nf=nf)
    blk = torch.zeros(1, u_rows, n1, device="meta")
    par = torch.zeros(1, 1, 5, device="meta")
    with pytest.raises(ValueError):
        mxu_track.track_corr(blk, blk, par, cw, cw, period=period, nf=nf)


def test_cpu_tensors_never_touch_the_library():
    """The plain path runs and counts no launch on CPU tensors."""
    kernels.LAUNCHES.reset()
    nf = period = 2048
    n1, n2 = mxu_corr.split_nf(nf)
    u_rows = mxu_corr.four_step_np(nf, period)["u_rows"]
    x = torch.randn(2, 1, u_rows, n1)
    cw = torch.randn(n2, n1)
    mxu_corr.fold_corr_reduce(x, x, cw, cw, period=period, nf=nf)
    assert kernels.LAUNCHES.get("fold_corr_reduce") == 0
    assert kernels._lib is None


def test_library_path_hashes_sources():
    p = kernels.library_path()
    assert p.parent == kernels.BUILD_DIR
    assert p.name.startswith("libtpu_gnss_torch_") and p.suffix == ".so"
    assert p == kernels.library_path()
    names = {s.name for s in kernels._sources()}
    assert {"fold_corr_reduce.cu", "track_corr.cu", "common.cuh"} <= names


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
