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
from tpu_gnss_torch.track import channel
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
        "loop_update": lambda: channel.loop_update(
            z(10, 3, 6), z(12, 3), z(1), z(10, 3, 5), z(7, 20, 3), 1,
            channel.loop_opts(fs=2.048e6, pll_gains=(1.0, 1.0),
                              dll_gains=(1.0, 1.0), epochs_per_step=10)),
    }


KERNELS = ["fold_corr_reduce", "track_corr", "mix_packed", "corr_reduce",
           "loop_update"]


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
            "corr_reduce.cu", "loop_update.cu", "common.cuh"} <= names
    assert set(KERNELS) == set(kernels.KERNELS)


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


def test_launches_recorded_under_capture_count_at_replay(monkeypatch):
    """A launch made while the current stream is capturing a CUDA graph
    is recorded, not run: it goes to the thread's ``recording`` tally
    and not to ``LAUNCHES``; outside a capture it counts at once."""
    kernels.LAUNCHES.reset()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with kernels.recording() as tally:
        for _ in range(3):
            kernels.launched("track_corr")
        kernels.launched("loop_update")
    kernels.launched("loop_update")        # a capture with no tally
    assert tally == {"track_corr": 3, "loop_update": 1}
    assert kernels.LAUNCHES.get("track_corr") == 0
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    kernels.launched("loop_update")
    for name, n in tally.items():          # what a replay adds
        kernels.LAUNCHES.add(name, n)
    assert kernels.LAUNCHES.get("track_corr") == 3
    assert kernels.LAUNCHES.get("loop_update") == 2
    kernels.LAUNCHES.reset()
