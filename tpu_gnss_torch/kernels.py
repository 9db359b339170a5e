"""Build, load and launch the CUDA kernels in ``csrc/``.

The sources are compiled by ``nvcc`` for ``sm_90a`` (one process per
``.cu`` file, all started together) and linked into one shared library
with a plain C interface, loaded with :mod:`ctypes`.  The build
runs at first use (or ahead of a session, by ``cli.warmup``) and lands
in the cache root: the directory that ``$TPU_GNSS_TORCH_CACHE_DIR``
names, read at each call, else ``build/tpu_gnss_torch/`` beside the
package (git-ignored).  The library is keyed on a hash of the sources
and flags, so a fresh cache root builds exactly once and an edited
source can never load stale code.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0.
Nothing here runs at import time.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "tpu_gnss_torch"
# the environment variable naming the cache root (the counterpart of the
# reference's JAX_COMPILATION_CACHE_DIR)
CACHE_ENV = "TPU_GNSS_TORCH_CACHE_DIR"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# per-block dynamic shared memory a kernel may take on Hopper (227 KB,
# less a margin for the reductions' static arrays)
SMEM_LIMIT = 227 * 1024 - 1024

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: every pointer and the stream as c_void_p (a bare Python
# int would be passed as a 32-bit int and cut the pointer), every float
# as c_float (an undeclared Python float would be passed as a double)
_SIGNATURES = {
    "fold_corr_reduce_launch": [_P] * 14 + [_I] * 8 + [_P],
    "track_corr_launch": [_P] * 10 + [_I] * 6 + [_P],
    "mix_packed_launch": [_P] * 3 + [_I] + [_F] * 2 + [_I] * 2 + [_P],
    "corr_reduce_launch": [_P] * 10 + [_I] * 7 + [_P],
    "loop_update_launch": [_P] * 5 + [_I] * 7 + [_F] * 12 + [_P],
}
# the kernels' names, as LAUNCHES counts them
KERNELS = tuple(k.removesuffix("_launch") for k in _SIGNATURES)

_lock = threading.Lock()
_lib = None
BUILD_SECONDS = None   # wall time of the build in this process (None: cached)
BUILD_LOG = ""         # nvcc's output of that build


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(PATH and /usr/local/cuda/bin searched)")


def library_path() -> Path:
    """The library in the cache root (``$TPU_GNSS_TORCH_CACHE_DIR`` if
    set, else :data:`BUILD_DIR`), named by the hash of the sources and
    flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    root = Path(os.environ.get(CACHE_ENV) or BUILD_DIR)
    return root / f"libtpu_gnss_torch_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` unless the hashed library already exists.

    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory, spills per
    kernel) to a fresh build; its output is kept in :data:`BUILD_LOG`.
    A build says so on stderr, with its seconds.
    """
    global BUILD_SECONDS, BUILD_LOG
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        # one nvcc per source, all started together, then one link
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        jobs = []
        for cu in (p for p in _sources() if p.suffix == ".cu"):
            obj = os.path.join(tmp, cu.stem + ".o")
            cmd = ([nvcc] + compile_flags
                   + (["-Xptxas", "-v"] if verbose else [])
                   + ["-I", str(CSRC), "-c", "-o", obj, str(cu)])
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for cmd, _, proc in jobs:
            logs.append(proc.communicate()[0])
            if proc.returncode != 0:
                failed.append(" ".join(cmd))
        BUILD_LOG = "".join(logs)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed) + "\n"
                               + BUILD_LOG)
        so = os.path.join(tmp, "lib.so")
        cmd = [nvcc] + NVCC_FLAGS + ["-o", so] + [obj for _, obj, _ in jobs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        BUILD_LOG += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               + " ".join(cmd) + "\n" + BUILD_LOG)
        os.replace(so, out)  # atomic: a concurrent loader never sees half
    BUILD_SECONDS = time.perf_counter() - t0
    print(f"tpu_gnss_torch: built {out.name} in {out.parent} "
          f"(nvcc {BUILD_SECONDS:.2f} s)", file=sys.stderr, flush=True)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(name: str, err: int) -> None:
    """Raise when a launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


class LaunchCounter:
    """Thread-safe count of kernel launches, by kernel name.

    Each wrapper adds one where it launches its kernel and nowhere else,
    so a run can show that the main path went through the kernels.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._n: dict[str, int] = {}

    def add(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._n[name] = self._n.get(name, 0) + n

    def get(self, name: str) -> int:
        with self._lock:
            return self._n.get(name, 0)

    def reset(self) -> None:
        with self._lock:
            self._n.clear()


LAUNCHES = LaunchCounter()

_capture = threading.local()


def launched(name: str) -> None:
    """Count one launch of kernel ``name`` in :data:`LAUNCHES`.

    Under a CUDA graph capture on the current stream the kernel is
    recorded, not run: the count goes to the tally of this thread's
    :func:`recording`, and each replay of the graph adds the tally.
    """
    if torch.cuda.is_current_stream_capturing():
        tally = getattr(_capture, "tally", None)
        if tally is not None:
            tally[name] += 1
        return
    LAUNCHES.add(name)


@contextlib.contextmanager
def recording():
    """Collect, per kernel, the launches that a graph capture on this
    thread records (a ``collections.Counter``)."""
    _capture.tally = collections.Counter()
    try:
        yield _capture.tally
    finally:
        _capture.tally = None
