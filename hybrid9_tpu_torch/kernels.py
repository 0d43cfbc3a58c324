"""Build and load the hand-written CUDA kernels.

The sources in ``csrc/`` are compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, at first
use, into ``_build/`` beside this file; the library name carries a hash
of the sources and flags, so an edited source is rebuilt and a stale
library is never loaded.  The library is bound with ``ctypes``.  Ranks
that start together build it once: the first takes a file lock and runs
``nvcc``, the others wait on the lock and load its library.

Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_SRC_DIR = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
DAY_KERNEL_SOURCE = _SRC_DIR / "day_kernel.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_day_lib = None
#: What the last build in this process printed and took:
#: ``{"seconds": float, "log": str, "path": str}``; empty if the library
#: was already on disk.
build_info: dict = {}
#: The same record for every library built in this process, by its path.
build_logs: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "on a machine with the CUDA toolkit")
    return path


def build(name: str, sources) -> Path:
    """Compile ``sources`` with ``NVCC_FLAGS`` into ``_build/``; returns
    the library's path and leaves the compiler's output in ``build_info``
    and ``build_logs``.  One process at a time builds a library (a lock
    file beside it); one that finds the library built while it waited
    loads that."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib = _BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(lib.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():
            _compile(lib, sources)
    return lib


def _compile(lib: Path, sources) -> None:
    """Run ``nvcc`` into a temporary file and rename it to ``lib``."""
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    build_logs[str(lib)] = dict(seconds=seconds,
                                log=proc.stdout + proc.stderr, path=str(lib))
    build_info.update(build_logs[str(lib)])


def day_kernel_lib() -> ctypes.CDLL:
    """The day-kernel library (``csrc/day_kernel.cu``), built on first
    use."""
    global _day_lib
    if _day_lib is None:
        _day_lib = bind_day_kernel(build("h9day", [DAY_KERNEL_SOURCE]))
    return _day_lib


def bind_day_kernel(path) -> ctypes.CDLL:
    """Load a build of ``csrc/day_kernel.cu`` and declare its two C
    entries."""
    lib = ctypes.CDLL(str(path))
    fn = lib.h9_hydrology_day
    # dtype_bytes, nl, with_imp, any_nl, ins, strides, outs, n, grid,
    # nisurf, zd09_every, dt, geom, geom_dev, focus, wt_trace, stream
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.h9_day_residency
    # dtype_bytes, nl, with_imp, any_nl, out
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
