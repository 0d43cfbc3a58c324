"""Build and load the hand-written CUDA kernels.

The sources in ``csrc/`` are compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, at first
use, into ``_build/`` beside this file; the library name carries a hash
of the sources, flags and units, so an edited source is rebuilt and a
stale library is never loaded.  Each kernel is a library of its own, so
an edit to one rebuilds only it.  A library may be built from several
units of compilation, one source compiled with other arguments (the day
kernel: one unit for its fixed builds and C entries, one for each
register build of ``day_kernel_any``): every unit's ``nvcc`` runs at
once, and the objects are linked into the one library.  The library is
bound with ``ctypes``.  Ranks that start together build it once: the
first takes a file lock and runs ``nvcc``, the others wait on the lock
and load its library.  What the kernels' wrappers share on the host is
here too: the views a kernel takes (:func:`cell_stride`) and whether a
call runs the kernel or its plain twin (:func:`kernel_wanted`).

Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parent
_SRC_DIR = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
DAY_KERNEL_SOURCE = _SRC_DIR / "day_kernel.cu"
SOIL_HEAT_SOURCE = _SRC_DIR / "soil_heat.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: The register builds of ``day_kernel_any``, (C type, layer capacity,
#: the layer counts it serves): ``H9_ANY_BUILDS`` in the source lists the
#: same builds.  A build takes any count up to its capacity but serves
#: only those where it measured faster than the all-shared form on an H100
#: (``scripts/day_kernel_forms.py``, PERF.md), which serves the rest.
ANY_BUILDS = (("float", 8, range(3, 9)), ("float", 10, range(9, 11)),
              ("float", 12, (12,)), ("float", 16, range(13, 17)),
              ("float", 24, (20, 21, 22, 24)), ("float", 32, range(30, 33)),
              ("double", 12, range(10, 13)))
#: The day kernel's units of compilation, as macro definitions: the main
#: unit (fixed builds, the all-shared form, the C entries) and one unit a
#: register build.
DAY_KERNEL_UNITS = ((),) + tuple(
    (f"-DH9_ANY_REAL={real}", f"-DH9_ANY_CAP={cap}")
    for real, cap, _ in ANY_BUILDS)
#: The soil-heat kernel's one unit: its arithmetic is the plain twin's
#: operation for operation, so no multiply and add are contracted.
SOIL_HEAT_UNITS = (("-fmad=false",),)

_day_lib = None
_soil_lib = None
#: What the last build in this process printed and took:
#: ``{"seconds": float, "log": str, "path": str, "units": {unit: seconds}}``
#: (``seconds`` from the first ``nvcc`` to the linked library); empty if
#: the library was already on disk.
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


def build(name: str, sources, units=((),)) -> Path:
    """Compile each of ``sources`` once for every unit of ``units`` (a
    tuple of further ``nvcc`` arguments each, such as macro definitions)
    with ``NVCC_FLAGS``, all at once, and link the objects into one
    library in ``_build/``; returns the library's path and leaves the
    compiler's output in ``build_info`` and ``build_logs``.  One process
    at a time builds a library (a lock file beside it); one that finds the
    library built while it waited loads that."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update(repr(tuple(units)).encode())
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
            _compile(lib, sources, units)
    return lib


def _compile(lib: Path, sources, units) -> None:
    """Run ``nvcc`` on every (source, unit) at once into a temporary
    directory, link the objects into a temporary library and rename it to
    ``lib``."""
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        jobs = []
        for i, (src, unit) in enumerate(
                (s, u) for s in sources for u in units):
            obj = os.path.join(tmp, f"{i}.o")
            jobs.append((" ".join([src.name, *unit]), obj,
                         [nvcc, *NVCC_FLAGS, *unit, "-c", "-o", obj,
                          str(src)]))

        def run(cmd):
            started = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            return proc, time.perf_counter() - started

        with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
            done = list(pool.map(run, [cmd for _, _, cmd in jobs]))
        logs = [proc.stdout + proc.stderr for proc, _ in done]
        unit_s = {label: sec for (label, _, _), (_, sec) in zip(jobs, done)}
        failed = [f"{label} ({proc.returncode}):\n{log}"
                  for (label, _, _), (proc, _), log in zip(jobs, done, logs)
                  if proc.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed " + "\n".join(failed))
        out_lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run(
            [nvcc, NVCC_FLAGS[0], NVCC_FLAGS[1], "-shared", "-o", out_lib,
             *[obj for _, obj, _ in jobs]],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to link ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(out_lib, lib)
    seconds = time.perf_counter() - t0
    build_logs[str(lib)] = dict(seconds=seconds, log="".join(logs),
                                path=str(lib), units=unit_s)
    build_info.update(build_logs[str(lib)])


def build_day_kernel(source=DAY_KERNEL_SOURCE, name: str = "h9day") -> Path:
    """The day-kernel library from ``source`` (the package's
    ``csrc/day_kernel.cu`` or a changed copy of it), in its
    ``DAY_KERNEL_UNITS``."""
    return build(name, [Path(source)], DAY_KERNEL_UNITS)


def day_kernel_lib() -> ctypes.CDLL:
    """The day-kernel library (``csrc/day_kernel.cu``), built on first
    use."""
    global _day_lib
    if _day_lib is None:
        _day_lib = bind_day_kernel(build_day_kernel())
    return _day_lib


def bind_day_kernel(path) -> ctypes.CDLL:
    """Load a build of ``csrc/day_kernel.cu`` and declare its two C
    entries."""
    lib = ctypes.CDLL(str(path))
    fn = lib.h9_hydrology_day
    # dtype_bytes, nl, with_imp, form, ins, strides, outs, n, grid,
    # nisurf, zd09_every, dt, geom, geom_dev, focus, wt_trace, stream
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.h9_day_residency
    # dtype_bytes, nl, with_imp, form, out
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def soil_heat_lib() -> ctypes.CDLL:
    """The soil-heat library (``csrc/soil_heat.cu``), built on first use,
    with its C entry declared."""
    global _soil_lib
    if _soil_lib is None:
        lib = ctypes.CDLL(str(build("h9soil", [SOIL_HEAT_SOURCE],
                                    SOIL_HEAT_UNITS)))
        fn = lib.h9_soil_heat
        # dtype_bytes, cap, nl, soil_ice, latent_ramp, dt, ins, strides,
        # outs, n, geom, geom_dev, scratch, stream
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_double, ctypes.c_double,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _soil_lib = lib
    return _soil_lib


def cell_stride(x: torch.Tensor, name: str, n: int, nl: Optional[int],
                dtype, device, aligned: bool = True,
                kernel: str = "day kernel") -> int:
    """Elements from one cell of ``x`` to the next, for the kernel.  ``x``
    is ``[n]`` (``nl=None``; any stride) or ``[n, nl]`` with contiguous
    rows: a contiguous tensor, or a view such as ``y[lo:hi]`` of one.  With
    ``aligned`` (a fixed build, which moves rows in 16-byte words) the rows
    must also start on 16-byte addresses; ``day_kernel_any`` reads such a
    row in 16-byte words and any other an element at a time.  Raises on
    anything else, naming ``kernel``; nothing is copied."""
    shape = (n,) if nl is None else (n, nl)
    if x.shape != shape or x.dtype != dtype or x.device != device:
        raise ValueError(
            f"{kernel}: {name} is {tuple(x.shape)} {x.dtype} on "
            f"{x.device}; expected {shape} {dtype} on {device}")
    stride = x.stride(0) if n > 1 else (nl or 1)
    if not 0 <= stride < 2 ** 31:
        raise ValueError(f"{kernel}: {name} has cell stride {stride}")
    if nl is not None:
        if nl > 1 and x.stride(1) != 1:
            raise ValueError(
                f"{kernel}: the rows of {name} are not contiguous "
                f"(strides {x.stride()}); pass [n, nl] as the model holds "
                f"it")
        item = x.element_size()
        if aligned and (x.data_ptr() % 16 or (stride * item) % 16):
            raise ValueError(
                f"{kernel}: the rows of {name} do not start on 16-byte "
                f"addresses (offset {x.data_ptr() % 16}, cell stride "
                f"{stride * item} bytes)")
    return stride


def kernel_wanted(x: torch.Tensor, use_kernel: Optional[bool],
                  kernel: str = "day kernel") -> bool:
    """Whether a CUDA kernel runs on tensors like ``x``: ``use_kernel=None``
    takes it for CUDA tensors and the plain twin for CPU tensors, ``True``
    demands it (and raises on CPU tensors, naming ``kernel``), ``False``
    takes the twin."""
    if use_kernel is None:
        return x.is_cuda
    if use_kernel and not x.is_cuda:
        raise ValueError(f"use_kernel=True needs CUDA tensors; the {kernel} "
                         f"has no CPU form")
    return bool(use_kernel)
