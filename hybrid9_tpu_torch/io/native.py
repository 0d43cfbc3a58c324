"""ctypes bindings to the native host I/O library (native/h9io.cpp).

A copy of ``hybrid9_tpu/io/native.py``: host I/O whose results are the
same with the library or without it, not a device kernel.  The C++
library implements the host-side hot paths — the box-average soil regrid
(the reference's init hot loop, INIT.f90:579-600) and the
pack/gather/scatter between (lat, lon) grids and the packed land-cell
axis.  Every function falls back to NumPy when the shared library has not
been built, so the native build is an optimisation, never a requirement.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_LIB_PATHS = (
    os.path.join(_REPO_ROOT, "native", "libh9io.so"),
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "libh9io.so"),
)

_i64 = ctypes.c_int64
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    for path in _LIB_PATHS:
        if os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
                lib.h9_box_average.argtypes = [_f64p, _i64, _i64, _i64,
                                               _f64p]
                lib.h9_pack_gather_f32.argtypes = [
                    _f32p, _i64p, _i64, _i64, ctypes.c_float, _f32p]
                lib.h9_pack_gather_f64.argtypes = [
                    _f64p, _i64p, _i64, _i64, ctypes.c_double, _f64p]
                lib.h9_scatter_f32.argtypes = [_f32p, _i64p, _i64, _f32p]
                lib.h9_scatter_f64.argtypes = [_f64p, _i64p, _i64, _f64p]
                lib.h9_pack_forcing_block.argtypes = [
                    _f32p, _i64, _i64, _i64p, _i64, _i64, _f32p]
                lib.h9_abi_version.restype = ctypes.c_int
                if lib.h9_abi_version() == 1:
                    _LIB = lib
                    break
            except OSError:
                continue
    return _LIB


def available() -> bool:
    return _load() is not None


def box_average(fine: np.ndarray, factor: int) -> np.ndarray:
    """NaN-aware box average of a fine grid down by ``factor``."""
    ny, nx = fine.shape[0] // factor, fine.shape[1] // factor
    lib = _load()
    if lib is None:
        blocks = fine.reshape(ny, factor, nx, factor)
        with np.errstate(invalid="ignore"):
            return np.nanmean(blocks, axis=(1, 3))
    fine = np.ascontiguousarray(fine, np.float64)
    out = np.empty((ny, nx), np.float64)
    lib.h9_box_average(fine, ny, nx, factor, out)
    return out


def pack_gather(src_flat: np.ndarray, idx: np.ndarray, n_padded: int,
                fill: float = 0.0) -> np.ndarray:
    """Gather ``src_flat[idx]`` into a padded packed array."""
    lib = _load()
    idx = np.ascontiguousarray(idx, np.int64)
    n = idx.shape[0]
    if lib is None:
        out = np.full(n_padded, fill, dtype=src_flat.dtype)
        out[:n] = src_flat[idx]
        return out
    if src_flat.dtype == np.float32:
        out = np.empty(n_padded, np.float32)
        lib.h9_pack_gather_f32(np.ascontiguousarray(src_flat), idx, n,
                               n_padded, fill, out)
    else:
        out = np.empty(n_padded, np.float64)
        lib.h9_pack_gather_f64(
            np.ascontiguousarray(src_flat, np.float64), idx, n, n_padded,
            fill, out)
    return out


def scatter(packed: np.ndarray, idx: np.ndarray, size: int,
            fill: float = np.nan) -> np.ndarray:
    """Scatter a packed array back onto a flat field of ``size``."""
    lib = _load()
    idx = np.ascontiguousarray(idx, np.int64)
    n = idx.shape[0]
    if lib is None:
        out = np.full(size, fill, dtype=packed.dtype)
        out[idx] = packed[:n]
        return out
    if packed.dtype == np.float32:
        out = np.full(size, np.float32(fill), np.float32)
        lib.h9_scatter_f32(np.ascontiguousarray(packed[:n]), idx, n, out)
    else:
        out = np.full(size, np.float64(fill), np.float64)
        lib.h9_scatter_f64(
            np.ascontiguousarray(packed[:n], np.float64), idx, n, out)
    return out


def pack_forcing_block(brick: np.ndarray, idx: np.ndarray,
                       n_padded: int) -> np.ndarray:
    """[t, ny, nx] float forcing brick -> packed [t, n_padded] float32."""
    t = brick.shape[0]
    size = brick.shape[1] * brick.shape[2]
    lib = _load()
    idx = np.ascontiguousarray(idx, np.int64)
    n = idx.shape[0]
    if lib is None:
        flat = brick.reshape(t, size).astype(np.float32)
        out = np.zeros((t, n_padded), np.float32)
        out[:, :n] = flat[:, idx]
        return out
    brick32 = np.ascontiguousarray(brick.reshape(t, size), np.float32)
    out = np.empty((t, n_padded), np.float32)
    lib.h9_pack_forcing_block(brick32, t, size, idx, n, n_padded, out)
    return out
