"""Minimal NetCDF I/O without the netCDF4 package.

A copy of ``hybrid9_tpu/io/netcdf.py``.  Replaces the reference's
READ_NET_CDF_* / WRITE_NET_CDF_* family (SOURCE/READ_NET_CDF_*.f90,
SOURCE/WRITE_NET_CDF_*.f90) with host-side Python I/O:

* NetCDF-3 (classic) via ``scipy.io.netcdf_file`` — used for all files we
  write (annual diagnostics, parameter dumps),
* NetCDF-4/HDF5 (the PGF ``.nc4`` forcing archives) via ``h5py`` when
  present.

``h5py`` is optional: without it only NetCDF-3 files can be read.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

try:
    from scipy.io import netcdf_file as _scipy_netcdf
    HAVE_SCIPY_NETCDF = True
except Exception:  # pragma: no cover
    HAVE_SCIPY_NETCDF = False

try:
    import h5py
    HAVE_H5PY = True
except Exception:  # pragma: no cover
    HAVE_H5PY = False

FILL_VALUE = np.float32(1.0e20)


def read_variable(path: str, name: str,
                  hyperslab: Optional[Tuple[slice, ...]] = None
                  ) -> np.ndarray:
    """Read (a hyperslab of) a variable from NetCDF-3 or NetCDF-4.

    The hyperslab argument is the analog of the reference's per-rank
    start/count reads (READ_NET_CDF_2DI.f90:32-34).
    """
    sl = hyperslab if hyperslab is not None else ()
    if path.endswith((".nc4", ".h5", ".hdf5")) or _is_hdf5(path):
        if not HAVE_H5PY:
            raise RuntimeError("h5py unavailable for NetCDF-4 file")
        with h5py.File(path, "r") as f:
            return np.asarray(f[name][sl])
    if not HAVE_SCIPY_NETCDF:
        raise RuntimeError("scipy unavailable for NetCDF-3 file")
    with _scipy_netcdf(path, "r", mmap=False) as f:
        var = f.variables[name]
        return np.asarray(var[sl] if sl else var[:])


def _is_hdf5(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(8) == b"\x89HDF\r\n\x1a\n"
    except OSError:
        return False


def variable_shape(path: str, name: str) -> Tuple[int, ...]:
    """Shape discovery, the analog of READ_NET_CDF_0D's time-length query
    (READ_NET_CDF_0D.f90:37)."""
    if _is_hdf5(path):
        with h5py.File(path, "r") as f:
            return tuple(f[name].shape)
    with _scipy_netcdf(path, "r", mmap=False) as f:
        return tuple(f.variables[name].shape)


def write_grid_file(path: str, fields: Dict[str, np.ndarray],
                    lon: np.ndarray, lat: np.ndarray,
                    units: Optional[Dict[str, str]] = None,
                    layer_dim: Optional[int] = None) -> None:
    """Write [ny, nx] or [ny, nx, nlayer] float fields to NetCDF-3.

    The single-writer equivalent of the collective annual write
    (WRITE_NET_CDF_3DR.f90:93-257): CF-style lon/lat coordinate variables,
    NaN-free FILL_VALUE for ocean cells.
    """
    if not HAVE_SCIPY_NETCDF:
        raise RuntimeError("scipy unavailable: cannot write NetCDF")
    units = units or {}
    # Atomic publish: write to a sibling tmp then rename, so concurrent
    # readers (other hosts on a shared filesystem) never see a
    # half-written file.
    tmp = path + ".tmp"
    with _scipy_netcdf(tmp, "w") as f:
        f.createDimension("longitude", lon.shape[0])
        f.createDimension("latitude", lat.shape[0])
        if layer_dim:
            f.createDimension("layer", layer_dim)
        vlon = f.createVariable("longitude", "f", ("longitude",))
        vlon[:] = lon.astype(np.float32)
        vlon.units = "degrees_east"
        vlat = f.createVariable("latitude", "f", ("latitude",))
        vlat[:] = lat.astype(np.float32)
        vlat.units = "degrees_north"
        for name, data in fields.items():
            if data.ndim == 2:
                v = f.createVariable(name, "f", ("latitude", "longitude"))
            elif data.ndim == 3:
                v = f.createVariable(
                    name, "f", ("layer", "latitude", "longitude"))
                data = np.moveaxis(data, -1, 0)
            else:
                raise ValueError(f"{name}: unsupported rank {data.ndim}")
            arr = data.astype(np.float32)
            arr = np.where(np.isfinite(arr), arr, FILL_VALUE)
            v[:] = arr
            v._FillValue = FILL_VALUE
            if name in units:
                v.units = units[name]
    import os
    os.replace(tmp, path)


def read_grid_file(path: str, names: Sequence[str]
                   ) -> Dict[str, np.ndarray]:
    """Read named 2-D/3-D fields back (inverse of write_grid_file)."""
    out = {}
    with _scipy_netcdf(path, "r", mmap=False) as f:
        for name in names:
            data = np.asarray(f.variables[name][:]).astype(np.float64)
            data = np.where(data >= 9.9e19, np.nan, data)
            if data.ndim == 3:
                data = np.moveaxis(data, 0, -1)
            out[name] = data
    return out
