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
    start/count reads (READ_NET_CDF_2DI.f90:32-34).  The container is
    told by the file's first bytes.  A NetCDF-3 file is mapped, not read:
    a hyperslab costs its own bytes, whatever the variable's size.
    """
    sl = hyperslab if hyperslab is not None else ()
    if _is_hdf5(path):
        if not HAVE_H5PY:
            raise RuntimeError("h5py unavailable for NetCDF-4 file")
        with h5py.File(path, "r") as f:
            return np.asarray(f[name][sl])
    if not HAVE_SCIPY_NETCDF:
        raise RuntimeError("scipy unavailable for NetCDF-3 file")
    with _scipy_netcdf(path, "r", mmap=True) as f:
        var = f.variables[name]
        # A copy, so that no array refers to the mapping once it closes.
        out = np.array(var[sl] if sl else var[:])
        del var
    return out


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
    with _scipy_netcdf(path, "r", mmap=True) as f:
        var = f.variables[name]
        shape = tuple(var.shape)
        del var
    return shape


class RecordWriter:
    """Stream one float32 variable ``name`` of shape ``[records,
    *tail_shape]`` into a NetCDF-3 file (64-bit offsets), its first
    dimension ``dims[0]`` the unlimited record dimension.

    Each ``append`` writes a ``[k, *tail_shape]`` block after the last, so
    a file of any size is written in the memory of one block
    (``scipy.io.netcdf_file`` holds a whole variable until it closes);
    ``close`` sets the header's record count.  A context manager.
    """

    def __init__(self, path: str, name: str, dims: Sequence[str],
                 tail_shape: Sequence[int]):
        if not HAVE_SCIPY_NETCDF:
            raise RuntimeError("scipy unavailable: cannot write NetCDF")
        self.name = name
        self.tail_shape = tuple(tail_shape)
        self.records = 0
        # scipy writes the header, with one record of zeros so that it
        # holds the record's size; the records are then written over it.
        with _scipy_netcdf(path, "w", version=2) as f:
            f.createDimension(dims[0], None)
            for dim, size in zip(dims[1:], tail_shape):
                f.createDimension(dim, size)
            var = f.createVariable(name, "f", tuple(dims))
            var[0:1] = np.zeros((1, *tail_shape), np.float32)
            del var
        self._fp = open(path, "r+b")
        self._fp.seek(-4 * int(np.prod(tail_shape)), 2)

    def append(self, block: np.ndarray) -> None:
        block = np.asarray(block, ">f4")
        if tuple(block.shape[1:]) != self.tail_shape:
            raise ValueError(f"{self.name}: block of shape {block.shape}, "
                             f"records of shape {self.tail_shape}")
        self._fp.write(block.tobytes())
        self.records += block.shape[0]

    def close(self) -> None:
        import struct
        if self._fp.closed:
            return
        self._fp.truncate()
        # The header's record count (numrecs) follows the 4-byte magic.
        self._fp.seek(4)
        self._fp.write(struct.pack(">i", self.records))
        self._fp.close()

    def __enter__(self) -> "RecordWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


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
