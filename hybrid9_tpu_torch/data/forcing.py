"""Forcing pipeline: block providers with background prefetch.

Port of ``hybrid9_tpu/data/forcing.py``, the replacement for READ_PGF's
decade-at-a-time forcing ingest (SOURCE/READ_PGF.f90; called from
HYBRID9.f90:97): forcing reaches the device in bounded ``[days, n]``
blocks, and the next block is read on a background thread while the
device integrates the current one (the reference's own notes found I/O
the dominant cost, notes.txt:44-56).

A provider is called as ``provider(year, start_doy, n_days)`` and returns
a ``Forcing`` of ``[n_days, n]`` tensors on its ``device`` (None: the
card; raises where there is none).  The host providers build the block
in numpy, cast to the run's dtype there (the IEEE rounding of JAX's
``jnp.asarray(v, dtype)``, and half the bytes to copy), and copy it to
the device in the thread that calls them: on a CUDA device from pinned
memory on the current stream without waiting for the device, so the
copy is ordered before the day steps that read it and never races them.
``PrefetchingProvider``'s thread builds numpy arrays only.
"""

from __future__ import annotations

import concurrent.futures
import threading
from typing import Dict, Optional

import numpy as np
import torch

from .. import calendar
from ..io import native
from ..io import netcdf as nc
from ..state import Forcing
from .synthetic import synthetic_forcing_block

# PGF v2.1 variable set (READ_PGF.f90:22-109).
PGF_VARIABLES = ("tas", "rlds", "rsds", "huss", "ps", "pr", "rhs")

# Benign per-variable fill for padding lanes a slab cannot source from a
# real cell of its own (zero-fill means tas = 0 K, which blows up the ET
# psychrometrics).
_PAD_FORCING = {"tas": 280.0, "rlds": 300.0, "rsds": 100.0,
                "huss": 0.005, "ps": 1.0e5, "pr": 0.0, "rhs": 50.0}


def pgf_decade_path(base_dir: str, var: str, year: int) -> str:
    """Path of the PGF v2.1 decade file holding ``year`` for ``var``:
    the reference's ``<var>_pgfv2.1_<syr>_<eyr>.nc4`` (READ_PGF.f90:22-109;
    decade table CONTROL.f90:174-177), e.g. ``tas_pgfv2.1_1901_1910.nc4``.
    """
    syr, eyr = calendar.decade_year_span(calendar.decade_of_year(year))
    return f"{base_dir}/{var}_pgfv2.1_{syr}_{eyr}.nc4"


def _device(device) -> torch.device:
    from ..run import resolve_device
    return resolve_device(device)


def to_device(arrays: Dict[str, np.ndarray], device: torch.device
              ) -> Forcing:
    """A Forcing of the numpy ``arrays`` on ``device``.  To a CUDA device
    each array is staged in pinned memory and copied on the current stream
    without a host synchronisation (PyTorch's pinned-memory pool keeps the
    staging buffer until the copy has run)."""
    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)
    return Forcing(**{k: put(v) for k, v in arrays.items()})


def to_slabs(arrays: Dict[str, np.ndarray], slabs) -> list:
    """The numpy ``[days, n]`` ``arrays`` cut over device slabs
    (``parallel.sharding.DeviceSlabs``): one Forcing a slab, each copied
    from the host straight to the slab's device (:func:`to_device`), so no
    device holds another slab's columns."""
    return [to_device({k: v[:, lo:hi] for k, v in arrays.items()}, device)
            for device, (lo, hi) in zip(slabs.devices, slabs.bounds)]


class _HostProvider:
    """A provider whose block is made in numpy by ``host_block`` and
    copied to ``device`` when the provider is called, or to each device
    slab's device by ``slab_block``."""

    device: torch.device

    def host_block(self, year: int, start_doy: int, n_days: int
                   ) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def __call__(self, year: int, start_doy: int, n_days: int) -> Forcing:
        return to_device(self.host_block(year, start_doy, n_days),
                         self.device)

    def slab_block(self, slabs, year: int, start_doy: int,
                   n_days: int) -> list:
        """The block as one Forcing a device slab (:func:`to_slabs`)."""
        return to_slabs(self.host_block(year, start_doy, n_days), slabs)


def _np_dtype(dtype: torch.dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


class SyntheticForcingProvider(_HostProvider):
    """Deterministic synthetic forcing keyed by (year, day-of-year)
    (``data/synthetic.py``, seed ``seed + year``).

    ``cell_slice`` narrows the block to one rank's cells: the block is
    made for the global axis of ``n`` cells and then cut, so a slab is
    bitwise the same columns of the global block."""

    def __init__(self, n: int, seed: int = 0,
                 lat: Optional[np.ndarray] = None,
                 dtype: torch.dtype = torch.float32, device=None,
                 cell_slice: Optional[slice] = None):
        self.n = n
        self.seed = seed
        self.lat = lat
        self.dtype = dtype
        self.device = _device(device)
        self.cell_slice = cell_slice or slice(None)

    def host_block(self, year: int, start_doy: int, n_days: int
                   ) -> Dict[str, np.ndarray]:
        block = synthetic_forcing_block(
            n_days, self.n, seed=self.seed + year, start_doy=start_doy,
            lat=self.lat)
        dt = _np_dtype(self.dtype)
        return {k: v[:, self.cell_slice].astype(dt)
                for k, v in block.items()}


class NetCDFForcingProvider(_HostProvider):
    """Reads PGF-style NetCDF archives, one block of days at a time.

    One file per variable per decade, ``<var>_<tag>.nc[4]`` holding
    ``[time, lat, lon]`` (READ_PGF.f90:22-109); ``path_pattern`` is either
    a format string with ``{var}`` (and optionally ``{year}``) or the
    directory of the reference's decade files (:func:`pgf_decade_path`).
    Cells are gathered to the packed land axis of ``land_grid``; padding
    lanes repeat cell 0.

    ``cell_range=(lo, hi)`` restricts the provider to a slab of the packed
    cell axis and narrows every file read to the latitude-row band that
    slab occupies, as each MPI rank read only its tile
    (READ_NET_CDF_3DR.f90:95-97).
    """

    def __init__(self, path_pattern: str, land_grid,
                 dtype: torch.dtype = torch.float32, device=None,
                 cell_range: Optional[tuple] = None):
        self.path_pattern = path_pattern
        self.grid = land_grid
        self.dtype = dtype
        self.device = _device(device)
        self.cell_range = cell_range
        if cell_range is not None:
            lo, hi = cell_range
            self.row_lo, self.row_hi, self._local_idx = \
                land_grid.row_band(lo, hi)
            self.n_slab = hi - lo
            self.n_real = self._local_idx.shape[0]

    def _path(self, var: str, year: int) -> str:
        if "{var}" in self.path_pattern:
            return self.path_pattern.format(var=var, year=year)
        return pgf_decade_path(self.path_pattern, var, year)

    def host_block(self, year: int, start_doy: int, n_days: int
                   ) -> Dict[str, np.ndarray]:
        t0 = calendar.time_boy(year) - calendar.time_boy(
            1901 + ((year - 1901) // 10) * 10) + start_doy - 1
        tslice = slice(t0, t0 + n_days)
        dt = _np_dtype(self.dtype)
        arrays = {}
        for var in PGF_VARIABLES:
            path = self._path(var, year)
            if self.cell_range is not None:
                # Only this slab's lat-row band is read.
                if self.n_real:
                    raw = nc.read_variable(
                        path, var,
                        (tslice, slice(self.row_lo, self.row_hi)))
                    packed = native.pack_forcing_block(
                        np.asarray(raw), self._local_idx, self.n_slab)
                    packed[:, self.n_real:] = packed[:, :1]
                else:  # the slab is padding lanes only
                    packed = np.full((n_days, self.n_slab),
                                     _PAD_FORCING[var], np.float32)
                arrays[var] = packed.astype(dt)
                continue
            raw = nc.read_variable(path, var, (tslice,))
            packed = native.pack_forcing_block(
                np.asarray(raw), self.grid.land_idx, self.grid.n_padded)
            packed[:, self.grid.n_land:] = packed[:, :1]
            arrays[var] = packed.astype(dt)
        return arrays


class HostShardedProvider(_HostProvider):
    """One rank's forcing: a host provider that reads only the rank's
    slab (``SyntheticForcingProvider(cell_slice=)``,
    ``NetCDFForcingProvider(cell_range=)``), delivered on the rank's
    device, the multi-process analog of each MPI rank hyperslab-reading
    its own tile (READ_NET_CDF_3DR.f90:95-97).  A rank holds its slab
    only, so, unlike the JAX package's, nothing assembles a global block;
    a block of another width than the slab's raises."""

    def __init__(self, local_provider: _HostProvider, sharding,
                 n_global: int):
        if n_global != sharding.n:
            raise ValueError(f"{n_global} cells, but the sharding cuts "
                             f"{sharding.n}")
        self.provider = local_provider
        self.sharding = sharding
        self.device = sharding.device

    def host_block(self, year: int, start_doy: int, n_days: int
                   ) -> Dict[str, np.ndarray]:
        block = self.provider.host_block(year, start_doy, n_days)
        for k, v in block.items():
            if v.shape[1] != self.sharding.n_local:
                raise ValueError(
                    f"{k}: a block of {v.shape[1]} cells for the slab "
                    f"[{self.sharding.lo}, {self.sharding.hi})")
        return block


class PrefetchingProvider:
    """Wraps a host provider with single-slot background prefetch.

    ``prefetch(year, doy, n)`` has a worker thread build that block's
    numpy arrays (``provider.host_block``); the next matching call takes
    them, waiting only if they are not ready yet, and copies them to the
    device in the calling thread.  The double-buffering the reference
    approximated by reading whole decades up front (HYBRID9.f90:93-97).
    """

    def __init__(self, provider: _HostProvider):
        self.provider = provider
        self.device = provider.device
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._lock = threading.Lock()
        self._pending: Dict[tuple, concurrent.futures.Future] = {}

    def prefetch(self, year: int, start_doy: int, n_days: int) -> None:
        key = (year, start_doy, n_days)
        with self._lock:
            if key not in self._pending:
                self._pending[key] = self._pool.submit(
                    self.provider.host_block, year, start_doy, n_days)

    def _arrays(self, year: int, start_doy: int, n_days: int
                ) -> Dict[str, np.ndarray]:
        key = (year, start_doy, n_days)
        with self._lock:
            fut = self._pending.pop(key, None)
        return (fut.result() if fut is not None
                else self.provider.host_block(year, start_doy, n_days))

    def __call__(self, year: int, start_doy: int, n_days: int) -> Forcing:
        return to_device(self._arrays(year, start_doy, n_days), self.device)

    def slab_block(self, slabs, year: int, start_doy: int,
                   n_days: int) -> list:
        """The block as one Forcing a device slab (:func:`to_slabs`)."""
        return to_slabs(self._arrays(year, start_doy, n_days), slabs)

    def close(self) -> None:
        """Stop the worker; a block it is building is finished and
        dropped."""
        with self._lock:
            self._pending.clear()
        self._pool.shutdown(wait=True)
