"""Annual diagnostics writer: the axy<year> output files.

Port of ``hybrid9_tpu/io/writer.py``, the equivalent of WRITE_NET_CDF_3DR
(SOURCE/WRITE_NET_CDF_3DR.f90): the annual-mean file (npp, plant_mass,
rnf, evap, tas, huss, ps, pr, rhs, theta_total, per-layer theta; names
and units from WRITE_NET_CDF_3DR.f90:50-81) plus the extras' fields and
the water-balance residual.  Packed ``[n]`` diagnostics are scattered
back to the (lat, lon) grid with fill values over ocean
(WRITE_NET_CDF_3DR.f90:186-197) and written single-writer NetCDF-3.
Fields may be numpy arrays or tensors on any device; each call copies
what it writes to the host once.  A multi-process run writes one part
file per rank, which rank 0 stitches (:class:`ShardedAnnualWriter`).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..grids.grid import LandGrid
from ..utils.logging import get_logger
from . import netcdf

log = get_logger(__name__)

ANNUAL_UNITS = {
    "npp": "g[DM] m-2 yr-1",
    "plant_mass": "g[DM] m-2",
    "rnf": "mm s-1",
    "discharge": "mm yr-1",
    "t_surface": "K",
    "evap": "mm s-1",
    "tas": "K",
    "huss": "kg kg-1",
    "ps": "Pa",
    "pr": "kg m-2 s-1",
    "rhs": "%",
    "rlds": "W m-2",
    "rsds": "W m-2",
    "theta_total": "mm",
    "theta": "m3 m-3",
    "swe": "mm",
    "soil_ice": "mm",
    "rh": "g[C] m-2 yr-1",
    "nee": "g[C] m-2 yr-1",
    "c_soil": "g[C] m-2",
    "max_abs_residual": "mm",
}


def to_host(fields: Dict) -> Dict[str, np.ndarray]:
    """``fields`` (numpy arrays, or tensors of one leading length ``n``)
    as float64 numpy arrays, the tensors in ONE device-to-host copy."""
    tensors = {k: v for k, v in fields.items()
               if isinstance(v, torch.Tensor)}
    out = {k: np.asarray(v, np.float64) for k, v in fields.items()
           if k not in tensors}
    if tensors:
        n = next(iter(tensors.values())).shape[0]
        flat = torch.cat([v.detach().reshape(n, -1).double()
                          for v in tensors.values()], dim=1).cpu().numpy()
        col = 0
        for k, v in tensors.items():
            width = int(np.prod(v.shape[1:], dtype=np.int64))
            out[k] = flat[:, col:col + width].reshape(v.shape)
            col += width
    return {k: out[k] for k in fields}


def write_init_diagnostics(output_path: str, land_grid: LandGrid,
                           params, n_shards: int = 1) -> str:
    """Write the init-time diagnostic fields the reference produces: its
    psi_s.nc (INIT.f90:686-689), soil_tex.nc and chunk.nc decomposition
    map (INIT.f90:823-835), as the saturated matric potential stack,
    theta_s, fmax, the land mask and each cell's owning shard under the
    1-D cell decomposition into ``n_shards`` slabs (the processes of a
    multi-process run; one process writes it)."""
    os.makedirs(output_path, exist_ok=True)
    path = os.path.join(output_path, "init_diagnostics.nc")
    n = land_grid.n_padded
    shard = np.floor_divide(np.arange(n), max(1, n // max(1, n_shards)))
    host = to_host(dict(psi_s=params.psi_s, theta_s=params.theta_s,
                        fmax=params.fmax))
    fields = {
        "psi_s": land_grid.scatter(host["psi_s"]),
        "theta_s": land_grid.scatter(host["theta_s"]),
        "fmax": land_grid.scatter(host["fmax"]),
        "land_mask": land_grid.scatter(np.ones(n, np.float64), fill=0.0),
        "shard_map": land_grid.scatter(shard.astype(np.float64)),
    }
    if land_grid.soil_tex is not None:
        fields["soil_tex"] = np.asarray(land_grid.soil_tex, np.float64)
    layer_dim = fields["psi_s"].shape[-1]
    netcdf.write_grid_file(path, fields, land_grid.lon, land_grid.lat,
                           units={"psi_s": "mm"}, layer_dim=layer_dim)
    log.info("wrote init diagnostics to %s", path)
    return path


class AnnualWriter:
    """Writes axy<year>.nc files from packed annual-mean diagnostics."""

    def __init__(self, output_path: str, land_grid: LandGrid):
        self.output_path = output_path
        self.grid = land_grid
        os.makedirs(output_path, exist_ok=True)

    def write_annual(self, year: int, means: Dict) -> str:
        path = os.path.join(self.output_path, f"axy{year}.nc")
        fields = {}
        layer_dim = None
        for name, arr in to_host(means).items():
            fields[name] = self.grid.scatter(arr, fill=np.nan)
            if arr.ndim == 2:
                layer_dim = arr.shape[1]
        netcdf.write_grid_file(path, fields, self.grid.lon, self.grid.lat,
                               units=ANNUAL_UNITS, layer_dim=layer_dim)
        log.info("wrote %s (%d fields)", path, len(fields))
        return path


#: Seconds process 0 waits for the other processes' part files of a year.
STITCH_TIMEOUT_S = 600.0


class ShardedAnnualWriter:
    """Per-process part files of a multi-process run, stitched by rank 0.

    The analog of the reference's collective parallel NetCDF-4/MPI-IO
    annual write, where every rank takes part in the file definition and
    then puts only its own tile (WRITE_NET_CDF_3DR.f90:93-94, 211-257):
    each process writes its slab of the packed cell axis to
    ``axy<year>.part<i>.nc``, and process 0 stitches the parts into the
    reference-layout global ``axy<year>.nc`` once all slabs are on disk
    (the shared filesystem plays the role of MPI-IO), then removes them.
    A copy of the JAX package's writer.
    """

    def __init__(self, output_path: str, land_grid: LandGrid,
                 cell_start: int, cell_stop: int,
                 process_index: Optional[int] = None,
                 n_processes: Optional[int] = None):
        from ..parallel import launch
        self.output_path = output_path
        self.grid = land_grid
        self.lo = int(cell_start)
        self.hi = int(cell_stop)
        self.pid = (launch.process_index() if process_index is None
                    else process_index)
        self.np_ = (launch.process_count() if n_processes is None
                    else n_processes)
        os.makedirs(output_path, exist_ok=True)
        # Stale-part guard: only parts written during this run (mtime
        # after construction) count toward a stitch, so leftovers of a
        # crashed or differently configured earlier run into the same
        # output_path are never mixed into a fresh global file.
        self._t0 = time.time() - 1.0   # 1 s clock slack

    def _part_path(self, year: int, pid: int) -> str:
        return os.path.join(self.output_path, f"axy{year}.part{pid}.nc")

    def write_annual(self, year: int, means: Dict) -> str:
        """Write this process's ``[local_n]`` / ``[local_n, nl]`` slab,
        then (process 0) stitch.  ``means`` holds the process's slab."""
        from scipy.io import netcdf_file
        path = self._part_path(year, self.pid)
        tmp = path + ".tmp"
        with netcdf_file(tmp, "w") as f:
            f.cell_start = self.lo
            f.cell_stop = self.hi
            f.n_parts = self.np_
            local_n = self.hi - self.lo
            f.createDimension("cell", local_n)
            layer_done = False
            for name, arr in to_host(means).items():
                if arr.shape[0] != local_n:
                    raise ValueError(
                        f"{name}: expected local slab of {local_n} cells, "
                        f"got {arr.shape}")
                if arr.ndim == 2 and not layer_done:
                    f.createDimension("layer", arr.shape[1])
                    layer_done = True
                dims = ("cell",) if arr.ndim == 1 else ("cell", "layer")
                v = f.createVariable(name, "d", dims)
                v[:] = arr
        os.replace(tmp, path)
        log.info("wrote shard part %s (cells [%d, %d))", path, self.lo,
                 self.hi)
        if self.pid == 0:
            return self.stitch_year(year)
        return path

    def stitch_year(self, year: int) -> str:
        """Assemble the part files into the global axy<year>.nc.

        Only parts written during this run are accepted (mtime check);
        consumed parts are deleted after a successful stitch, so reruns
        into the same directory cannot mix simulations.
        """
        from scipy.io import netcdf_file
        paths = [self._part_path(year, p) for p in range(self.np_)]

        def fresh(p):
            try:
                return os.path.getmtime(p) >= self._t0
            except OSError:
                return False

        deadline = time.monotonic() + STITCH_TIMEOUT_S
        while not all(fresh(p) for p in paths):
            if time.monotonic() > deadline:
                missing = [p for p in paths if not fresh(p)]
                raise TimeoutError(
                    f"stitch axy{year}: missing/stale parts {missing}")
            time.sleep(0.2)
        packed: Dict[str, np.ndarray] = {}
        for p in paths:
            with netcdf_file(p, "r", mmap=False) as f:
                lo, hi = int(f.cell_start), int(f.cell_stop)
                if int(f.n_parts) != self.np_:
                    raise ValueError(
                        f"{p}: written for {int(f.n_parts)} processes, "
                        f"this run has {self.np_}")
                for name, var in f.variables.items():
                    arr = np.asarray(var[:])
                    if name not in packed:
                        packed[name] = np.empty(
                            (self.grid.n_padded, *arr.shape[1:]),
                            np.float64)
                    packed[name][lo:hi] = arr
        path = AnnualWriter(self.output_path, self.grid).write_annual(
            year, packed)
        for p in paths:
            try:
                os.remove(p)
            except OSError:
                pass
        log.info("stitched %s from %d parts", path, self.np_)
        return path


class FocusCSVWriter:
    """Daily CSV of the INTERACTIVE focus cell.

    The reference's per-day diagnostic CSV (unit 20, HYBRID9.f90:221-229,
    header INIT.f90:887-891) in ``focus_daily.csv``, and its unit-98
    water-table trace (HYDROLOGY.f90:509), one row per substep, in
    ``focus_wt.csv``.
    """

    COLUMNS = ("year", "doy", "tas", "pr", "rsds", "evap", "evap_grnd",
               "rnf", "discharge", "npp", "rh", "nee", "zwt", "wa",
               "lai", "plant_mass", "theta_mean", "t_surf", "swe",
               "residual")

    def __init__(self, output_path: str):
        os.makedirs(output_path, exist_ok=True)
        self.path = os.path.join(output_path, "focus_daily.csv")
        self.wt_path = os.path.join(output_path, "focus_wt.csv")
        self._fh = open(self.path, "w")
        self._fh.write(",".join(self.COLUMNS) + "\n")
        self._wt_fh = open(self.wt_path, "w")
        self._wt_fh.write("year,doy,step,zwt\n")

    def append(self, year: int, start_doy: int, rows: Dict) -> None:
        """Append one forcing block of the focus cell's rows (``[days]``
        each, ``wt_substeps`` ``[days, nisurf]``), copied to the host in
        one piece."""
        cols = [torch.as_tensor(rows[k]) for k in self.COLUMNS[2:]]
        daily = torch.stack(cols, dim=1)
        host = torch.cat([daily, rows["wt_substeps"].to(daily.dtype)],
                         dim=1).double().cpu().numpy()
        ncol = len(cols)
        for d in range(host.shape[0]):
            vals = [str(year), str(start_doy + d)]
            vals += [f"{float(v):.6g}" for v in host[d, :ncol]]
            self._fh.write(",".join(vals) + "\n")
            for s, v in enumerate(host[d, ncol:]):
                self._wt_fh.write(f"{year},{start_doy + d},{s + 1},"
                                  f"{float(v):.6g}\n")
        self._fh.flush()
        self._wt_fh.flush()

    def close(self) -> None:
        self._fh.close()
        self._wt_fh.close()
