"""Annual diagnostics writer: the axy<year> output files.

Port of ``hybrid9_tpu/io/writer.py``, the equivalent of WRITE_NET_CDF_3DR
(SOURCE/WRITE_NET_CDF_3DR.f90): the annual-mean file (npp, plant_mass,
rnf, evap, tas, huss, ps, pr, rhs, theta_total, per-layer theta; names
and units from WRITE_NET_CDF_3DR.f90:50-81) plus the extras' fields and
the water-balance residual.  Packed ``[n]`` diagnostics are scattered
back to the (lat, lon) grid with fill values over ocean
(WRITE_NET_CDF_3DR.f90:186-197) and written single-writer NetCDF-3.
Fields may be numpy arrays or tensors on any device; each call copies
what it writes to the host once.
"""

from __future__ import annotations

import os
from typing import Dict

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
                           params) -> str:
    """Write the init-time diagnostic fields the reference produces: its
    psi_s.nc (INIT.f90:686-689), soil_tex.nc and chunk.nc decomposition
    map (INIT.f90:823-835), as the saturated matric potential stack,
    theta_s, fmax, the land mask and each cell's owning shard (all 0: one
    process holds every cell until ROADMAP A9)."""
    os.makedirs(output_path, exist_ok=True)
    path = os.path.join(output_path, "init_diagnostics.nc")
    n = land_grid.n_padded
    host = to_host(dict(psi_s=params.psi_s, theta_s=params.theta_s,
                        fmax=params.fmax))
    fields = {
        "psi_s": land_grid.scatter(host["psi_s"]),
        "theta_s": land_grid.scatter(host["theta_s"]),
        "fmax": land_grid.scatter(host["fmax"]),
        "land_mask": land_grid.scatter(np.ones(n, np.float64), fill=0.0),
        "shard_map": land_grid.scatter(np.zeros(n, np.float64)),
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


class ShardedAnnualWriter:
    """Per-process shard output of a multi-process run: waits for ROADMAP
    A9."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "ShardedAnnualWriter is not ported yet: ROADMAP A9 "
            "(multi-device)")


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
