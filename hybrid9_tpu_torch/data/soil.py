"""Soil-property ingest: the land grid and the per-cell soil parameters.

Port of ``hybrid9_tpu/data/soil.py``, the replacement for the
reference's INIT-time soil ingest (SOURCE/INIT.f90:473-726): HWSD texture
mask, BNU 30-arc-sec saturated properties box-averaged to the model grid,
unit conversions, Fmax with the reference's missing-value default, the
-31 bar residual inversion and the land-cell selection test.  When the
archives are absent the synthetic generator stands in (data/synthetic.py).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..grids.grid import LandGrid, make_land_grid, synthetic_land_mask
from ..io import native
from ..io import netcdf as nc
from ..physics import constants as c
from ..state import SoilParams
from ..utils.logging import get_logger
from .synthetic import synthetic_soil_params

log = get_logger(__name__)

# Reference default when the Fmax field is missing: 3809/10000
# (INIT.f90:652-680).
FMAX_DEFAULT = 0.3809

#: Seconds the other processes of a run wait at the barrier for process
#: 0's raw-soil regrid (the JAX package's wait bound).
SOIL_WAIT_S = 3600.0


def box_average(fine: np.ndarray, factor: int) -> np.ndarray:
    """Average a fine-resolution grid down by ``factor`` in each dim: the
    reference's 60x60 box-average of 30-arc-sec BNU data onto 0.5 degrees
    (INIT.f90:579-600); NaNs (missing soil) are left out of the mean."""
    ny, nx = fine.shape
    if ny % factor or nx % factor:
        raise ValueError(f"box_average: {fine.shape} is not a multiple of "
                         f"{factor}")
    return native.box_average(np.asarray(fine, np.float64), factor)


def convert_bnu_units(theta_s_raw: np.ndarray, k_s_raw: np.ndarray,
                      lambda_raw: np.ndarray, psi_s_raw: np.ndarray):
    """BNU archive units -> model units (INIT.f90:602-631).

    theta_s: 0.001 cm^3/cm^3 -> -, k_s: cm/day -> mm/s,
    lambda: 0.001 -> -, psi_s: cm -> mm; bsw = 1/lambda.
    """
    theta_s = theta_s_raw / 1.0e3
    hksat = 10.0 * k_s_raw / 86400.0
    lambda_ = np.maximum(lambda_raw / 1.0e3, c.TRUNC)
    psi_s = 10.0 * psi_s_raw
    bsw = 1.0 / lambda_
    return theta_s, hksat, lambda_, psi_s, bsw


def residual_theta(theta_s: np.ndarray, psi_s: np.ndarray,
                   lambda_: np.ndarray) -> np.ndarray:
    """Residual water content at -31 bar (INIT.f90:707-726)."""
    return theta_s * ((-3.1e9 / (1000.0 * 9.8)) / psi_s) ** (-lambda_)


def land_selection_mask(soil_tex: np.ndarray,
                        theta_s_sum: np.ndarray) -> np.ndarray:
    """The reference's computable-cell test (HYBRID9.f90:122-123):
    textured soil, not water bodies (class 13), non-degenerate porosity.
    """
    return (soil_tex > 0) & (soil_tex != 13) & (theta_s_sum > c.TRUNC)


def load_soil(cfg, dtype: torch.dtype, device,
              land_grid: Optional[LandGrid] = None
              ) -> tuple[LandGrid, SoilParams]:
    """``(LandGrid, SoilParams)`` from ``cfg``, the parameters in
    ``dtype`` on ``device``.

    ``soil_source == "netcdf"`` reads the preprocessed per-layer file
    ``cfg.soil_path`` (the one-time offline analog of INIT's 30-arc-sec
    regrid); ``"raw"`` runs that regrid first (data/soil_raw.py) into
    ``cfg.soil_path`` (default ``<output_path>/soil_prep.nc``) and reads
    its product; otherwise, or without a path, the synthetic land mask at
    ``cfg.resolution_deg`` packed to a multiple of ``cfg.cell_block`` (or
    ``land_grid`` as given) and the deterministic synthetic soils
    (seed 0).  Under a multi-process launch exactly one process (rank 0)
    runs the raw regrid and the others wait for its published file.
    """
    soil_path = cfg.soil_path
    if cfg.soil_source == "raw":
        if not (cfg.soil_hwsd_path and cfg.soil_bnu_dir):
            raise ValueError("soil_source='raw' needs soil_hwsd_path "
                             "and soil_bnu_dir")
        from .soil_raw import prepare_soil
        from ..parallel.launch import process_count, process_index
        soil_path = soil_path or os.path.join(cfg.output_path,
                                              "soil_prep.nc")
        # Multi-process: exactly one process runs the (expensive) raw
        # regrid; the rest wait at a barrier that rank 0 passes once the
        # product is published, so no rank reads an earlier run's file.
        # The reference serialized this kind of shared file access with
        # its MPI token ring (INIT.f90:167-244).
        if process_index() == 0:
            prepare_soil(cfg.soil_hwsd_path, cfg.soil_bnu_dir, soil_path,
                         n_layers=cfg.layer_grid().nsoil,
                         fmax_path=cfg.soil_fmax_path)
        else:
            log.info("waiting for process 0 to write %s", soil_path)
        if process_count() > 1:
            dist.monitored_barrier(
                timeout=datetime.timedelta(seconds=SOIL_WAIT_S))
    if cfg.soil_source in ("netcdf", "raw") and soil_path:
        fields = nc.read_grid_file(
            soil_path,
            ["theta_s", "hksat", "lambda", "psi_s", "fmax", "soil_tex"])
        soil_tex = fields["soil_tex"]
        theta_s = fields["theta_s"]
        mask = land_selection_mask(soil_tex, np.nansum(theta_s, axis=-1))
        grid = make_land_grid(mask, cfg.resolution_deg, cfg.cell_block)
        # The texture map, for the init-diagnostic dump (INIT.f90:835).
        grid = dataclasses.replace(grid,
                                   soil_tex=np.asarray(soil_tex, np.float64))
        lambda_ = np.maximum(fields["lambda"], c.TRUNC)
        raw = dict(
            theta_s=grid.pack(theta_s, fill=0.4),
            hksat=grid.pack(fields["hksat"], fill=1.0e-3),
            lambda_=grid.pack(lambda_, fill=0.2),
            psi_s=grid.pack(fields["psi_s"], fill=-300.0),
            fmax=np.nan_to_num(grid.pack(fields["fmax"], fill=FMAX_DEFAULT),
                               nan=FMAX_DEFAULT),
        )
        raw["bsw"] = 1.0 / raw["lambda_"]
        raw["theta_m"] = residual_theta(raw["theta_s"], raw["psi_s"],
                                        raw["lambda_"])
        log.info("loaded NetCDF soil: %d land cells (%d padded)",
                 grid.n_land, grid.n_padded)
    else:
        grid = land_grid
        if grid is None:
            mask = synthetic_land_mask(cfg.resolution_deg)
            grid = make_land_grid(mask, cfg.resolution_deg, cfg.cell_block)
        raw = synthetic_soil_params(grid.n_padded, seed=0,
                                    lat=grid.cell_lat)
        log.info("synthetic soil: %d land cells (%d padded)",
                 grid.n_land, grid.n_padded)
    return grid, SoilParams.from_numpy(raw, dtype, device)
