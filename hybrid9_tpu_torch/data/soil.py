"""Soil-property ingest: the land grid and the per-cell soil parameters.

Port of the synthetic branch of ``hybrid9_tpu/data/soil.py::load_soil``
(the stand-in for the reference's INIT-time soil ingest, SOURCE/
INIT.f90:473-726).  Reading preprocessed or raw soil archives is not
ported yet (ROADMAP A6).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..grids.grid import LandGrid, make_land_grid, synthetic_land_mask
from ..state import SoilParams
from .synthetic import synthetic_soil_params


def load_soil(cfg, dtype: torch.dtype, device,
              land_grid: Optional[LandGrid] = None
              ) -> tuple[LandGrid, SoilParams]:
    """``(LandGrid, SoilParams)`` from ``cfg``: the synthetic land mask at
    ``cfg.resolution_deg`` packed to a multiple of ``cfg.cell_block``
    (or ``land_grid`` as given) and the deterministic synthetic soils
    (seed 0) in ``dtype`` on ``device``."""
    if cfg.soil_source != "synthetic":
        raise NotImplementedError(
            f"soil_source={cfg.soil_source!r}: reading soil files is not "
            "ported yet: ROADMAP A6 (year loop, forcing and I/O)")
    if land_grid is None:
        mask = synthetic_land_mask(cfg.resolution_deg)
        land_grid = make_land_grid(mask, cfg.resolution_deg, cfg.cell_block)
    raw = synthetic_soil_params(land_grid.n_padded, seed=0,
                                lat=land_grid.cell_lat)
    return land_grid, SoilParams.from_numpy(raw, dtype, device)
