"""The reference case: the inputs the headline day loop runs on.

Port of ``__graft_entry__._build``: synthetic soil parameters (seed 0),
the initial state and day-180 synthetic forcing (seed 1) for ``n_cells``
packed cells on the canonical 8-layer grid.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import Config
from .data.synthetic import synthetic_forcing_day, synthetic_soil_params
from .physics.hydrology import Geometry
from .state import Forcing, ModelState, SoilParams, initial_state


class ReferenceCase(NamedTuple):
    state: ModelState
    forcing: Forcing
    params: SoilParams
    geom: Geometry
    cfg: Config


def build_reference_case(n_cells: int, dtype: str = "float32",
                         device="cpu") -> ReferenceCase:
    """Params, state, day-180 forcing, geometry and config for
    ``n_cells`` cells in ``dtype`` on ``device``."""
    cfg = Config(dtype=dtype)
    grid = cfg.layer_grid()
    tdtype = getattr(torch, dtype)
    params = SoilParams.from_numpy(synthetic_soil_params(n_cells, seed=0),
                                   tdtype, device)
    state = initial_state(params, grid.dz, grid.zi, tdtype, device)
    forcing = Forcing.from_numpy(
        synthetic_forcing_day(n_cells, 180, seed=1), tdtype, device)
    return ReferenceCase(state, forcing, params,
                         Geometry.from_layer_grid(grid), cfg)
