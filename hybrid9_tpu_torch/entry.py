"""The two cases the port is driven on, as a user would build them.

``build_reference_case`` ports ``__graft_entry__._build``: synthetic soil
parameters (seed 0), the initial state and day-180 synthetic forcing
(seed 1) for ``n_cells`` packed cells on the canonical 8-layer grid, with
every extra off.  ``build_flagship_case`` ports the set-up of
``bench.py::_bench_flagship``: ``Config()`` as it stands (snow with the
albedo feedback, frozen soil, soil ice, carbon, dense kinematic routing)
on the packed global land grid.

Both place their tensors on the card unless the caller names a device.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from .config import Config
from .data.soil import load_soil
from .data.synthetic import synthetic_forcing_day, synthetic_soil_params
from .grids.grid import LandGrid
from .physics.hydrology import Geometry
from .run import Simulation, resolve_device
from .state import Forcing, ModelState, SoilParams, initial_state


class ReferenceCase(NamedTuple):
    state: ModelState
    forcing: Forcing
    params: SoilParams
    geom: Geometry
    cfg: Config


def build_reference_case(n_cells: int, dtype: str = "float32",
                         device=None) -> ReferenceCase:
    """Params, state, day-180 forcing, geometry and config for
    ``n_cells`` cells in ``dtype`` on ``device`` (None: the card; raises
    where there is none)."""
    device = resolve_device(device)
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


class FlagshipCase(NamedTuple):
    sim: Simulation
    forcing: Forcing
    step_kwargs: Dict
    land_grid: LandGrid


def build_flagship_case(device=None, dtype: str = "float32",
                        resolution_deg: float = 0.5) -> FlagshipCase:
    """The default-physics run on the packed global land grid at
    ``resolution_deg`` (0.5: 69,632 padded cells): the simulation, day-180
    synthetic forcing keyed to the cells' latitudes (seed 1), the keyword
    arguments of ``day_step`` and the land grid, in ``dtype`` on
    ``device`` (None: the card; raises where there is none)."""
    device = resolve_device(device)
    cfg = Config(dtype=dtype, resolution_deg=resolution_deg)
    tdtype = getattr(torch, dtype)
    land_grid, params = load_soil(cfg, tdtype, device)
    sim = Simulation(cfg, params, land_grid=land_grid)
    forcing = Forcing.from_numpy(
        synthetic_forcing_day(sim.n, 180, seed=1, lat=land_grid.cell_lat),
        tdtype, device)
    return FlagshipCase(sim, forcing, sim.step_kwargs(), land_grid)
