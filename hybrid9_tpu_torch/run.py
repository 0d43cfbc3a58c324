"""Simulation set-up: what ``Config`` means for the day step.

Port of ``hybrid9_tpu/run.py::Simulation.__init__`` and
``step_kwargs``: geometry, the initial state, the routing network
assembled for the dense kinematic router, the snow parameters, and the
keyword arguments that make ``step.day_step`` / ``block_step`` run the
configured physics.  The year loop with forcing providers, output,
checkpoints and the focus-cell writer is not ported yet (ROADMAP A6), nor
a persistently sharded state (ROADMAP A9).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .config import Config
from .grids.grid import LandGrid
from .grids.routing import direction_codes, flow_length_m, load_network
from .physics.hydrology import Geometry
from .physics.routing import GridKinematicParams, GridRouting
from .physics.snow import SnowParams
from .state import ModelState, SoilParams, initial_state
from .step import waits


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; None means the card.  Raises
    where None is given and there is no CUDA device, so that an entry
    point never carries on on the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's entry points run on the GPU "
            "unless the caller asks for device='cpu'")
    return torch.device("cuda")


class Simulation:
    """Owns the parameters, the state and the day step's configuration.

    ``params`` (and ``state``, when given) say where the run lives: every
    tensor made here goes to their device.  ``devices`` optionally names
    the devices whose slabs of cells the hydrology day runs on
    (``hydrology_day_sharded``).
    """

    def __init__(self, cfg: Config, params: SoilParams,
                 state: Optional[ModelState] = None, sharding=None,
                 land_grid: Optional[LandGrid] = None,
                 devices: Optional[Sequence] = None):
        if sharding is not None:
            waits("sharding (a persistently sharded state)",
                  "A9 (multi-device)")
        self.cfg = cfg
        self.grid = cfg.layer_grid()
        self.dtype = getattr(torch, cfg.dtype)
        self.device = params.theta_s.device
        self.geom = Geometry.from_layer_grid(self.grid)
        self.params = params
        self.n = params.n_cells
        if state is None:
            state = initial_state(params, self.grid.dz, self.grid.zi,
                                  self.dtype, self.device)
        self.state = state
        self.devices = None if devices is None else list(devices)
        self.use_kernel = cfg.use_kernel
        if self.use_kernel is None:
            self.use_kernel = self.device.type == "cuda"
        if self.use_kernel and self.device.type != "cuda":
            raise ValueError("use_kernel=True needs CUDA tensors; the day "
                             "kernel has no CPU form")

        self.routing = None
        routing_form = cfg.routing_form
        if routing_form == "auto":
            routing_form = ("grid" if cfg.routing_scheme
                            in ("kinematic", "muskingum") else "packed")
        if routing_form == "grid" and cfg.routing_scheme not in (
                "kinematic", "muskingum"):
            raise ValueError(
                "routing_form='grid' is the dense form of the sub-daily "
                "routers; set routing_scheme='kinematic' or 'muskingum' "
                f"(got {cfg.routing_scheme!r})")
        if cfg.lateral_routing and land_grid is not None:
            if (cfg.routing_scheme, routing_form) != ("kinematic", "grid"):
                waits(f"routing_scheme={cfg.routing_scheme!r} with "
                      f"routing_form={routing_form!r}",
                      "A5.6 (Muskingum-Cunge and the packed routers)")
            self.routing = self._grid_kinematic_routing(land_grid)
        if cfg.lateral_groundwater and land_grid is not None:
            waits("lateral_groundwater=True", "A5.6 (lateral groundwater)")
        self.lateral = None
        self.snow = None
        self.snow_albedo = None
        if cfg.snow:
            if cfg.snow_scheme == "twolayer":
                waits("snow_scheme='twolayer'", "A5.6 (two-layer snow)")
            self.snow = SnowParams(ddf=cfg.snow_ddf)
            if cfg.snow_albedo:
                self.snow_albedo = (float(cfg.snow_alpha),
                                    float(cfg.snow_masking_swe))
        self.n_land = land_grid.n_land if land_grid is not None else None

    def _grid_kinematic_routing(self, land_grid: LandGrid) -> GridRouting:
        """The synthetic D8 network as the dense kinematic router's
        operands on this run's device."""
        cfg = self.cfg
        down, _elev = load_network(land_grid, cfg.routing_network_path)
        codes = direction_codes(land_grid, down)
        length_g = land_grid.scatter(flow_length_m(land_grid, down),
                                     fill=1.0)
        # Padding lanes point one past the dense grid; route_grid_day
        # scatters and gathers the land lanes only.
        flat_idx = np.full(self.n, land_grid.ny * land_grid.nx, np.int64)
        flat_idx[:land_grid.n_land] = land_grid.land_idx
        return GridRouting(
            params=GridKinematicParams(
                dir_code=torch.tensor(codes, dtype=torch.int32,
                                      device=self.device),
                flow_length=torch.tensor(length_g, dtype=self.dtype,
                                         device=self.device),
                n_substeps=cfg.routing_substeps,
                c0=cfg.routing_celerity),
            flat_idx=torch.tensor(flat_idx, device=self.device),
            n_land=int(land_grid.n_land), ny=int(land_grid.ny),
            nx=int(land_grid.nx))

    def step_kwargs(self) -> Dict:
        """Keyword arguments configuring ``step.day_step`` (and
        ``block_step``) for this run: one source of truth for the physics
        configuration."""
        cfg = self.cfg
        return dict(
            use_kernel=self.use_kernel, routing=self.routing,
            lateral=self.lateral, snow=self.snow, freeze=cfg.frozen_soil,
            vegetation=cfg.vegetation,
            soil_ice=cfg.frozen_soil and cfg.soil_ice,
            devices=self.devices, zd09_every=cfg.zd09_every,
            snow_albedo=self.snow_albedo,
            carbon=cfg.carbon and cfg.vegetation)
