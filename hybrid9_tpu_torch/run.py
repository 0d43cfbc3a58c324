"""Simulation driver: years of forcing blocks with annual diagnostics.

Port of ``hybrid9_tpu/run.py``, the replacement for the reference's main
loop nest (SOURCE/HYBRID9.f90:87-332, PROGRAM H9): decade -> cell ->
year -> day becomes year -> forcing block -> day over all cells.  Set-up
(geometry, the initial state, the routing network and the router's
operands, the lateral groundwater grid, the snow parameters, the focus
cell) and the keyword
arguments that make ``step.day_step`` / ``block_step`` run the configured
physics; ``run_year`` streams forcing block by block, ``run`` writes the
annual files and checkpoints.  Under a ``sharding`` (one rank of a
multi-process run, parallel/sharding.py) the simulation holds the rank's
slab of the cell axis, and the router and lateral groundwater run on the
gathered axis.  With several ``devices`` (or a sharding over several) it
holds its cells as device slabs (``parallel.sharding.DeviceSlabs``): the
state, parameters, forcing and sums of each slab stay on its device from
day to day, and the run loop's days are ``step.slab_block_step``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import calendar
from .config import Config
from .grids.grid import LandGrid
from .grids.routing import (bankfull_width_m, cell_area_m2,
                            direction_codes, flow_accumulation,
                            flow_length_m, load_network, reach_slope,
                            slope_from_accumulation)
from .io.writer import FocusCSVWriter, to_host
from .parallel.launch import local_device, process_count
from .parallel.sharding import DeviceSlabs, Gathered, slab_devices
from .physics.hydrology import Geometry
from .physics.lateral import make_lateral_params
from .physics.routing import (GridKinematicParams, GridMuskingumParams,
                              GridRouting, KinematicParams, MuskingumParams,
                              RoutingParams)
from .physics.snow import SnowParams, TwoLayerSnowParams
from .state import AnnualAccumulators, Forcing, ModelState, SoilParams, \
    initial_state
from .step import (annual_means, block_step, day_step, slab_block_step,
                   slab_day_step)
from .utils.logging import get_logger

log = get_logger(__name__)

#: The log lines of a year and of its output, which tools may read by
#: their arguments: (year, days, seconds, cell-days/s, seconds waiting on
#: forcing, max |residual| mm) and (year, output seconds, checkpoint
#: seconds).
YEAR_LOG = ("year %d: %d days in %.2fs (%.0f cell-days/s), forcing wait "
            "%.3fs, max|residual|=%.3g mm")
OUTPUT_LOG = "year %d: output %.3fs, checkpoint %.3fs"


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; None means the card (a rank of a
    multi-process run: its own, ``parallel.launch.local_device``).  Raises
    where None is given and there is no CUDA device, so that an entry
    point never carries on on the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's entry points run on the GPU "
            "unless the caller asks for device='cpu'")
    if process_count() > 1:
        return local_device()
    return torch.device("cuda")


class Simulation:
    """Owns the parameters, the state and the day step's configuration.

    ``params`` (and ``state``, when given) say where the run lives: every
    tensor made here goes to their device.  ``devices`` optionally names
    devices of that type to hold the cells as slabs, one a device (a
    device may repeat): the state, the parameters and each block's
    forcing and sums stay on the slabs' devices across days, the
    cell-local modules run slab by slab, and the router and lateral
    groundwater exchange halo rows and reshards or gather once a day
    (``step.slab_block_step``).  ``state`` is then a property: reading it
    gathers the slabs onto the first device, setting it cuts them again,
    and a checkpoint holds the gathered state, so a run resumes at any
    number of slabs.  ``step_kwargs()`` still names the devices, so a
    caller of ``day_step`` on the whole state runs its hydrology day
    through ``hydrology_day_sharded``.  With ``sharding`` (a
    ``parallel.sharding.CellSharding``) the run is one rank's: ``params``
    and ``state`` are cut to its slab ``[host_lo, host_hi)`` (a slab given
    passes through), the hydrology day runs on the rank's devices, and the
    router and lateral groundwater gather their operands from every rank
    once a day; a rank of several devices cuts its slab over them.  With
    ``cfg.interactive`` and a
    ``land_grid``, the land cell nearest ``(site_lon, site_lat)`` is the
    focus cell whose daily rows go to ``focus_daily.csv`` and
    ``focus_wt.csv`` (the reference's single-point debug mode,
    INIT.f90:220-236, HYBRID9.f90:221-229).
    """

    def __init__(self, cfg: Config, params: SoilParams,
                 state: Optional[ModelState] = None, sharding=None,
                 land_grid: Optional[LandGrid] = None,
                 devices: Optional[Sequence] = None):
        self.cfg = cfg
        self.grid = cfg.layer_grid()
        self.dtype = getattr(torch, cfg.dtype)
        self.sharding = sharding
        self.n_global = (sharding.n if sharding is not None
                         else params.n_cells)
        # This rank's slab of the cell axis (one process owns every cell).
        self.host_lo, self.host_hi = 0, self.n_global
        if sharding is not None:
            sharding.check_divisible(self.n_global)
            params = sharding.put(params)
            if state is not None:
                state = sharding.put(state)
            self.host_lo, self.host_hi = sharding.lo, sharding.hi
        devices = slab_devices(sharding, devices)
        self.device = params.theta_s.device
        self.geom = Geometry.from_layer_grid(self.grid)
        self.params = params
        self.n = params.n_cells
        if state is None:
            state = initial_state(params, self.grid.dz, self.grid.zi,
                                  self.dtype, self.device)
        self.devices = None if devices is None else list(devices)
        self.slabs = None
        if devices is not None:
            self.slabs = DeviceSlabs.create(self.n, devices)
            if self.slabs.devices[0].type != self.device.type:
                raise ValueError(
                    f"parameters on {self.device} cannot be cut over "
                    f"{[str(d) for d in self.slabs.devices]}")
            self._param_slabs = self.slabs.put(params)
        self.state = state
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
            self.routing = self._gathered(self._routing(land_grid,
                                                        routing_form))
        self.lateral = None
        if cfg.lateral_groundwater and land_grid is not None:
            self.lateral = self._gathered(make_lateral_params(
                land_grid, self.device, k_lat=cfg.lateral_k))
        self.snow = None
        self.snow_albedo = None
        if cfg.snow:
            scheme = (TwoLayerSnowParams if cfg.snow_scheme == "twolayer"
                      else SnowParams)
            self.snow = scheme(ddf=cfg.snow_ddf)
            if cfg.snow_albedo:
                self.snow_albedo = (float(cfg.snow_alpha),
                                    float(cfg.snow_masking_swe))
        self.focus_idx = None
        self.focus_writer = None
        if cfg.interactive and land_grid is not None:
            focus = land_grid.cell_index_of(cfg.site_lon, cfg.site_lat)
            log.info("interactive focus cell: packed %d at (%.2f, %.2f)",
                     focus, cfg.site_lon, cfg.site_lat)
            # The rank that owns the cell traces it and writes the CSVs.
            if self.host_lo <= focus < self.host_hi:
                self.focus_idx = focus - self.host_lo
                self.focus_writer = FocusCSVWriter(cfg.output_path)
        self.n_land = land_grid.n_land if land_grid is not None else None
        self.annual_results: List[Dict[str, np.ndarray]] = []
        #: Per simulated year: wall seconds of the year, of waiting on
        #: forcing, of the annual output and of the checkpoint.
        self.timings: List[Dict[str, float]] = []

    @property
    def state(self) -> ModelState:
        """The model state over this run's cells; on device slabs gathered
        onto the first device (a copy of every slab, each read)."""
        if self.slabs is None:
            return self._state
        return self.slabs.gather(self._state, "state")

    @state.setter
    def state(self, state: ModelState) -> None:
        self._state = state if self.slabs is None else self.slabs.put(state)

    @property
    def slab_states(self) -> list:
        """The model state as it is held: on device slabs one tree a slab
        on its device, else a list of the one state.  Nothing is gathered
        or cut, on reading or on setting."""
        return [self._state] if self.slabs is None else list(self._state)

    @slab_states.setter
    def slab_states(self, states: list) -> None:
        self._state = states[0] if self.slabs is None else list(states)

    def _gathered(self, params):
        """A cross-cell module's global ``params``, wrapped to gather its
        operands from every rank when the run is one rank's slab."""
        if self.sharding is None:
            return params
        return Gathered(params, self.sharding)

    def _routing(self, land_grid: LandGrid, routing_form: str):
        """The router's operands on this run's device, for
        ``cfg.routing_scheme`` in ``routing_form`` ("grid" or "packed"),
        on the network of ``cfg.routing_network_path`` (the synthetic D8
        network without one)."""
        cfg = self.cfg
        down, elev = load_network(land_grid, cfg.routing_network_path)

        def put(arr, dtype=None):
            """A packed array as the JAX package holds it: the float32
            geometry stays float32 and promotes in the arithmetic."""
            return torch.tensor(np.asarray(arr), device=self.device,
                                dtype=dtype)

        def put_dense(packed, fill):
            return put(land_grid.scatter(packed, fill=fill), self.dtype)

        if routing_form == "grid":
            codes = put(direction_codes(land_grid, down), torch.int32)
            length = put_dense(flow_length_m(land_grid, down), 1.0)
        else:
            downstream = put(down, torch.int64)
            length = put(flow_length_m(land_grid, down))
        if cfg.routing_scheme == "muskingum":
            acc = flow_accumulation(land_grid, down)
            if elev is None and cfg.routing_network_path is not None:
                # A flow-direction file without a DEM: synthetic
                # elevation would give slopes unrelated to the real
                # network, so take them from the drainage area.
                log.warning("%s has no 'elevation': Muskingum reach slopes "
                            "estimated from drainage area (Flint's law)",
                            cfg.routing_network_path)
                slope = slope_from_accumulation(acc)
            else:
                slope = reach_slope(land_grid, down, elevation=elev)
            geometry = dict(n_substeps=cfg.routing_substeps,
                            n_manning=cfg.routing_manning)
            if routing_form == "packed":
                return MuskingumParams(
                    downstream=downstream, flow_length=length,
                    slope=put(slope), width=put(bankfull_width_m(acc)),
                    cell_area=put(cell_area_m2(land_grid)), **geometry)
            params = GridMuskingumParams(
                dir_code=codes, flow_length=length,
                slope=put_dense(slope, 1.0e-3),
                width=put_dense(bankfull_width_m(acc), 1.0),
                cell_area=put_dense(cell_area_m2(land_grid), 1.0),
                **geometry)
        elif cfg.routing_scheme == "kinematic":
            wave = dict(n_substeps=cfg.routing_substeps,
                        c0=cfg.routing_celerity)
            if routing_form == "packed":
                return KinematicParams(downstream=downstream,
                                       flow_length=length, **wave)
            params = GridKinematicParams(dir_code=codes, flow_length=length,
                                         **wave)
        else:
            return RoutingParams(downstream=downstream, k=cfg.routing_k)
        # Padding lanes point one past the dense grid; route_grid_day
        # scatters and gathers the land lanes only.
        flat_idx = np.full(self.n_global, land_grid.ny * land_grid.nx,
                           np.int64)
        flat_idx[:land_grid.n_land] = land_grid.land_idx
        return GridRouting(params=params,
                           flat_idx=torch.tensor(flat_idx,
                                                 device=self.device),
                           n_land=int(land_grid.n_land),
                           ny=int(land_grid.ny), nx=int(land_grid.nx))

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

    def accumulators(self):
        """Zeroed annual sums for :meth:`advance`: one set a slab on its
        device with device slabs."""
        def zeros(n, device):
            return AnnualAccumulators.zeros(n, self.dtype, device,
                                            nsoil=self.grid.nsoil)
        if self.slabs is None:
            return zeros(self.n, self.device)
        return [zeros(hi - lo, d)
                for d, (lo, hi) in zip(self.slabs.devices, self.slabs.bounds)]

    def forcing_block(self, provider, year: int, start_doy: int,
                      n_days: int):
        """``provider``'s block of ``n_days`` from ``start_doy``: on device
        slabs each slab's columns delivered to its device where the
        provider can (``slab_block``), else the whole block, which
        :meth:`advance` cuts."""
        if self.slabs is not None and hasattr(provider, "slab_block"):
            return provider.slab_block(self.slabs, year, start_doy, n_days)
        return provider(year, start_doy, n_days)

    def advance(self, block, acc):
        """The state advanced over the days of a forcing block (a
        ``Forcing`` of ``[days, n]``, or on device slabs one a slab),
        with the days added to ``acc`` (:meth:`accumulators`).  Returns
        ``(acc, rows)``: ``rows`` the focus cell's stacked daily rows, or
        None without a focus cell."""
        run = (self.geom, self.cfg.dt, self.cfg.nisurf)
        if self.slabs is None:
            out = block_step(self._state, acc, block, self.params, *run,
                             focus_idx=self.focus_idx, **self.step_kwargs())
        else:
            out = slab_block_step(self.slabs, self._state, acc,
                                  self._slab_blocks(block),
                                  self._param_slabs, *run,
                                  focus_idx=self.focus_idx,
                                  **self.step_kwargs())
        self._state, acc = out[:2]
        return acc, (out[2] if len(out) > 2 else None)

    def days(self, block):
        """Advance the state a day at a time over the days of a forcing
        block (as :meth:`advance` takes it), yielding each day's
        diagnostics as a list: one dict a slab, each on its slab's device
        (the one dict without slabs).  The state stays where it is held
        (:attr:`slab_states`)."""
        run = (self.geom, self.cfg.dt, self.cfg.nisurf)
        kw = self.step_kwargs()
        if self.slabs is None:
            for d in range(block.tas.shape[0]):
                self._state, diags = day_step(
                    self._state, block.map(lambda x: x[d]), self.params,
                    *run, **kw)
                yield [diags]
            return
        blocks = self._slab_blocks(block)
        for d in range(blocks[0].tas.shape[0]):
            self._state, diags = slab_day_step(
                self.slabs, self._state, [b.map(lambda x: x[d])
                                          for b in blocks],
                self._param_slabs, *run, **kw)
            yield diags

    def _slab_blocks(self, block) -> list:
        """A forcing block as one block a slab on its device: one from
        :meth:`forcing_block` already is, a whole block is cut."""
        return block if isinstance(block, list) else self.slabs.put_block(
            block)

    def join(self, parts: list) -> torch.Tensor:
        """The slabs' tensors, cells on the last axis, joined in cell order
        on the first device and counted as one ``"result"`` exchange (the
        one tensor, without slabs)."""
        if self.slabs is None:
            return parts[0]
        return self.slabs.gather(parts, "result", axis=-1)

    def host_means(self, acc) -> Dict[str, np.ndarray]:
        """The annual means of ``acc`` as float64 numpy arrays over this
        run's cells: one device-to-host copy (one a slab, joined in cell
        order)."""
        if self.slabs is None:
            return to_host(annual_means(acc, self.cfg.nisurf))
        return self.slabs.host([annual_means(a, self.cfg.nisurf)
                                for a in acc])

    def run_year(self, year: int,
                 forcing_provider: Callable[[int, int, int], Forcing],
                 block_days: Optional[int] = None
                 ) -> Dict[str, np.ndarray]:
        """Simulate one calendar year; returns the annual means as numpy.

        ``forcing_provider(year, start_doy, n_days)`` returns a ``Forcing``
        of ``[n_days, n]`` tensors on the run's device (data/forcing.py).
        Inside the year the host waits for the device only to copy the
        focus rows of each block; the means come to the host in one copy
        (one a slab) at its end, which closes the timed year.
        """
        cfg = self.cfg
        ndays = calendar.days_in_year(year)
        block_days = block_days or cfg.forcing_block_days
        acc = self.accumulators()
        t0 = time.perf_counter()
        wait = 0.0
        doy = 1
        # Double-buffered ingest: while the device integrates block k, a
        # PrefetchingProvider builds block k+1 (on the last block, next
        # year's first) on its thread.
        prefetch = getattr(forcing_provider, "prefetch", None)
        while doy <= ndays:
            nblk = min(block_days, ndays - doy + 1)
            if prefetch is not None:
                if doy + nblk <= ndays:
                    prefetch(year, doy + nblk,
                             min(block_days, ndays - (doy + nblk) + 1))
                elif year < cfg.end_year:
                    prefetch(year + 1, 1,
                             min(block_days, calendar.days_in_year(year + 1)))
            tw = time.perf_counter()
            block = self.forcing_block(forcing_provider, year, doy, nblk)
            wait += time.perf_counter() - tw
            acc, rows = self.advance(block, acc)
            if rows is not None and self.focus_writer is not None:
                self.focus_writer.append(year, doy, rows)
            doy += nblk

        means = self.host_means(acc)
        elapsed = time.perf_counter() - t0
        self._health_check(year, means)
        # Land lanes only: padding lanes carry cell 0's forcing.
        res_land = means["max_abs_residual"][:self._local_land_count()]
        max_res = float(np.max(res_land)) if res_land.size else 0.0
        log.info(YEAR_LOG, year, ndays, elapsed, self.n * ndays / elapsed,
                 wait, max_res)
        self.timings.append(dict(year=year, seconds=elapsed,
                                 forcing_wait_s=wait))
        self.annual_results.append(means)
        return means

    def _local_land_count(self) -> int:
        """Number of real (non-padding) cells in this rank's slab of the
        means: padding lanes sit at the top of the packed axis, inside the
        last rank's slab."""
        if self.n_land is None:
            return self.host_hi - self.host_lo
        return int(np.clip(self.n_land - self.host_lo, 0,
                           self.host_hi - self.host_lo))

    def _health_check(self, year: int, means: Dict[str, np.ndarray]
                      ) -> None:
        """Failure detection: NaN state or broken water balance.

        The reference aborts the whole MPI job with the offending cell's
        coordinates (HYDROLOGY.f90:1244-1274); here the worst cells are
        logged with their packed indices and the run goes on: callers can
        treat a logged error as fatal.
        """
        res = means["max_abs_residual"][:self._local_land_count()]
        bad_nan = ~np.isfinite(res)
        if np.any(bad_nan):
            idx = self.host_lo + np.flatnonzero(bad_nan)[:8]
            log.error("year %d: NON-FINITE state in %d cells (packed "
                      "idx %s)", year, int(bad_nan.sum()), idx.tolist())
        worst = np.nanmax(res) if res.size else 0.0
        if worst > 1.0:
            i = self.host_lo + int(np.nanargmax(res))
            log.error("year %d: water-balance residual %.3g mm >> 0.1 mm "
                      "at packed cell %d", year, float(worst), i)
        elif worst > 0.1:
            # Isolated float32 exceedances of the reference's 0.1 mm abort
            # threshold occur at its "problem point" cells
            # (driver.txt:34-59; DEVIATIONS.md).
            i = self.host_lo + int(np.nanargmax(res))
            log.warning("year %d: water-balance residual %.3g mm > "
                        "0.1 mm at packed cell %d", year, float(worst), i)

    def run(self, forcing_provider, writer=None,
            checkpointer=None) -> List[Dict[str, np.ndarray]]:
        """Run [start_year, end_year], writing each year's annual file
        (the reference's axy<year>.nc, HYBRID9.f90:492-519) with
        ``writer`` and a checkpoint every ``checkpoint_every_years`` with
        ``checkpointer``; closes the focus writer at the end."""
        cfg = self.cfg
        for year in range(cfg.start_year, cfg.end_year + 1):
            means = self.run_year(year, forcing_provider)
            t = self.timings[-1]
            if writer is not None:
                t0 = time.perf_counter()
                writer.write_annual(year, means)
                t["write_s"] = time.perf_counter() - t0
            if (checkpointer is not None and cfg.checkpoint_every_years
                    and (year - cfg.start_year + 1)
                    % cfg.checkpoint_every_years == 0):
                t0 = time.perf_counter()
                checkpointer.save(year, self.state)
                t["checkpoint_s"] = time.perf_counter() - t0
            log.info(OUTPUT_LOG, year, t.get("write_s", 0.0),
                     t.get("checkpoint_s", 0.0))
        if checkpointer is not None:
            checkpointer.wait()
        if self.focus_writer is not None:
            self.focus_writer.close()
            self.focus_writer = None
        return self.annual_results
