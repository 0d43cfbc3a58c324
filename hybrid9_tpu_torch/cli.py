"""Command-line interface of the PyTorch port.

Port of ``hybrid9_tpu/cli.py``, the replacement for the reference's
driver.txt + slurm_submit launch path (EXECUTE/driver.txt;
EXECUTE/slurm_submit):

    python -m hybrid9_tpu_torch run --config run.json [--years 1901 1910]
    python -m hybrid9_tpu_torch run --config run.json --spinup-carbon 8
    python -m hybrid9_tpu_torch run --config run.json --device cpu
    python -m hybrid9_tpu_torch site --csv-out site.csv [--spinup 10]
    python -m hybrid9_tpu_torch site --engine kernel [--device cpu]
    python -m hybrid9_tpu_torch calibrate --climate c.csv --obs obs.csv
    python -m hybrid9_tpu_torch calibrate --config run.json --obs-twin 0.4
    python -m hybrid9_tpu_torch ensemble --config run.json --members 8
    python -m hybrid9_tpu_torch assimilate --config run.json --obs-twin 0.5
    python -m hybrid9_tpu_torch prep-soil --hwsd ... --bnu-dir ... --out ...
    python -m hybrid9_tpu_torch info

``run``, ``calibrate --config``, ``ensemble`` and ``assimilate`` take the
JAX package's Config files (their TPU-only keys are dropped).  Every
command that runs the model runs on the card unless ``--device`` names
another (``site`` with ``--engine kernel``).

Multi-process runs launch the same command in every process with
``--shard`` (``torchrun --nproc-per-node N -m hybrid9_tpu_torch run
--shard ...``, or ``WORLD_SIZE``/``RANK``/``MASTER_ADDR``/``MASTER_PORT``
set by hand): each rank owns one slab of the packed cell axis, reads
only its own forcing, writes a part file that rank 0 stitches and saves
its own checkpoint (parallel/).  ``--shard`` in one process takes
every visible card: the cells are cut once into a slab a card, which
each card keeps from day to day (``parallel.sharding.DeviceSlabs``).
``run`` splits the dense routers and lateral groundwater into row bands,
and runs ``--spinup-carbon`` on the slabs too; ``ensemble``,
``assimilate`` and ``calibrate --config`` fold and fit each slab on its
card and join the outputs once, at the end.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from . import calendar
from .parallel.launch import initialize_distributed, process_index
from .site import DEBUG_SITES
from .utils.logging import get_logger

log = get_logger(__name__)

#: The log line of a resumed run: (checkpoint year, seconds to restore).
RESUME_LOG = "resumed from checkpoint year %d in %.3fs"
#: The log line of an ensemble run: (members, cells, days, seconds of the
#: run closed by its host copy, device).
ENSEMBLE_LOG = ("ensemble: %d members x %d cells x %d days in %.2fs "
                "(member axis folded into the cell axis, device %s)")
#: The log line of the twin observations of ``assimilate --obs-twin``:
#: (log-multiplier, seconds).
TWIN_LOG = ("twin experiment: obs generated at hksat log-multiplier %.3f "
            "in %.2fs")
#: The last log line of ``run``: (rank, ranks, day-kernel launches,
#: collectives by caller, days, peak device memory GB).
RANK_LOG = ("run done: process %d/%d, %d day-kernel launches, "
            "collectives %s in %d days, peak device memory %.3f GB")

def _config(args: argparse.Namespace):
    """The run's Config: ``--config`` (or the defaults), with ``--years``
    and ``--focus`` applied."""
    from .config import Config
    cfg = Config()
    if args.config:
        with open(args.config) as f:
            cfg = Config.from_json(f.read())
    if args.years:
        cfg = dataclasses.replace(cfg, start_year=args.years[0],
                                  end_year=args.years[1])
    if args.focus:
        # INTERACTIVE mode: "--focus site-name" or "--focus lon,lat"
        # (the reference's focus-point debug mode, driver.txt:28-60).
        if args.focus in DEBUG_SITES:
            lon, lat = DEBUG_SITES[args.focus]
        else:
            lon, lat = (float(v) for v in args.focus.split(","))
        cfg = dataclasses.replace(cfg, interactive=True, site_lon=lon,
                                  site_lat=lat)
    return cfg


def _host_provider(cfg, grid, dtype, device, sharding=None):
    """The host forcing provider ``cfg.forcing`` names: the PGF archive,
    or the host synthetic generator (which ``device-synthetic`` falls
    back to here).  Under a multi-process ``sharding`` it reads only the
    rank's slab (the lat-row band of a PGF archive, as each MPI rank read
    only its tile, READ_NET_CDF_3DR.f90:95-97) and delivers it on the
    rank's device."""
    from .data.forcing import (HostShardedProvider, NetCDFForcingProvider,
                               SyntheticForcingProvider)
    multihost = sharding is not None and sharding.world > 1
    if cfg.forcing == "pgf" and cfg.forcing_path:
        local = NetCDFForcingProvider(
            cfg.forcing_path, grid, dtype=dtype, device=device,
            cell_range=(sharding.lo, sharding.hi) if multihost else None)
        if multihost:
            log.info("pgf shard read band: rows [%d, %d) of %d (%.0f%%)",
                     local.row_lo, local.row_hi, grid.ny,
                     100.0 * (local.row_hi - local.row_lo) / grid.ny)
    else:
        local = SyntheticForcingProvider(
            grid.n_padded, seed=0, lat=grid.cell_lat, dtype=dtype,
            device=device,
            cell_slice=slice(sharding.lo, sharding.hi) if multihost
            else None)
    if multihost:
        return HostShardedProvider(local, sharding, grid.n_padded)
    return local


def _provider(cfg, grid, dtype, device, sharding=None):
    """The forcing provider of ``run``: ``cfg.forcing`` on the run's
    device, the rank's slab of it under ``sharding``."""
    from .data.forcing import PrefetchingProvider
    if cfg.forcing == "device-synthetic":
        from .data.device_forcing import DeviceSyntheticForcingProvider
        return DeviceSyntheticForcingProvider(
            grid.n_padded, seed=0, lat=grid.cell_lat, dtype=dtype,
            device=device, sharding=sharding)
    return PrefetchingProvider(_host_provider(cfg, grid, dtype, device,
                                              sharding))


def _sharding(shard: bool, n: int, device):
    """The ``CellSharding`` of this process over ``n`` cells with
    ``--shard``, else None; a multi-process launch needs ``--shard``."""
    from .parallel.launch import process_count
    from .parallel.sharding import CellSharding
    if not shard:
        if process_count() > 1:
            raise SystemExit("multi-host runs require --shard")
        return None
    sharding = CellSharding.create(n, device)
    sharding.check_divisible(n)
    return sharding


def cmd_run(args: argparse.Namespace) -> int:
    from .data.soil import load_soil
    from .io.checkpoint import Checkpointer
    from .io.writer import (AnnualWriter, ShardedAnnualWriter,
                            write_init_diagnostics)
    from .parallel import sharding as parallel
    from .physics import day_kernel
    from .run import Simulation, resolve_device
    from .state import initial_state

    initialize_distributed()
    cfg = _config(args)
    device = resolve_device(args.device)
    dtype = getattr(torch, cfg.dtype)
    grid, params = load_soil(cfg, dtype, device)
    sharding = _sharding(args.shard, grid.n_padded, device)
    multihost = sharding is not None and sharding.world > 1
    state = None
    if args.resume:
        lg = cfg.layer_grid()
        # Each rank restores only its own slab.
        local = params if sharding is None else sharding.put(params)
        template = initial_state(local, lg.dz, lg.zi, dtype,
                                 local.theta_s.device)
        t0 = time.perf_counter()
        year, state = Checkpointer(cfg.checkpoint_path,
                                   sharding=sharding).restore(template)
        cfg = dataclasses.replace(cfg, start_year=year + 1)
        log.info(RESUME_LOG, year, time.perf_counter() - t0)
    provider = _provider(cfg, grid, dtype, device, sharding)
    launches0 = day_kernel.launches
    collectives0 = dict(parallel.collectives)
    try:
        sim = Simulation(cfg, params, state=state, sharding=sharding,
                         land_grid=grid)
        if cfg.write_annual and not args.resume and process_index() == 0:
            # Init-time diagnostic artifacts, as the reference writes at
            # INIT (psi_s.nc INIT.f90:686-689; chunk.nc/soil_tex.nc
            # INIT.f90:823-835).
            write_init_diagnostics(
                cfg.output_path, grid, params,
                n_shards=sharding.world if sharding is not None else 1)
        if args.spinup_carbon:
            # Equilibrate the carbon and vegetation pools under the start
            # year's repeated climate before the run (spinup.py).
            from .spinup import spinup_carbon
            rep = spinup_carbon(sim, provider, max_loops=args.spinup_carbon,
                                tol_slow=args.spinup_tol)
            log.info("carbon spin-up: %s", rep)
        writer = None
        if cfg.write_annual:
            writer = (ShardedAnnualWriter(cfg.output_path, grid,
                                          sharding.lo, sharding.hi)
                      if multihost else AnnualWriter(cfg.output_path, grid))
        checkpointer = (Checkpointer(cfg.checkpoint_path, sharding=sharding)
                        if cfg.checkpoint_every_years else None)
        sim.run(provider, writer=writer, checkpointer=checkpointer)
    finally:
        close = getattr(provider, "close", None)
        if close is not None:
            close()
    days = sum(calendar.days_in_year(y)
               for y in range(cfg.start_year, cfg.end_year + 1))
    peak = (torch.cuda.max_memory_allocated(sim.device) / 1e9
            if sim.device.type == "cuda" else 0.0)
    log.info(RANK_LOG, process_index(),
             sharding.world if sharding is not None else 1,
             day_kernel.launches - launches0,
             {k: v - collectives0.get(k, 0)
              for k, v in parallel.collectives.items()
              if v != collectives0.get(k, 0)}, days, peak)
    return 0


def cmd_site(args: argparse.Namespace) -> int:
    from .config import Config
    from .site import (VAIRA_LAI_WAYPOINTS, read_lclim_daily_csv,
                       read_lclim_subdaily_csv, read_site_climate_csv,
                       read_site_subdaily_csv, run_site)

    cfg = Config(spinup_years=args.spinup, nisurf=args.nisurf)
    climate = None
    lai_waypoints = None
    grow = True
    obs_daily = None
    if args.lclim_daily:
        # Reference-format positional LCLIM files (HYBRID9.f90:368-460),
        # with the embedded Vaira LAI phenology: prescribed LAI turns
        # growth off, as the reference's LCLIM mode does.
        climate, obs_daily = read_lclim_daily_csv(args.lclim_daily)
        if args.lclim_year and args.lclim_year in VAIRA_LAI_WAYPOINTS:
            lai_waypoints = VAIRA_LAI_WAYPOINTS[args.lclim_year]
            grow = False
    elif args.climate:
        climate = read_site_climate_csv(args.climate)
    subdaily = None
    if args.lclim_subdaily:
        subdaily = read_lclim_subdaily_csv(args.lclim_subdaily,
                                           cfg.nisurf)
    elif args.subdaily:
        subdaily = read_site_subdaily_csv(args.subdaily, cfg.nisurf)
    result = run_site(cfg, climate=climate, subdaily=subdaily,
                      lai_waypoints=lai_waypoints, grow=grow,
                      csv_out=args.csv_out, engine=args.engine,
                      evap_obs_daily=obs_daily,
                      record_year_days=365 if args.noleap else None,
                      device=args.device)
    worst = max(r["max_residual"] for r in result.daily)
    log.info("site run done (engine=%s): %d days, final LAI %.3f, "
             "max|residual| %.3g mm", args.engine, len(result.daily),
             result.daily[-1]["lai"], worst)
    return 0


def cmd_prep_soil(args: argparse.Namespace) -> int:
    """One-time soil preprocessing: raw HWSD/BNU archives -> the
    per-layer parameter file ``run`` reads (soil_source='netcdf'), the
    offline analog of the reference's INIT-time soil regrid
    (INIT.f90:473-680)."""
    from .data.soil_raw import prepare_soil
    prepare_soil(args.hwsd, args.bnu_dir, args.out, n_layers=args.layers,
                 fmax_path=args.fmax, pattern=args.pattern,
                 band_coarse_rows=args.band_rows)
    return 0


def cmd_info(args: argparse.Namespace) -> int:
    from . import __version__
    print(f"hybrid9_tpu_torch {__version__}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} visible card(s)")
    for i in range(torch.cuda.device_count()):
        print(f"  cuda:{i} {torch.cuda.get_device_name(i)}")
    return 0


def _single_host_provider(cfg, grid, dtype, device):
    """The forcing provider of a closed-loop command without ``--shard``
    (:func:`_host_provider`; no prefetch thread: the commands read one
    block).  Without a sharding these commands refuse a multi-process
    launch: every process would silently redo the same global problem."""
    from .parallel.launch import process_count
    if process_count() > 1:
        raise SystemExit(
            "calibrate/ensemble/assimilate are single-process drivers "
            "without --shard (every process would redo the same global "
            "problem); pass --shard (calibrate/assimilate) or run them "
            "on one host")
    return _host_provider(cfg, grid, dtype, device)


def _stacked_forcing(cfg, grid, n_days: int, dtype, device):
    """A ``[days, n]`` Forcing of the Config's start year from 1 January,
    on ``device``."""
    provider = _single_host_provider(cfg, grid, dtype, device)
    return provider(cfg.start_year, 1, n_days)


def _sharded_stacked_forcing(cfg, grid, n_days: int, shard: bool, dtype,
                             device):
    """``(sharding, [days, n] Forcing)`` of a closed-loop command.

    ``shard=False``: no sharding and the whole block.  ``shard=True``:
    this process's ``CellSharding``, and under a multi-process launch only
    the rank's slab of the block, read by the rank alone, as ``run
    --shard`` reads it."""
    if not shard:
        return None, _stacked_forcing(cfg, grid, n_days, dtype, device)
    sharding = _sharding(True, grid.n_padded, device)
    provider = _host_provider(cfg, grid, dtype, device, sharding)
    return sharding, provider(cfg.start_year, 1, n_days)


def _gather_host(x: torch.Tensor, sharding=None):
    """A C-contiguous host numpy copy of a diagnostics-sized tensor; under
    a sharding, one whose last axis is the rank's cells is first gathered
    from every rank (the whole axis on every rank).  Contiguous, as the
    JAX package's are: numpy's reductions over the copy then add in one
    order however the tensor was laid out."""
    if sharding is not None and x.dim() > 0:
        x = sharding.all_gather_cells(x, "output")
    return x.detach().contiguous().cpu().numpy()


def _global_problem(args: argparse.Namespace):
    """``(cfg, device, dtype, grid, params, state0, geom)`` of a closed-loop
    command on the Config file ``args.config``, joining the process group
    of a multi-process launch first."""
    from .config import Config
    from .data.soil import load_soil
    from .physics.hydrology import Geometry
    from .run import resolve_device
    from .state import initial_state

    initialize_distributed()
    with open(args.config) as f:
        cfg = Config.from_json(f.read())
    device = resolve_device(args.device)
    dtype = getattr(torch, cfg.dtype)
    grid, params = load_soil(cfg, dtype, device)
    lg = cfg.layer_grid()
    state0 = initial_state(params, lg.dz, lg.zi, dtype, device)
    return cfg, device, dtype, grid, params, state0, \
        Geometry.from_layer_grid(lg)


def _observations(args, grid, ndays: int, dtype, device):
    """``(obs, mask)`` of ``--obs-npz`` as ``[days, n]`` tensors (the
    padding lanes masked), or ``(None, mask)`` without one."""
    import numpy as np
    n = grid.n_padded
    mask = np.zeros((ndays, n), bool)
    mask[:, :grid.n_land] = True       # padding lanes carry no obs
    obs = None
    if args.obs_npz:
        with np.load(args.obs_npz) as d:
            et = np.asarray(d["et"], np.float64)
            if et.shape != (ndays, grid.n_land):
                raise SystemExit(
                    f"--obs-npz et shape {et.shape} != "
                    f"({ndays}, {grid.n_land}) (days, n_land)")
            full = np.zeros((ndays, n))
            full[:, :grid.n_land] = et
            if "mask" in d:
                mask[:, :grid.n_land] &= np.asarray(d["mask"], bool)
        obs = torch.tensor(full, dtype=dtype, device=device)
    return obs, mask


def cmd_calibrate_global(args: argparse.Namespace) -> int:
    """Calibrate the real configured model (``--config``): the
    ``load_soil`` parameters on the packed grid, optionally one multiplier
    per cell (a spatial inversion).

    Observations: ``--obs-npz`` (arrays ``et`` [days, n_land], optional
    ``mask``) or ``--obs-twin LOGMULT`` (a twin experiment: observations
    made by the model under a known log-multiplier, fitted from zero).
    The fit differentiates the plain day on the run's device; a default
    fit at 0.5 degrees (60 days, 100 steps) takes hours on the card (PERF.md).
    """
    import json

    import numpy as np

    from .calibrate import CalibrationSpec, calibrate, simulate_daily_et
    from .parallel.sharding import slab_devices

    cfg, device, dtype, grid, params, state0, geom = _global_problem(args)
    ndays = args.days
    sharding, forcing = _sharded_stacked_forcing(cfg, grid, ndays,
                                                 args.shard, dtype, device)
    n = grid.n_padded
    fields = tuple(args.fields.split(","))
    spec = CalibrationSpec(fields=fields, per_cell=args.per_cell)
    obs, mask = _observations(args, grid, ndays, dtype, device)
    if sharding is not None:
        # The rank's slab of the problem; the fit passes slabs through.
        params, state0 = sharding.put(params), sharding.put(state0)
        if obs is not None:
            obs = sharding.put_block(obs)
    if obs is None and args.obs_twin is not None:
        true_theta = {f: torch.full((params.n_cells,) if args.per_cell
                                    else (),
                                    float(args.obs_twin), dtype=dtype,
                                    device=device)
                      for f in fields}
        with torch.no_grad():
            obs = simulate_daily_et(true_theta, params, state0, forcing,
                                    geom, cfg.nisurf,
                                    devices=slab_devices(sharding))
        log.info("twin experiment: obs generated at log-multiplier "
                 "%.3f on %s", args.obs_twin, ",".join(fields))
    elif obs is None:
        raise SystemExit("global calibrate needs --obs-npz or --obs-twin")

    res = calibrate(params, state0, forcing, geom, obs, spec=spec,
                    nisurf=cfg.nisurf, steps=args.steps,
                    learning_rate=args.lr,
                    obs_mask=torch.tensor(mask, device=device),
                    sharding=sharding)
    hist = _gather_host(res.loss_history)
    log.info("global calibrate: %d cells (%d land), %d days, "
             "per_cell=%s, sharded=%s, loss %.4g -> %.4g (%d steps)",
             n, grid.n_land, ndays, args.per_cell, sharding is not None,
             hist[0], hist[-1], args.steps)
    theta_np = {k: _gather_host(v, sharding) for k, v in res.theta.items()}
    if args.obs_twin is not None:
        for k, v in theta_np.items():
            land = v[:grid.n_land] if v.ndim else v
            log.info("  %s: fitted log-mult mean %.4f (true %.4f)",
                     k, float(np.mean(land)), args.obs_twin)
    if args.out and process_index() == 0:
        if args.per_cell:
            np.savez(args.out,
                     **{k: np.exp(v) for k, v in theta_np.items()},
                     loss_history=hist, n_land=grid.n_land)
        else:
            with open(args.out, "w") as f:
                json.dump({"multipliers": {k: float(np.exp(v))
                                           for k, v in theta_np.items()},
                           "loss_initial": float(hist[0]),
                           "loss_final": float(hist[-1])}, f, indent=2)
        log.info("wrote %s", args.out)
    return 0


def cmd_ensemble(args: argparse.Namespace) -> int:
    """Run a parameter-perturbed ensemble of the configured year with the
    members folded into the cell axis (ensemble.py) and write spread
    diagnostics: the one-command form of the reference's one-SLURM-job-
    per-member workflow (notes.txt's /save1../save6 output dirs diffed by
    hand).  On the card each day is one launch of the day kernel at
    ``members x cells``."""
    import numpy as np

    from .ensemble import perturbed_multipliers, run_ensemble_annual
    from .io import netcdf

    cfg, device, dtype, grid, params, state0, geom = _global_problem(args)
    ndays = args.days or calendar.days_in_year(cfg.start_year)
    sharding, forcing = _sharded_stacked_forcing(cfg, grid, ndays,
                                                 args.shard, dtype, device)
    fields = tuple(args.fields.split(","))
    generator = torch.Generator(device=device).manual_seed(args.seed)
    theta = perturbed_multipliers(generator, args.members, fields=fields,
                                  sigma=args.sigma, dtype=dtype)
    t0 = time.perf_counter()
    out = run_ensemble_annual(theta, params, state0, forcing, geom,
                              nisurf=cfg.nisurf, vegetation=cfg.vegetation,
                              use_kernel=cfg.use_kernel,
                              zd09_every=cfg.zd09_every, sharding=sharding)
    # The host copy closes the timed region.
    out = {k: _gather_host(v, sharding) for k, v in out.items()}
    elapsed = time.perf_counter() - t0
    log.info(ENSEMBLE_LOG, args.members, grid.n_padded, ndays, elapsed,
             device)
    if process_index() != 0:
        return 0

    fields_nc = {}
    for name, stacked in out.items():
        mean = np.mean(stacked, axis=0)
        std = np.std(stacked, axis=0)
        fields_nc[f"{name}_mean"] = grid.scatter(mean.astype(np.float64))
        fields_nc[f"{name}_std"] = grid.scatter(std.astype(np.float64))
        fields_nc[f"{name}_control"] = grid.scatter(
            stacked[0].astype(np.float64))        # member 0 = control
    path = args.out or "ensemble.nc"
    netcdf.write_grid_file(path, fields_nc, grid.lon, grid.lat)
    log.info("wrote %s (%d members, sigma=%.2f on %s)", path,
             args.members, args.sigma, ",".join(fields))
    return 0


def cmd_calibrate(args: argparse.Namespace) -> int:
    """Fit soil-parameter multipliers to observed daily ET by adjoint
    (calibrate.py): the closed-loop form of the reference's manual LCLIM
    model-vs-obs comparison (HYBRID9.f90:449; notes.txt's hand parameter
    sweeps).  Runs on the single-column site configuration, or on the
    real configured global model with ``--config``
    (:func:`cmd_calibrate_global`)."""
    if args.config:
        return cmd_calibrate_global(args)
    import json

    import numpy as np

    from .calibrate import CalibrationSpec, calibrate
    from .config import Config
    from .data.synthetic import synthetic_forcing_day, synthetic_soil_params
    from .physics import reference_column as ref
    from .physics.hydrology import Geometry
    from .run import resolve_device
    from .site import (_kernel_soil_params, _split_obs,
                       read_site_climate_csv, read_site_subdaily_csv)
    from .state import Forcing, initial_state

    cfg = Config(nisurf=args.nisurf)
    grid = cfg.layer_grid()
    device = resolve_device(args.device)

    # Forcing record: site climate CSV or one synthetic year.
    if args.climate:
        climate = read_site_climate_csv(args.climate)
    else:
        climate = [
            ref.DailyForcing(**{k: float(v[0]) for k, v in
                                synthetic_forcing_day(
                                    1, d + 1, seed=17,
                                    lat=np.array([cfg.site_lat])).items()})
            for d in range(365)]
    ndays = len(climate)
    dtype = getattr(torch, cfg.dtype)
    keys = ("tas", "rlds", "rsds", "huss", "ps", "pr", "rhs")
    forcing = Forcing(**{
        k: torch.tensor(np.array([[getattr(d, k)] for d in climate]),
                        dtype=dtype, device=device) for k in keys})

    # Observations: --obs CSV (doy, evap_obs in mm/day) or the evap_obs
    # column of a sub-daily LCLIM CSV summed to daily.
    obs_by_doy = {}
    if args.obs:
        import csv
        with open(args.obs) as f:
            for row in csv.DictReader(f):
                obs_by_doy[int(row["doy"])] = float(row["evap_obs"])
    elif args.subdaily:
        sub = read_site_subdaily_csv(args.subdaily, cfg.nisurf)
        _, obs_by_doy = _split_obs(sub)
    else:
        raise SystemExit("calibrate needs --obs or --subdaily "
                         "(observed daily ET)")
    obs = np.zeros((ndays, 1))
    mask = np.zeros((ndays, 1), bool)
    for doy, v in obs_by_doy.items():
        if 1 <= doy <= ndays:
            obs[doy - 1, 0] = v
            mask[doy - 1, 0] = True
    if not mask.any():
        raise SystemExit("no usable observations in the record")

    nl = grid.nsoil
    raw = synthetic_soil_params(1, seed=17, n_layers=nl)
    col = ref.ColumnParams(
        theta_s=raw["theta_s"][0], hksat=raw["hksat"][0],
        bsw=raw["bsw"][0], psi_s=raw["psi_s"][0],
        fmax=float(raw["fmax"][0]))
    params = _kernel_soil_params(col, dtype, device)
    state0 = initial_state(params, grid.dz, grid.zi, dtype, device)
    geom = Geometry.from_layer_grid(grid)

    spec = CalibrationSpec(fields=tuple(args.fields.split(",")))
    res = calibrate(params, state0, forcing, geom,
                    torch.tensor(obs, dtype=dtype, device=device),
                    spec=spec, nisurf=cfg.nisurf, steps=args.steps,
                    learning_rate=args.lr,
                    obs_mask=torch.tensor(mask, device=device))
    hist = _gather_host(res.loss_history)
    multipliers = {k: float(np.exp(_gather_host(v)))
                   for k, v in res.theta.items()}
    log.info("calibrate: %d obs days, loss %.4g -> %.4g (%d steps)",
             int(mask.sum()), hist[0], hist[-1], args.steps)
    for k, m in multipliers.items():
        log.info("  %s multiplier: %.4f", k, m)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"multipliers": multipliers,
                       "loss_initial": float(hist[0]),
                       "loss_final": float(hist[-1]),
                       "steps": args.steps,
                       "obs_days": int(mask.sum())}, f, indent=2)
        log.info("wrote %s", args.out)
    return 0


def cmd_assimilate(args: argparse.Namespace) -> int:
    """Sequential EnSRF data assimilation on the real configured model
    (assimilate.py): a parameter-perturbed ensemble forecasts each day (on
    the card one launch of the day kernel at ``members x cells``), and a
    cell-local scalar-observation square-root analysis updates the soil
    water and per-cell hksat log-multipliers from observed daily ET: the
    closed-loop form of the reference's only use of observations, the
    visual LCLIM model-vs-obs comparison (HYBRID9.f90:449).

    Observations: ``--obs-npz`` (arrays ``et`` [days, n_land], optional
    ``mask``) or ``--obs-twin LOGMULT`` (a twin experiment: observations
    made by the model under a known hksat log-multiplier)."""
    import numpy as np

    from .assimilate import EnKFConfig, assimilate
    from .calibrate import simulate_daily_et
    from .parallel.sharding import slab_devices

    cfg, device, dtype, grid, params, state0, geom = _global_problem(args)
    ndays = args.days
    sharding, forcing = _sharded_stacked_forcing(cfg, grid, ndays,
                                                 args.shard, dtype, device)
    n = grid.n_padded
    obs, mask = _observations(args, grid, ndays, dtype, device)
    if sharding is not None:
        # The rank's slab of the problem: the twin observations are made
        # on it, and the filter passes slabs through.
        params, state0 = sharding.put(params), sharding.put(state0)
        if obs is not None:
            obs = sharding.put_block(obs)
    if obs is None and args.obs_twin is not None:
        true_theta = {"hksat": torch.full((), float(args.obs_twin),
                                          dtype=dtype, device=device)}
        t0 = time.perf_counter()
        with torch.no_grad():
            obs = simulate_daily_et(true_theta, params, state0, forcing,
                                    geom, cfg.nisurf,
                                    vegetation=cfg.vegetation,
                                    devices=slab_devices(sharding))
        log.info(TWIN_LOG, args.obs_twin, time.perf_counter() - t0)
    elif obs is None:
        raise SystemExit("assimilate needs --obs-npz or --obs-twin")

    t0 = time.perf_counter()
    res = assimilate(params, state0, forcing, obs, geom,
                     n_members=args.members, nisurf=cfg.nisurf,
                     obs_mask=torch.tensor(mask, device=device),
                     theta_spread=args.spread, seed=args.seed,
                     vegetation=cfg.vegetation, use_kernel=cfg.use_kernel,
                     zd09_every=cfg.zd09_every,
                     cfg=EnKFConfig(obs_err_std=args.obs_err,
                                    rtps=args.rtps),
                     sharding=sharding)
    tm = _gather_host(res["theta_mean"], sharding)
    elapsed = time.perf_counter() - t0
    ts = _gather_host(res["theta_std"], sharding)
    y_pred = _gather_host(res["y_pred_mean"], sharding)
    obs_h = _gather_host(obs, sharding)
    # Innovation statistics over OBSERVED land entries only: masked-out
    # cells and days carry meaningless obs values.
    err = np.abs(y_pred - obs_h)[:, :grid.n_land]
    err = np.where(mask[:, :grid.n_land], err, np.nan)
    with np.errstate(invalid="ignore"):
        early = float(np.nanmean(err[:max(1, ndays // 5)]))
        late = float(np.nanmean(err[-max(1, ndays // 5):]))
    log.info("assimilate: %d members x %d cells x %d days in %.2fs "
             "(device %s); posterior hksat log-mult mean %.4f (spread "
             "%.4f -> %.4f); ET innovation %.4g -> %.4g mm/day",
             args.members, n, ndays, elapsed, device,
             float(np.mean(tm[:grid.n_land])), args.spread,
             float(np.median(ts[:grid.n_land])), early, late)
    if args.obs_twin is not None:
        log.info("  true log-multiplier: %.4f", args.obs_twin)
    if args.out and process_index() == 0:
        np.savez(args.out, theta_mean=tm[:grid.n_land],
                 theta_std=ts[:grid.n_land],
                 hksat_multiplier=np.exp(tm[:grid.n_land]),
                 y_pred_mean=y_pred[:, :grid.n_land],
                 n_land=grid.n_land)
        log.info("wrote %s", args.out)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="hybrid9_tpu_torch",
                                description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    pr = sub.add_parser("run", help="global simulation")
    pr.add_argument("--config", help="Config JSON file")
    pr.add_argument("--years", nargs=2, type=int, metavar=("S", "E"))
    pr.add_argument("--device", default=None,
                    help="torch device of the run (default: the card; "
                         "'cpu' runs the plain twin on the CPU)")
    pr.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint")
    pr.add_argument("--focus", default=None, metavar="SITE|LON,LAT",
                    help="INTERACTIVE mode: daily CSV for one focus cell "
                         "(a site name of DEBUG_SITES or lon,lat)")
    pr.add_argument("--shard", action="store_true",
                    help="shard cells over the processes of a "
                         "multi-process launch (each rank owns a slab); "
                         "in one process, over every visible card")
    pr.add_argument("--spinup-carbon", type=int, default=0,
                    metavar="MAX_YEARS",
                    help="equilibrate the carbon and vegetation pools under "
                         "the start year's repeated climate before the run "
                         "(semi-analytic spin-up; needs Config.carbon)")
    pr.add_argument("--spinup-tol", type=float, default=1.0,
                    help="spin-up convergence: max |d slow pool| per "
                         "rehearsal year, g C/m^2/yr")
    pr.set_defaults(fn=cmd_run)

    ps = sub.add_parser("site", help="single-column site simulation")
    ps.add_argument("--climate", help="daily climate CSV")
    ps.add_argument("--subdaily",
                    help="sub-daily observation CSV (doy, step, tak, rh, "
                         "rnet, par, ppt, evap_obs)")
    ps.add_argument("--lclim-daily",
                    help="reference-format positional daily LCLIM file "
                         "(doy, evap_obs, pr, tas, rh, huss, ps; "
                         "HYBRID9.f90:368-379)")
    ps.add_argument("--lclim-subdaily",
                    help="reference-format positional 37-column "
                         "sub-daily LCLIM file (HYBRID9.f90:426-460)")
    ps.add_argument("--lclim-year", type=int, default=None,
                    help="calendar year of the LCLIM record: selects "
                         "the reference's embedded Vaira LAI phenology "
                         "(2002/2003) and disables growth, as LCLIM "
                         "mode does")
    ps.add_argument("--csv-out", default="site_daily.csv")
    ps.add_argument("--spinup", type=int, default=0)
    ps.add_argument("--nisurf", type=int, default=48)
    ps.add_argument("--noleap", action="store_true",
                    help="the record uses a 365-day calendar (no leap "
                         "days): roll the output (year, doy) labels by "
                         "the record's own year length")
    ps.add_argument("--engine", choices=("oracle", "kernel"),
                    default="oracle",
                    help="float64 numpy oracle, or the model's tensor "
                         "code on one column")
    ps.add_argument("--device", default=None,
                    help="torch device of --engine kernel (default: the "
                         "card; 'cpu' runs it on the CPU)")
    ps.set_defaults(fn=cmd_site)

    pp = sub.add_parser("prep-soil",
                        help="preprocess raw HWSD/BNU soil archives")
    pp.add_argument("--hwsd", required=True,
                    help="HWSD texture NetCDF (soil_tex at model res)")
    pp.add_argument("--bnu-dir", required=True,
                    help="directory of BNU per-layer archive files")
    pp.add_argument("--out", required=True,
                    help="output preprocessed soil file")
    pp.add_argument("--fmax", default=None, help="Fmax NetCDF (optional)")
    pp.add_argument("--layers", type=int, default=8)
    pp.add_argument("--pattern", default="{var}_l{layer}.nc4")
    pp.add_argument("--band-rows", type=int, default=32,
                    help="coarse rows regridded per read (memory bound)")
    pp.set_defaults(fn=cmd_prep_soil)

    pi = sub.add_parser("info", help="version and device info")
    pi.set_defaults(fn=cmd_info)

    pc = sub.add_parser("calibrate",
                        help="fit soil parameters to observed ET "
                             "(adjoint/Adam; single column, or the "
                             "real global model with --config)")
    pc.add_argument("--config", default=None,
                    help="global Config JSON: calibrate the real "
                         "load_soil parameter set on the packed grid "
                         "instead of a synthetic column")
    pc.add_argument("--per-cell", action="store_true",
                    help="(global mode) one multiplier per cell "
                         "(spatial inversion) instead of one scalar "
                         "per field")
    pc.add_argument("--shard", action="store_true",
                    help="(global mode) cell-sharded fit over the "
                         "processes of a multi-process launch; in one "
                         "process, over every visible card")
    pc.add_argument("--days", type=int, default=60,
                    help="(global mode) days of forcing in the fit "
                         "window")
    pc.add_argument("--obs-npz",
                    help="(global mode) observations: npz with 'et' "
                         "[days, n_land] (mm/day) and optional 'mask'")
    pc.add_argument("--obs-twin", type=float, default=None,
                    metavar="LOGMULT",
                    help="(global mode) twin experiment: generate obs "
                         "from the model under this known log-"
                         "multiplier and fit from zero")
    pc.add_argument("--climate", help="daily climate CSV (site format)")
    pc.add_argument("--obs", help="observed daily ET CSV (doy, evap_obs "
                                  "in mm/day)")
    pc.add_argument("--subdaily",
                    help="sub-daily LCLIM CSV; its evap_obs column is "
                         "summed to daily observations")
    pc.add_argument("--fields", default="hksat,bsw,psi_s",
                    help="comma-separated parameters to fit")
    pc.add_argument("--steps", type=int, default=100)
    pc.add_argument("--lr", type=float, default=0.1)
    pc.add_argument("--nisurf", type=int, default=48)
    pc.add_argument("--out", default=None,
                    help="write fitted multipliers to this JSON file "
                         "(an npz with --per-cell)")
    pc.add_argument("--device", default=None,
                    help="torch device of the fit (default: the card)")
    pc.set_defaults(fn=cmd_calibrate)

    pe = sub.add_parser("ensemble",
                        help="parameter-perturbed ensemble of a "
                             "configured year, members folded into the "
                             "cell axis")
    pe.add_argument("--config", required=True, help="Config JSON file")
    pe.add_argument("--members", type=int, default=8)
    pe.add_argument("--sigma", type=float, default=0.3,
                    help="log-normal multiplier spread")
    pe.add_argument("--seed", type=int, default=0)
    pe.add_argument("--fields", default="hksat,bsw,psi_s",
                    help="comma-separated parameters to perturb")
    pe.add_argument("--days", type=int, default=None,
                    help="days to integrate (default: the full start "
                         "year)")
    pe.add_argument("--shard", action="store_true",
                    help="cell-sharded ensemble over the processes of a "
                         "multi-process launch; in one process, over "
                         "every visible card")
    pe.add_argument("--out", default=None,
                    help="spread-diagnostics NetCDF (default "
                         "ensemble.nc)")
    pe.add_argument("--device", default=None,
                    help="torch device of the run (default: the card)")
    pe.set_defaults(fn=cmd_ensemble)

    pa = sub.add_parser("assimilate",
                        help="sequential EnSRF data assimilation of "
                             "observed daily ET (ensemble square-root "
                             "filter; updates soil water + per-cell "
                             "hksat multipliers)")
    pa.add_argument("--config", required=True, help="Config JSON file")
    pa.add_argument("--days", type=int, default=25,
                    help="days of forcing/observations to assimilate")
    pa.add_argument("--members", type=int, default=16,
                    help="ensemble width")
    pa.add_argument("--obs-npz",
                    help="observations: npz with 'et' [days, n_land] "
                         "(mm/day) and optional 'mask'")
    pa.add_argument("--obs-twin", type=float, default=None,
                    metavar="LOGMULT",
                    help="twin experiment: generate obs from the model "
                         "under this known hksat log-multiplier")
    pa.add_argument("--spread", type=float, default=0.3,
                    help="initial std of the hksat log-multiplier "
                         "ensemble")
    pa.add_argument("--obs-err", type=float, default=0.1,
                    help="observation error std (mm/day)")
    pa.add_argument("--rtps", type=float, default=0.6,
                    help="relaxation-to-prior-spread coefficient")
    pa.add_argument("--shard", action="store_true",
                    help="cell-sharded filter over the processes of a "
                         "multi-process launch; in one process, over "
                         "every visible card")
    pa.add_argument("--seed", type=int, default=0)
    pa.add_argument("--out", default=None,
                    help="write posterior npz (theta_mean/theta_std/"
                         "hksat_multiplier per land cell)")
    pa.add_argument("--device", default=None,
                    help="torch device of the run (default: the card)")
    pa.set_defaults(fn=cmd_assimilate)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
