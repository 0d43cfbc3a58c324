"""Command-line interface of the PyTorch port.

Port of ``hybrid9_tpu/cli.py``, the replacement for the reference's
driver.txt + slurm_submit launch path (EXECUTE/driver.txt;
EXECUTE/slurm_submit):

    python -m hybrid9_tpu_torch run --config run.json [--years 1901 1910]
    python -m hybrid9_tpu_torch run --config run.json --spinup-carbon 8
    python -m hybrid9_tpu_torch run --config run.json --device cpu
    python -m hybrid9_tpu_torch site --csv-out site.csv [--spinup 10]
    python -m hybrid9_tpu_torch site --engine kernel [--device cpu]
    python -m hybrid9_tpu_torch prep-soil --hwsd ... --bnu-dir ... --out ...
    python -m hybrid9_tpu_torch info

``run`` takes the JAX package's Config files (their TPU-only keys are
dropped) and runs on the card unless ``--device`` names another, as does
``site --engine kernel``.  The commands that are not ported yet
(``calibrate``, ``ensemble``, ``assimilate``) are there and raise,
naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from .site import DEBUG_SITES
from .step import waits
from .utils.logging import get_logger

log = get_logger(__name__)

#: The log line of a resumed run: (checkpoint year, seconds to restore).
RESUME_LOG = "resumed from checkpoint year %d in %.3fs"

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


def _provider(cfg, grid, dtype, device):
    """The forcing provider ``cfg.forcing`` names."""
    from .data.forcing import (NetCDFForcingProvider, PrefetchingProvider,
                               SyntheticForcingProvider)
    if cfg.forcing == "pgf" and cfg.forcing_path:
        return PrefetchingProvider(NetCDFForcingProvider(
            cfg.forcing_path, grid, dtype=dtype, device=device))
    if cfg.forcing == "device-synthetic":
        from .data.device_forcing import DeviceSyntheticForcingProvider
        return DeviceSyntheticForcingProvider(
            grid.n_padded, seed=0, lat=grid.cell_lat, dtype=dtype,
            device=device)
    return PrefetchingProvider(SyntheticForcingProvider(
        grid.n_padded, seed=0, lat=grid.cell_lat, dtype=dtype,
        device=device))


def cmd_run(args: argparse.Namespace) -> int:
    from .data.soil import load_soil
    from .io.checkpoint import Checkpointer
    from .io.writer import AnnualWriter, write_init_diagnostics
    from .run import Simulation, resolve_device
    from .state import initial_state

    if args.shard:
        waits("run --shard", "A9 (multi-device)")
    cfg = _config(args)
    device = resolve_device(args.device)
    dtype = getattr(torch, cfg.dtype)
    grid, params = load_soil(cfg, dtype, device)
    state = None
    if args.resume:
        lg = cfg.layer_grid()
        template = initial_state(params, lg.dz, lg.zi, dtype, device)
        t0 = time.perf_counter()
        year, state = Checkpointer(cfg.checkpoint_path).restore(template)
        cfg = dataclasses.replace(cfg, start_year=year + 1)
        log.info(RESUME_LOG, year, time.perf_counter() - t0)
    provider = _provider(cfg, grid, dtype, device)
    try:
        sim = Simulation(cfg, params, state=state, land_grid=grid)
        if cfg.write_annual and not args.resume:
            # Init-time diagnostic artifacts, as the reference writes at
            # INIT (psi_s.nc INIT.f90:686-689; chunk.nc/soil_tex.nc
            # INIT.f90:823-835).
            write_init_diagnostics(cfg.output_path, grid, params)
        if args.spinup_carbon:
            # Equilibrate the carbon and vegetation pools under the start
            # year's repeated climate before the run (spinup.py).
            from .spinup import spinup_carbon
            rep = spinup_carbon(sim, provider, max_loops=args.spinup_carbon,
                                tol_slow=args.spinup_tol)
            log.info("carbon spin-up: %s", rep)
        writer = (AnnualWriter(cfg.output_path, grid) if cfg.write_annual
                  else None)
        checkpointer = (Checkpointer(cfg.checkpoint_path)
                        if cfg.checkpoint_every_years else None)
        sim.run(provider, writer=writer, checkpointer=checkpointer)
    finally:
        close = getattr(provider, "close", None)
        if close is not None:
            close()
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


def _not_ported(command: str, item: str):
    def fn(args: argparse.Namespace) -> int:
        waits(f"the {command!r} command", item)
    return fn


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
                    help="shard cells over processes (ROADMAP A9)")
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

    for command, item, text in (
            ("calibrate", "A8 (ensembles, DA and calibration)",
             "fit soil parameters to observed ET"),
            ("ensemble", "A8 (ensembles, DA and calibration)",
             "parameter-perturbed ensemble of a configured year"),
            ("assimilate", "A8 (ensembles, DA and calibration)",
             "EnSRF data assimilation of observed daily ET")):
        ps = sub.add_parser(command, help=f"{text} (ROADMAP {item[:2]})")
        ps.set_defaults(fn=_not_ported(command, item), any_arguments=True)

    # A command that is not ported yet raises whatever its arguments.
    args, rest = p.parse_known_args(argv)
    if rest and not getattr(args, "any_arguments", False):
        p.error(f"unrecognized arguments: {' '.join(rest)}")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
