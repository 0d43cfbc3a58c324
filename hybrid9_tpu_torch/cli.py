"""Command-line interface of the PyTorch port.

Port of ``hybrid9_tpu/cli.py``, the replacement for the reference's
driver.txt + slurm_submit launch path (EXECUTE/driver.txt;
EXECUTE/slurm_submit):

    python -m hybrid9_tpu_torch run --config run.json [--years 1901 1910]
    python -m hybrid9_tpu_torch run --config run.json --device cpu
    python -m hybrid9_tpu_torch prep-soil --hwsd ... --bnu-dir ... --out ...
    python -m hybrid9_tpu_torch info

``run`` takes the JAX package's Config files (their TPU-only keys are
dropped) and runs on the card unless ``--device`` names another.  The
commands that are not ported yet (``site``, ``calibrate``, ``ensemble``,
``assimilate``) are there and raise, naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from .step import waits
from .utils.logging import get_logger

log = get_logger(__name__)

#: The log line of a resumed run: (checkpoint year, seconds to restore).
RESUME_LOG = "resumed from checkpoint year %d in %.3fs"

#: Named focus sites for ``run --focus`` (a copy of the JAX package's
#: ``site.DEBUG_SITES``): (lon, lat).
DEBUG_SITES = {
    "vaira": (-120.95, 38.41),          # Vaira Ranch, CA (LCLIM site)
    "sarawak": (114.0, 2.5),            # Borneo rainforest
    "kalahari": (21.5, -23.0),          # semi-arid (NISURF stability site)
    "cambridge": (0.1, 52.2),           # temperate maritime
    "harvard_forest": (-72.17, 42.54),  # temperate deciduous
    "sahara": (10.0, 23.0),             # hyper-arid
    "indonesia": (117.0, 0.5),          # humid tropics
}


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
    if args.spinup_carbon:
        waits("run --spinup-carbon", "A7 (site mode and spin-up)")
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
                    help="carbon spin-up before the run (ROADMAP A7)")
    pr.set_defaults(fn=cmd_run)

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
            ("site", "A7 (site mode and spin-up)",
             "single-column site simulation"),
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
