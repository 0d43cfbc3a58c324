"""Routing-scheme cost/fidelity comparison.

Port of ``scripts/router_compare.py``.  The daily linear reservoir moves
water at most one cell per day, which physics/routing.py flags as too
slow for continental travel times at 0.5 degrees; the kinematic-wave and
variable-parameter Muskingum-Cunge routers move water at physical
celerity.  This probe measures what each scheme costs: the flagship
``day_step`` time under each scheme on the real land grid, plus a short
invariant-checked soak per scheme.

Usage: python -m hybrid9_tpu_torch.scripts.router_compare [--iters 50]
           [--soak-years 3]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from ..config import Config
from ..data.device_forcing import DeviceSyntheticForcingProvider
from ..data.soil import load_soil
from ..data.synthetic import synthetic_forcing_day
from ..run import Simulation, resolve_device
from ..state import Forcing
from ..step import day_step

SCHEMES = ("linear", "kinematic", "muskingum")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_scheme(cfg: Config, grid, params, iters: int) -> tuple:
    """ms of the eager flagship ``day_step`` under ``cfg`` on day 180's
    forcing: 3 warm-up days, then ``iters`` timed days closed by a device
    synchronisation and the host checksum of ``river_store``.  Returns
    (seconds a day, checksum)."""
    sim = Simulation(cfg, params, land_grid=grid)
    kw = sim.step_kwargs()
    day = synthetic_forcing_day(grid.n_padded, 180, seed=1,
                                lat=grid.cell_lat)
    forcing = Forcing.from_numpy(day, sim.dtype, sim.device)

    def step(state):
        return day_step(state, forcing, sim.params, sim.geom, cfg.dt,
                        cfg.nisurf, **kw)[0]

    state = sim.state
    for _ in range(3):
        state = step(state)
    float(torch.sum(state.river_store))
    t0 = time.perf_counter()
    for _ in range(iters):
        state = step(state)
    _sync(sim.device)
    checksum = float(torch.sum(state.river_store))
    return (time.perf_counter() - t0) / iters, checksum


def soak_scheme(cfg: Config, device) -> dict:
    """``cfg``'s years with device forcing; the worst residual, the final
    river store and annual discharge on land, and the clean verdict."""
    dtype = getattr(torch, cfg.dtype)
    grid, params = load_soil(cfg, dtype, device)
    provider = DeviceSyntheticForcingProvider(
        grid.n_padded, seed=0, lat=grid.cell_lat, dtype=dtype,
        device=device)
    sim = Simulation(cfg, params, land_grid=grid)
    t0 = time.perf_counter()
    worst = 0.0
    for year in range(cfg.start_year, cfg.end_year + 1):
        means = sim.run_year(year, provider)
        worst = max(worst, float(np.max(
            np.asarray(means["max_abs_residual"])[:grid.n_land])))
    river = sim.state.river_store[:grid.n_land].cpu().numpy()
    dis = np.asarray(means["discharge"])[:grid.n_land]
    # Stores may carry transient micro-negative "reclaim debits"
    # (< ~3e-3 mm observed): the day's local runoff is NEGATIVE on
    # drainage-fixup days — the reference's own semantics
    # (HYDROLOGY.f90:1204-1211 takes unmet soil deficits back out
    # of drainage) — and the router debits the store to conserve.
    ok = bool(worst < 0.1 and np.all(np.isfinite(river))
              and np.all(river >= -1e-2) and np.all(np.isfinite(dis)))
    return dict(seconds=time.perf_counter() - t0, worst=worst,
                mean_discharge=float(np.mean(dis)), min_river=float(
                    np.min(river)), clean=ok)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--soak-years", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    base_cfg = Config()
    dtype = getattr(torch, base_cfg.dtype)
    grid, params = load_soil(base_cfg, dtype, device)
    n = grid.n_padded
    rows = []
    for scheme in SCHEMES:
        cfg = dataclasses.replace(base_cfg, routing_scheme=scheme)
        dtd, checksum = time_scheme(cfg, grid, params, args.iters)
        assert np.isfinite(checksum)
        rows.append((scheme, dtd))
        print(f"{scheme:10s}: {dtd*1e3:7.2f} ms/day "
              f"({n/dtd/1e6:6.2f} M cells/s) "
              f"river_store sum {checksum:.4g} mm", flush=True)

    base = rows[0][1]
    for scheme, dtd in rows[1:]:
        print(f"{scheme:10s}: {(dtd-base)*1e3:+6.2f} ms vs linear "
              f"({100*(dtd-base)/base:+5.1f} %)")

    # Short invariant soak per scheme (the quick regression check).
    for scheme in SCHEMES:
        cfg = Config(start_year=1901, end_year=1900 + args.soak_years,
                     routing_scheme=scheme,
                     forcing="device-synthetic", write_annual=False)
        s = soak_scheme(cfg, device)
        print(f"soak {scheme:10s}: {args.soak_years} yr in "
              f"{s['seconds']:.0f}s, max|res| {s['worst']:.3g} mm, "
              f"mean discharge {s['mean_discharge']:.3g} mm/day "
              f"{'CLEAN' if s['clean'] else 'VIOLATION'}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
