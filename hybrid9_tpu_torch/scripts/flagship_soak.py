"""Multi-year soak of the FULL production-default configuration.

Port of ``scripts/flagship_soak.py``.  It runs the flagship defaults
(degree-day snow with the snow-albedo feedback, prognostic soil ice and
temperature, frozen-soil impedance, the carbon cascade, kinematic-wave
routing, ``zd09_every=8``, the CUDA day kernel on the card) for N years
of synthetic forcing made on the device, and watches the health
invariants: finite state everywhere, a water-balance residual under
0.1 mm, and bounded prognostics (SWE under the cap, zwt in [0, 80],
carbon pools >= 0).

Usage: python -m hybrid9_tpu_torch.scripts.flagship_soak [--years 20]
Exit 0 iff every year is clean.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..config import Config
from ..data.device_forcing import DeviceSyntheticForcingProvider
from ..data.soil import load_soil
from ..run import Simulation, resolve_device

#: The state fields each year's checks read, as (name, path in ModelState).
CHECK_FIELDS = (("zwt", "soil.zwt"), ("wa", "soil.wa"),
                ("h2osoi", "soil.h2osoi_liq"), ("swe", "swe"),
                ("ice", "h2osoi_ice"), ("c_slow", "carbon.c_soil_slow"),
                ("river", "river_store"))


def soak_config(years: int, resolution: float = 0.5,
                snow_scheme: str = "degree-day",
                routing_scheme: str = "kinematic") -> Config:
    """The soak's Config: the defaults with device forcing, no files."""
    return Config(start_year=1901, end_year=1900 + years,
                  resolution_deg=resolution, snow_scheme=snow_scheme,
                  routing_scheme=routing_scheme,
                  forcing="device-synthetic", write_annual=False)


def land_fields(state, n_land: int) -> dict:
    """The land cells of each checked field as numpy, from one host copy
    of them all."""
    parts = []
    for _, path in CHECK_FIELDS:
        x = state
        for attr in path.split("."):
            x = getattr(x, attr)
        parts.append(x[:n_land])
    flat = torch.cat([p.reshape(-1) for p in parts]).cpu().numpy()
    out, lo = {}, 0
    for (name, _), p in zip(CHECK_FIELDS, parts):
        out[name] = flat[lo:lo + p.numel()].reshape(tuple(p.shape))
        lo += p.numel()
    return out


def year_violations(res: float, checks: dict) -> list:
    """The invariants a soak year breaks (empty: clean)."""
    bad = {k: int(np.sum(~np.isfinite(v)))
           for k, v in checks.items() if np.sum(~np.isfinite(v))}
    viol = []
    if res >= 0.1:
        viol.append(f"residual {res:.3g}")
    if bad:
        viol.append(f"non-finite {bad}")
    if np.nanmax(checks["swe"]) > 1000.0 + 1.0:
        viol.append(f"swe {np.nanmax(checks['swe']):.1f} > cap")
    if np.nanmin(checks["zwt"]) < -1e-6 \
            or np.nanmax(checks["zwt"]) > 80.0 + 1e-6:
        viol.append("zwt out of [0, 80]")
    if np.nanmin(checks["c_slow"]) < -1e-6:
        viol.append("negative slow carbon")
    return viol


def soak(cfg: Config, device) -> bool:
    """Run ``cfg``'s years on ``device``, printing one line a year;
    True iff every year is clean."""
    dtype = getattr(torch, cfg.dtype)
    grid, params = load_soil(cfg, dtype, device)
    provider = DeviceSyntheticForcingProvider(
        grid.n_padded, seed=0, lat=grid.cell_lat, dtype=dtype,
        device=device)
    sim = Simulation(cfg, params, land_grid=grid)
    nl = grid.n_land
    ok = True
    t0 = time.perf_counter()
    for year in range(cfg.start_year, cfg.end_year + 1):
        means = sim.run_year(year, provider)
        res = float(np.max(np.asarray(means["max_abs_residual"])[:nl]))
        checks = land_fields(sim.state, nl)
        viol = year_violations(res, checks)
        status = "CLEAN" if not viol else "VIOLATION: " + "; ".join(viol)
        print(f"year {year}: max|res|={res:.3g} mm  "
              f"swe_max={np.nanmax(checks['swe']):.0f}  "
              f"zwt_mean={np.nanmean(checks['zwt']):.2f}  "
              f"c_slow_mean={np.nanmean(checks['c_slow']):.0f}  "
              f"{status}", flush=True)
        ok &= not viol
    years = cfg.end_year - cfg.start_year + 1
    dtw = time.perf_counter() - t0
    print(f"{years} flagship years in {dtw:.0f}s "
          f"({'ALL CLEAN' if ok else 'VIOLATIONS FOUND'}; {grid.n_land} "
          f"land cells, {sim.n} padded, kernel={sim.use_kernel}, "
          f"device {sim.device})")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--years", type=int, default=20)
    ap.add_argument("--resolution", type=float, default=0.5)
    ap.add_argument("--snow-scheme", default="degree-day",
                    choices=("degree-day", "twolayer"))
    ap.add_argument("--routing-scheme", default="kinematic",
                    choices=("linear", "kinematic", "muskingum"),
                    help="default follows Config (kinematic)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    cfg = soak_config(args.years, args.resolution, args.snow_scheme,
                      args.routing_scheme)
    return 0 if soak(cfg, resolve_device(args.device)) else 1


if __name__ == "__main__":
    sys.exit(main())
